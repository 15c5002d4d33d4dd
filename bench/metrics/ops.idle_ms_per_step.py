"""The device's idle time in the traced window while the innermost of the
port's open spans was the op rules: postludes and kernel launches
(``hsz.op``, ``hsz.kernel.launch``), in ms per traced step
(``program_spans.py``)."""
import program_spans


def read(run):
    return program_spans.idle_ms_per_step(run, "ops")
