"""The device's idle time in the traced window while the innermost of the
port's open spans was the engine: its checks and program key, building a
program, stacking the batch (``hsz.engine.*``), in ms per traced step
(``program_spans.py``)."""
import program_spans


def read(run):
    return program_spans.idle_ms_per_step(run, "engine")
