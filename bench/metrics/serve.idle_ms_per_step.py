"""The device's idle time in the traced window while the innermost of the
port's open spans was the frontend's own code: the step, grouping the
requests, each group's query and handing back its answers (``hsz.serve.*``,
``hsz.query``), in ms per traced step (``program_spans.py``)."""
import program_spans


def read(run):
    return program_spans.idle_ms_per_step(run, "serve")
