"""The port's query spans (``hsz.query``, one a group of requests that
share an op set, stage, axis, region and field layout) per traced step:
the engine calls a step issues (``program_spans.py``)."""
import program_spans


def read(run):
    got = program_spans.split(run.events)
    return None if got is None else got["groups"] / got["steps"]
