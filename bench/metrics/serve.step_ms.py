"""The mean of the benchmark's span around each serving step (the
frontend's ``step`` and the wait for the device), by the host clock, over
the window's steps outside the profiled stretch."""


def read(run):
    spans = run.step_spans_s
    return sum(spans) * 1e3 / len(spans) if spans else None
