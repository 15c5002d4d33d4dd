"""Requests answered over the whole window, per second of the window."""


def read(run):
    return run.answered / run.window_s if run.window_s > 0 else None
