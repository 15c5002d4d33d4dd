"""Launches of the port's own CUDA kernels (its launch counters) over the
requests answered in the window."""


def read(run):
    if not run.answered:
        return None
    return sum(run.counters["launches"].values()) / run.answered
