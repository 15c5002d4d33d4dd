"""Torch lowering rules that ran where the op's fused rule declined the
context (the port's ``hsz.op.torch`` spans: a rank-3 field's derivatives,
for one) per traced step (``bench.step`` spans), both counted where they
start inside the traced window.  Nothing where the port names no such span
(``repro_torch.trace.SPANS``): there a count of 0 would be no reading."""
from repro_torch import trace
from program_spans import STEP
from tracing import WINDOW

SPAN = "hsz.op.torch"


def _spans(events, name):
    """``(start, end)`` of the host events named ``name``; the on-device
    copies only where no host copy exists (the CPU stand-in)."""
    host = [(s, e) for n, dev, s, e in events if not dev and n == name]
    return host or [(s, e) for n, dev, s, e in events if dev and n == name]


def read(run):
    windows = _spans(run.events, WINDOW)
    if SPAN not in trace.SPANS or not windows:
        return None
    w0, w1 = windows[0]
    count = lambda name: sum(w0 <= s < w1 for s, _ in _spans(run.events, name))
    steps = count(STEP)
    return count(SPAN) / steps if steps else None
