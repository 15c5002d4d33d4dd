"""The device's idle time by the port's own spans, for the metric readers.

The port records a span at each layer boundary of its serving path while
a profiler runs (``repro_torch.trace``: ``hsz.serve.step`` down to
``hsz.kernel.launch``), on the profiler's clock.  From a traced run's
events (``Run.events``) this module takes the window (the ``bench.window``
span), the device's activity in it (every device event but the
benchmark's and the port's own span names), the idle stretches between,
and the port's spans; each idle instant goes to the innermost port span
open at it, split exactly at span edges, and the spans' layers sum it up.
Idle under no port span is the benchmark loop's (``LOOP``).

On the CPU stand-in every profiled event is a "device" event; the port's
spans are then told from the activity by their names alone.
"""
from __future__ import annotations

import bisect

from tracing import WINDOW, _union

STEP = "bench.step"
QUERY = "hsz.query"
PORT = "hsz."
#: the layer of each port span, by name prefix (the first that matches)
LAYERS = (("hsz.serve.", "serve"), ("hsz.query", "serve"),
          ("hsz.plan", "planner"), ("hsz.store", "planner"),
          ("hsz.engine.", "engine"),
          ("hsz.prelude", "prelude"), ("hsz.decode", "prelude"),
          ("hsz.op", "ops"), ("hsz.kernel.", "ops"))
LOOP = "loop"


def layer_of(name: str) -> str | None:
    """The layer of a port span; ``None`` for a name no layer claims (a
    span added to the port later), whose idle stays with its parent."""
    for prefix, layer in LAYERS:
        if name.startswith(prefix):
            return layer
    return None


def _host(events, name_ok):
    """``(start, end, name)`` of the host events whose name passes; the
    on-device copies only where no host copy exists (the CPU stand-in)."""
    host = [(s, e, n) for n, dev, s, e in events if not dev and name_ok(n)]
    if host:
        return host
    return [(s, e, n) for n, dev, s, e in events if dev and name_ok(n)]


class _Idle:
    """The idle stretches of a window, and how much of any interval they
    cover."""

    def __init__(self, w0: float, w1: float, busy):
        edges = [w0] + [x for iv in busy for x in iv] + [w1]
        self.gaps = [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]
        self.starts = [s for s, _ in self.gaps]
        self.before = [0.0]
        for s, e in self.gaps:
            self.before.append(self.before[-1] + e - s)

    @property
    def total(self) -> float:
        return self.before[-1]

    def upto(self, t: float) -> float:
        """Idle time before ``t``."""
        i = bisect.bisect_right(self.starts, t)
        if i == 0:
            return 0.0
        s, e = self.gaps[i - 1]
        return self.before[i - 1] + min(t, e) - s

    def within(self, s: float, e: float) -> float:
        return self.upto(e) - self.upto(s) if e > s else 0.0


def split(events) -> dict | None:
    """Idle microseconds of the traced window by layer (``serve``,
    ``planner``, ``engine``, ``prelude``, ``ops`` and ``LOOP``), with
    ``idle`` (their sum), ``steps`` (``bench.step`` spans that start in the
    window) and ``groups`` (``hsz.query`` spans in it).  ``None`` where the
    events hold no window, no step or no port span."""
    windows = _host(events, lambda n: n == WINDOW)
    if not windows:
        return None
    w0, w1 = windows[0][0], windows[0][1]
    steps = sum(w0 <= s < w1 for s, _, _ in
                _host(events, lambda n: n == STEP))
    # outer before inner where two spans start together
    spans = sorted(((max(s, w0), min(e, w1), n) for s, e, n in
                    _host(events, lambda n: layer_of(n) is not None)
                    if e > w0 and s < w1), key=lambda x: (x[0], -x[1]))
    if not steps or not spans:
        return None
    busy = _union((max(s, w0), min(e, w1)) for n, dev, s, e in events
                  if dev and e > w0 and s < w1
                  and not n.startswith(("bench.", PORT)))
    idle = _Idle(w0, w1, busy)
    out = {layer: 0.0 for _, layer in LAYERS}
    out[LOOP] = idle.total
    # spans nest on the serving thread: a span's own idle is its idle less
    # its children's; a child that overran its parent is cut at the edge
    stack: list[list] = []   # [start, end, name], outermost first
    for s, e, n in spans:
        while stack and stack[-1][1] <= s:
            stack.pop()
        if stack:
            e = min(e, stack[-1][1])
        own = idle.within(s, e)
        out[layer_of(n)] += own
        out[layer_of(stack[-1][2]) if stack else LOOP] -= own
        stack.append([s, e, n])
    out["idle"] = idle.total
    out["steps"] = steps
    out["groups"] = sum(n == QUERY for _, _, n in spans)
    return out


def idle_ms_per_step(run, layer: str) -> float | None:
    """Device idle under ``layer``'s spans, in ms per traced step."""
    got = split(run.events)
    return None if got is None else got[layer] * 1e-3 / got["steps"]
