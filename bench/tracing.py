"""Spans of the benchmark's own host code, and the reading of a device trace.

In a traced run each of the driver loop's phases runs under a
``torch.profiler.record_function`` span (``bench.step``: the frontend's
``step`` call, in which the port groups and dispatches; ``bench.sync``:
waiting for the device to finish the step; ``bench.enqueue``: the clients'
next requests; ``bench.record``: the benchmark's own bookkeeping), and a
stretch of steps runs under ``torch.profiler``.  From the profile this
module reads the device's busy time (the union of every device activity
inside the traced window), the device operations by time, and the idle gaps
by the host span that was open while the device had nothing to do.
"""
from __future__ import annotations

import contextlib
import re

import torch

SPANS = ("bench.step", "bench.sync", "bench.enqueue", "bench.record")
WINDOW = "bench.window"
TOP = 10


def span(name: str, on: bool):
    """A host span in a traced run, nothing otherwise."""
    if on:
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def profiler():
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def warm() -> None:
    """Start and stop the profiler once: its first start takes seconds,
    which a traced window must not pay."""
    prof = profiler()
    prof.start()
    torch.zeros(1).add_(1)
    prof.stop()


def _union(intervals):
    """Merge intervals into disjoint sorted ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _short(name: str) -> str:
    return re.sub(r"^void |\(anonymous namespace\)::|\(.*$", "", name)[:120]


def read(prof, device_type=None) -> dict | None:
    """Busy and window seconds, device operations, idle gaps and the events
    (``(name, on_device, start_us, end_us)``, host spans and operations
    too) of a profile whose window ran under a ``bench.window`` span;
    ``None`` if it holds no device activity in that window.  ``device_type`` is the
    profiler's device type taken for the device (CUDA by default)."""
    if device_type is None:
        device_type = torch.autograd.DeviceType.CUDA
    events = list(prof.events())
    cpu = torch.autograd.DeviceType.CPU
    windows = [e for e in events if e.name == WINDOW and e.device_type == cpu]
    if not windows:
        return None
    w0, w1 = windows[0].time_range.start, windows[0].time_range.end
    device = [e for e in events if e.device_type == device_type
              and e.name not in SPANS and e.name != WINDOW
              and e.time_range.end > w0 and e.time_range.start < w1]
    if not device:
        return None
    busy = _union((max(e.time_range.start, w0), min(e.time_range.end, w1))
                  for e in device)
    busy_us = sum(e - s for s, e in busy)
    by_op: dict[str, float] = {}
    for e in device:
        k = _short(e.name)
        by_op[k] = by_op.get(k, 0.0) + (e.time_range.end - e.time_range.start)
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in events if e.name in SPANS and e.device_type == cpu)
    gaps: dict[str, float] = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e <= s:
            continue
        mid = (s + e) / 2
        name = next((n for a, b, n in spans if a <= mid <= b), "outside spans")
        gaps[name] = gaps.get(name, 0.0) + (e - s)
    top = lambda d: [[k, v * 1e-6] for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    kept = [(e.name, e.device_type == device_type, e.time_range.start,
             e.time_range.end) for e in events
            if e.time_range.end > w0 and e.time_range.start < w1
            and e.device_type in (cpu, device_type)]
    return {"busy_s": busy_us * 1e-6, "window_s": (w1 - w0) * 1e-6,
            "device_ops": top(by_op), "idle_gaps": top(gaps), "events": kept}
