"""One run of one cell: set-up, the measured window, the trace, the check.

One driver loop calls the frontend's ``step`` and waits for the device to
finish the step (an answer is ready only then); before the first step and
after each one it enqueues what the mix's generator says is due
(``traffic.py``: a closed loop replaces each answered request at once).  A
request is timed from its arrival to the end of the step that answered it.
Nothing compiles inside the window: set-up builds the kernels, fills the
store and serves warm-up steps of the same mix until every request kind
has been answered twice.
"""
from __future__ import annotations

import dataclasses
import gc
import os
import resource
import time

import torch

import judge
import tracing
from spec import Spec
from system import System, answer_of

WARM_STEPS = 3
WARM_PER_KIND = 2
WARM_MAX_STEPS = 200
#: steps inside a traced window, after one that starts the profiler
TRACE_STEPS = 8
#: traced stretches taken before a run goes without its trace
TRACE_TRIES = 3
#: how long past the close the loop waits for an unanswered request
DRAIN_S = 60.0


@dataclasses.dataclass
class Run:
    """What a run measured, for the metric readers (``metrics/*.py``)."""

    setup_s: float
    window_s: float
    steps: int
    answered: int
    latencies_s: list
    step_spans_s: list      # step and wait of each untraced step in the window
    counters: dict          # every counter of the port, differenced over the window
    trace: dict | None      # tracing.read of the traced window
    traced_bytes: int       # least bytes of the requests the trace answered

    @property
    def events(self) -> list:
        """The traced window's profile: ``(name, on_device, start_us,
        end_us)`` of every host span, operation and device activity."""
        return self.trace["events"] if self.trace is not None else []


def _delta(a, b):
    """``b - a`` for every counter of ``b``, nested dicts key by key (a key
    ``a`` lacks counts from 0)."""
    if isinstance(b, dict):
        return {k: _delta(a.get(k, 0) if isinstance(a, dict) else 0, v)
                for k, v in b.items()}
    return b - a


def _host() -> dict:
    """The host's state as this process sees it, for reading a run's noise:
    its CPU time, its voluntary and involuntary switches (``getrusage``),
    the machine's stolen time where ``/proc/stat`` gives it."""
    use = resource.getrusage(resource.RUSAGE_SELF)
    out = {"cpu_s": use.ru_utime + use.ru_stime,
           "voluntary_switches": use.ru_nvcsw,
           "involuntary_switches": use.ru_nivcsw}
    try:
        with open("/proc/stat") as f:
            cpu = f.readline().split()
        out["steal_s"] = int(cpu[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        pass
    return out


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _warm(spec: Spec, system: System, config: dict, mix: dict, seed,
          device) -> None:
    """Serve the mix (from its own seed) until every request kind has been
    answered ``WARM_PER_KIND`` times over at least ``WARM_STEPS`` steps,
    then drain."""
    traffic = spec.traffic(config, mix, f"warm/{seed}")
    kinds = traffic.kinds()
    seen: dict[str, int] = {}
    pending: dict[int, object] = {}
    uid = -1

    def submit(requests) -> None:
        nonlocal uid
        for r in requests:
            pending[uid] = r
            system.submit(uid, r)
            uid -= 1

    submit(traffic.due(time.perf_counter(), 0))
    for step in range(WARM_MAX_STEPS):
        if not pending:
            break
        done = system.step()
        _sync(device)
        for d in done:
            r = pending.pop(d.uid)
            seen[r.kind] = seen.get(r.kind, 0) + 1
        if step + 1 < WARM_STEPS or any(seen.get(k, 0) < WARM_PER_KIND
                                        for k in kinds):
            submit(traffic.due(time.perf_counter(), len(done)))


def run_cell(spec: Spec, workload: str, seed: int, seconds: float,
             trace: bool, device, t_start: float, *, config: dict | None = None,
             mix: dict | None = None, limits: dict | None = None,
             control: bool = False, drain_s: float = DRAIN_S) -> dict:
    """One run of cell ``workload``: the result line's object.

    ``config``, ``mix`` and ``limits`` default to the files the cell names.
    With ``control`` the result also holds ``control``: the compared
    numbers of the bfloat16 reference put in the system's place, on the
    same sampled requests."""
    cell = spec.workload(workload)
    config = config or spec.config(cell["config"])
    mix = mix or spec.mix(cell["traffic"])
    limits = limits or spec.limits(workload)
    t_cell = time.perf_counter()
    system = System(config, seed, device)
    _sync(device)
    t_fields = time.perf_counter()
    _warm(spec, system, config, mix, seed, device)
    if trace:
        tracing.warm()
    _sync(device)
    t_warm = time.perf_counter()
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    traffic = spec.traffic(config, mix, seed)
    sample = judge.Sample(seed)
    bits = system.bits

    gc.collect()
    gc.freeze()     # set-up's objects stay out of the window's collections
    before = system.counters()
    host_before, gc_before = _host(), gc.get_stats()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    t_end = t0 + seconds
    pending: dict[int, tuple] = {}   # uid -> (request, arrival)
    uid = 0

    def submit(requests) -> None:
        nonlocal uid
        for r in requests:
            t = time.perf_counter() if r.arrival is None else r.arrival
            system.submit(uid, r)
            pending[uid] = (r, t)
            uid += 1

    submit(traffic.due(t0, 0))
    latencies, rejected, steps = [], 0, 0
    phases = {"step": 0.0, "sync": 0.0}
    plain_steps = []    # the window's steps outside the traced stretch
    tr = _Tracer(trace, t0 + seconds / 3,
                 None if torch.device(device).type == "cuda"
                 else torch.autograd.DeviceType.CPU)
    now = t_last = t0
    while (pending or now < t_end) and now < t_end + drain_s:
        in_window = now < t_end
        if not pending:
            # an open loop with nothing due yet
            time.sleep(0.0002)
            now = time.perf_counter()
            submit(traffic.due(now, 0))
            continue
        tr.before_step(now)
        t_a = time.perf_counter()
        with tracing.span("bench.step", tr.on):
            done = system.step()
        t_b = time.perf_counter()
        with tracing.span("bench.sync", tr.on):
            _sync(device)
        now = time.perf_counter()
        if in_window:
            steps += 1
            t_last = now
            phases["step"] += t_b - t_a
            phases["sync"] += now - t_b
            if not tr.on:
                plain_steps.append(now - t_a)
        with tracing.span("bench.record", tr.on):
            answered = []
            for d in done:
                r, t_arr = pending.pop(d.uid)
                if d.error is not None:
                    rejected += 1
                    continue
                latencies.append(now - t_arr)
                answered.append((r, *answer_of(d)))
                if tr.counting:
                    tr.bytes += r.least_bytes(config, bits)
            sample.offer_step(answered)
        if now < t_end:
            with tracing.span("bench.enqueue", tr.on):
                submit(traffic.due(now, len(done)))
        tr.after_step()
        if not done and now >= t_end:
            time.sleep(0.01)
    tr.close()
    host = _delta(host_before, _host())
    host["gc_collections"] = sum(b["collections"] - a["collections"] for a, b
                                 in zip(gc_before, gc.get_stats()))
    window_s = t_last - t0
    after = system.counters()
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)
    unanswered = len(pending)
    del system, pending
    gc.unfreeze()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    stat_gap, stencil_gap, bad = judge.compare(config, seed, device,
                                               sample.items())
    numbers = {"rejected": rejected, "unanswered": unanswered,
               "bad_stage": bad, "stat_gap": stat_gap,
               "stencil_gap": stencil_gap}
    correct, checks = judge.verdict(numbers, limits)
    if control:
        stat_gap, stencil_gap, bad = judge.compare(
            config, seed, device, sample.items(), control=True)
        control_numbers = dict(numbers, bad_stage=bad, stat_gap=stat_gap,
                               stencil_gap=stencil_gap)
    trace_read = tr.result
    run = Run(setup_s=setup_s, window_s=window_s, steps=steps,
              answered=len(latencies), latencies_s=latencies,
              step_spans_s=plain_steps,
              counters=_delta(before, after), trace=trace_read,
              traced_bytes=tr.bytes)
    metrics = {}
    for m in spec.metrics(workload, trace):
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = _device(device, peak)
    out = {"correct": correct, "attempted": uid,
           "failed": rejected + unanswered, "metrics": metrics, "device": dev}
    if trace_read is not None:
        dev["busy_s"] = trace_read["busy_s"]
        dev["window_s"] = trace_read["window_s"]
        out["breakdown"] = {"device_ops": trace_read["device_ops"],
                            "idle_gaps": trace_read["idle_gaps"]}
    # diagnostics beside the result: where set-up and the window's host time went
    out["info"] = {"packed_bits": bits, "steps": steps,
                   "sampled": len(sample.items()),
                   "setup_phases_s": {"start": t_cell - t_start,
                                      "fields": t_fields - t_cell,
                                      "warm": t_warm - t_fields},
                   "host_step_s": phases["step"], "sync_s": phases["sync"],
                   "trace_tries": tr.tries, "host": host}
    if control:
        out["control"] = judge.verdict(control_numbers, limits)[1]
    out["checks"] = checks
    return out


class _Tracer:
    """The traced stretch of a window: from the first step that starts past
    ``start``, the profiler runs over one lead step (a profile can drop its
    first device events) and then ``TRACE_STEPS`` steps under the
    ``bench.window`` span.  A profile that holds no device activity in its
    stretch is taken again from the next step, up to ``TRACE_TRIES`` times
    in all."""

    def __init__(self, wanted: bool, start: float, device_type):
        self.wanted, self.start, self.device_type = wanted, start, device_type
        self.prof = self.span = None
        self.left = None     # steps still to trace; None when not tracing
        self.bytes = 0
        self.tries = 0
        self.result = None   # tracing.read of the stretch that held activity

    @property
    def on(self) -> bool:
        return self.prof is not None

    @property
    def counting(self) -> bool:
        return self.span is not None and self.left > 0

    def before_step(self, now: float) -> None:
        if self.prof is None:
            if (self.wanted and self.result is None and now >= self.start
                    and self.tries < TRACE_TRIES):
                self.tries += 1
                self.bytes = 0
                self.prof = tracing.profiler()
                self.prof.start()
                self.left = 0          # the lead step
        elif self.span is None:
            self.span = torch.profiler.record_function(tracing.WINDOW)
            self.span.__enter__()
            self.left = TRACE_STEPS

    def after_step(self) -> None:
        if self.span is not None:
            self.left -= 1
            if self.left == 0:
                self.close()

    def close(self) -> None:
        """End the stretch, if one is open, and read it."""
        if self.prof is None:
            return
        if self.span is not None:
            self.span.__exit__(None, None, None)
        self.prof.stop()
        if self.span is not None:
            self.result = tracing.read(self.prof, self.device_type)
        self.prof = self.span = self.left = None


def _device(device, peak: int) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": peak}
