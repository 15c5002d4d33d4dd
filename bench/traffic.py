"""Requests, and the traffic generator a mix names.

A mix (``mixes/<name>.json``) is data.  Its ``generator`` key names a
module ``generators/<generator>.py`` whose ``Traffic(config, mix, seed)``
reads the mix's other parameters and deals the requests; a later mix that
needs another arrival process or another kind of request brings a
generator file of its own and edits none.  A generator's ``Traffic`` has:

* ``due(now, answered)``: the requests to enqueue at ``now`` (host clock),
  given how many of its requests the last step answered; the harness calls
  it before the first step with ``answered=0`` and after every step of the
  window;
* ``kinds()``: every request kind it deals (``Request.kind``), which the
  warm-up serves before the window.

A request is timed from its ``arrival`` (the host clock when it was due;
``None``: when it was enqueued) to the end of the step that answered it.
"""
from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path

from reference import hsz

BENCH = Path(__file__).resolve().parent


@dataclasses.dataclass(frozen=True)
class Request:
    """One analytics request as a generator deals it.

    The harness, the output check and the roofline reach a request only
    through these attributes and methods, so a generator may deal a
    subclass that serves and checks another kind of request."""

    op: str
    fields: tuple[int, ...]   # field indices: one, or one per component
    axis: int = 0
    window: tuple | None = None
    arrival: float | None = dataclasses.field(default=None, compare=False)

    @property
    def kind(self) -> str:
        """The request's kind: op, axis and window, as the sample strata."""
        name = self.op + (f"{self.axis}" if self.op == "derivative" else "")
        if self.window is None:
            return name
        return name + "@" + "x".join(f"{a}-{b}" for a, b in self.window)

    @property
    def category(self) -> str:
        """Which compared number its answers count towards."""
        return hsz.category(self.op)

    def to_port(self, uid: int, system):
        """The port's request for this one (``system.System``)."""
        ids = tuple(system.field_id(i) for i in self.fields)
        return system.serve.AnalyticsRequest(
            uid=uid, fields=ids if len(ids) > 1 else ids[0], op=self.op,
            stage="auto", axis=self.axis, region=self.window)

    def feasible(self, config: dict) -> tuple[int, ...]:
        """The stages that can answer it (paper Table I)."""
        return hsz.feasible_stages(self.op, config["scheme"], self.window,
                                   tuple(config["block"]),
                                   tuple(config["dims"]))

    def reference(self, fields: list, stage: int, config: dict, dtype):
        """The plain reference's answer on ``fields`` (``(q, eps)`` each)."""
        return hsz.answer(self.op, fields, stage=stage, window=self.window,
                          axis=self.axis, block=tuple(config["block"]),
                          dtype=dtype)

    def least_bytes(self, config: dict, bits: list[int]) -> int:
        """Its least bytes (``roofline.py``); ``bits`` holds each field's
        packed width."""
        import roofline
        return roofline.least_bytes(config["scheme"], self.op,
                                    tuple(config["dims"]),
                                    bits=tuple(bits[i] for i in self.fields),
                                    block=tuple(config["block"]),
                                    window=self.window, axis=self.axis)


def field_count(config: dict) -> int:
    """The fields a configuration's store holds, timestep-major: ``u0, v0,
    u1, v1, ...``."""
    return int(config.get("timesteps", 1)) * len(config["components"])


def make(config: dict, mix: dict, seed, bench: Path | None = None):
    """The ``Traffic`` of the generator the mix names, for one seed (any
    hashable: the warm-up passes its own)."""
    name = mix["generator"]
    path = Path(bench or BENCH) / "generators" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_generator_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.Traffic(config, mix, seed)
