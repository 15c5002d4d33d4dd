"""A closed loop of clients over a deck of request kinds, on a configuration
whose store holds more fields than its vector.

The mix's parameters are ``closed_loop.py``'s (``clients``, ``deck``), and
so are the loop and the order of kinds: this module loads that generator
and changes only which fields a request names.  A vector request
(``divergence``, ``curl``) takes the configuration's ``vector`` fields, one
per spatial axis (velocityx, velocityy, velocityz on a rank-3 field); a
single-field request takes every field of the store in turn.

It deals :class:`Request` (a ``traffic.Request``) whose answers on a
rank-3 field are checked against ``reference/hsz3d.py`` for the 3-D curl
(``reference/hsz.py`` for every other op) and whose least bytes are
``roofline3d.py``'s box count.
"""
from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path

import traffic
from reference import hsz, hsz3d

_spec = importlib.util.spec_from_file_location(
    "bench_generator_closed_loop", Path(__file__).with_name("closed_loop.py"))
closed_loop = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(closed_loop)


@dataclasses.dataclass(frozen=True)
class Request(traffic.Request):
    """A request on fields of any rank."""

    def reference(self, fields: list, stage: int, config: dict, dtype):
        if self.op == "curl" and len(fields) == 3:
            return hsz3d.curl(fields, dtype)
        return hsz.answer(self.op, fields, stage=stage, window=self.window,
                          axis=self.axis, block=tuple(config["block"]),
                          dtype=dtype)

    def least_bytes(self, config: dict, bits: list[int]) -> int:
        import roofline3d
        return roofline3d.least_bytes(config["scheme"], self.op,
                                      tuple(config["dims"]),
                                      bits=tuple(bits[i] for i in self.fields),
                                      window=self.window, axis=self.axis)


def vector_fields(config: dict) -> tuple[int, ...]:
    """Store indices of the first timestep's vector components, one per
    spatial axis."""
    names = config["vector"][:len(config["dims"])]
    return tuple(config["components"].index(n) for n in names)


class Traffic(closed_loop.Traffic):
    """The requests of one closed-loop mix over one configuration."""

    def __init__(self, config: dict, mix: dict, seed):
        super().__init__(config, mix, seed)
        self.vector = vector_fields(config)

    def next(self) -> Request:
        op, axis = self._kind()
        if op in closed_loop.VECTOR_OPS:
            fields = self.vector
        else:
            fields = (self._single,)
            self._single = (self._single + 1) % self.total
        return Request(op=op, fields=fields, axis=axis)
