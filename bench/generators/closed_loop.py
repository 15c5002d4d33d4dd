"""A closed loop of clients over a deck of request kinds.

The mix's parameters:

* ``clients``: requests outstanding at once; each answered request is
  replaced by its client's next one at once, until the window closes;
* ``deck``: the request kinds and how many of each in one round, e.g.
  ``{"op": "derivative", "axis": 0, "count": 1}``; every round deals the
  whole deck in an order drawn from the seed, so every seed sends the same
  kinds in the same proportions, in another order.

Fields are taken in turn: a single-field request the next of the
configuration's fields, a vector request (``divergence``, ``curl``) the
components of the next timestep together.
"""
from __future__ import annotations

import random

from traffic import Request, field_count

VECTOR_OPS = ("divergence", "curl")


def _deck(mix: dict) -> list[tuple]:
    out = []
    for entry in mix["deck"]:
        out += [(entry["op"], int(entry.get("axis", 0)))] * int(entry["count"])
    return out


class Traffic:
    """The requests of one closed-loop mix over one configuration."""

    def __init__(self, config: dict, mix: dict, seed):
        self.clients = int(mix["clients"])
        self.deck = _deck(mix)
        self.components = len(config["components"])
        self.total = field_count(config)
        self.rng = random.Random(f"traffic/{seed}")
        self._round: list[tuple] = []
        self._single = self._vector = 0
        self._started = False

    def _kind(self) -> tuple:
        if not self._round:
            self._round = self.rng.sample(self.deck, len(self.deck))
        return self._round.pop()

    def next(self) -> Request:
        op, axis = self._kind()
        n = self.components
        if op in VECTOR_OPS:
            t = self._vector
            self._vector = (t + 1) % (self.total // n)
            fields = tuple(t * n + c for c in range(n))
        else:
            fields = (self._single,)
            self._single = (self._single + 1) % self.total
        return Request(op=op, fields=fields, axis=axis)

    def due(self, now: float, answered: int) -> list[Request]:
        if not self._started:
            self._started = True
            answered = self.clients
        return [self.next() for _ in range(answered)]

    def kinds(self) -> set[str]:
        return {Request(op, (0,), axis).kind for op, axis in self.deck}
