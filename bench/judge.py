"""The output check: answers of the timed window against the plain reference.

As the window answers its requests, a sample of the answers is kept,
drawn from the seed, across the whole window and across the positions of
each step's batch: of every step, every answer that is a number (a
statistic) and one answer of each other kind, at a position drawn from the
seed, enter a reservoir per request kind.  Once the window has closed and
the system is freed, the reference makes each sampled request's fields
again from the seed, works out their quantization integers and the answer
at the stage the system reported, and the widest gap between the two, in
units of the fields' ``eps``, is one of the numbers compared.  The numbers,
each against the cell's limit (``limits/<workload>.json``):

* ``rejected``: requests the system refused (limit 0);
* ``unanswered``: requests it never answered, a minute past the close
  included (limit 0);
* ``bad_stage``: sampled answers at a stage that cannot give them (paper
  Table I; limit 0);
* ``stat_gap``, ``stencil_gap``: the widest gap of a sampled statistic and
  of a sampled stencil or vector answer, in ``eps``.

``control=True`` puts the reference, computed in bfloat16, in the system's
place: its answers must fail the limits.
"""
from __future__ import annotations

import math
import random

import torch

import synth
from reference import hsz

#: sampled statistics (one number each) kept per request kind
SCALARS_PER_KIND = 4096
#: device bytes of sampled array answers kept per request kind
ARRAY_BYTES_PER_KIND = 3 << 29
#: an answer whose storage is at most this many bytes is kept as it is;
#: a larger one (a view of its step's batch) is copied
SMALL_BYTES = 1 << 16
EXACT = ("rejected", "unanswered", "bad_stage")
BIG = 1.7976931348623157e308


def _nbytes(value) -> int:
    parts = value if isinstance(value, tuple) else (value,)
    return sum(t.untyped_storage().nbytes() for t in parts)


def _keep(value):
    if _nbytes(value) <= SMALL_BYTES:
        return value
    return (tuple(t.clone() for t in value) if isinstance(value, tuple)
            else value.clone())


class Sample:
    """Reservoirs of answered requests per kind, drawn from the seed."""

    def __init__(self, seed, scalars: int = SCALARS_PER_KIND,
                 array_bytes: int = ARRAY_BYTES_PER_KIND):
        self.rng = random.Random(f"sample/{seed}")
        self.scalars, self.array_bytes = scalars, array_bytes
        self.kept: dict[str, list] = {}
        self.cap: dict[str, int] = {}
        self.seen: dict[str, int] = {}

    def offer_step(self, answered: list) -> None:
        """Offer one step's answers, ``(request, value, stage)`` in the
        order the step returned them."""
        by_kind: dict[str, list] = {}
        for item in answered:
            by_kind.setdefault(item[0].kind, []).append(item)
        for kind, items in by_kind.items():
            value = items[0][1]
            if isinstance(value, torch.Tensor) and value.dim() == 0:
                self.cap.setdefault(kind, self.scalars)
                candidates = items
            else:
                size = sum(t.numel() * t.element_size() for t in
                           (value if isinstance(value, tuple) else (value,)))
                self.cap.setdefault(kind, max(1, self.array_bytes // max(size, 1)))
                candidates = [items[self.rng.randrange(len(items))]]
            for item in candidates:
                self._offer(kind, item)

    def _offer(self, kind: str, item) -> None:
        n = self.seen.get(kind, 0) + 1
        self.seen[kind] = n
        kept = self.kept.setdefault(kind, [])
        if len(kept) < self.cap[kind]:
            kept.append(None)
            slot = len(kept) - 1
        else:
            slot = self.rng.randrange(n)
            if slot >= self.cap[kind]:
                return
        req, value, stage = item
        kept[slot] = (req, _keep(value), stage)

    def items(self) -> list:
        return [x for k in sorted(self.kept) for x in self.kept[k]]


class Fields:
    """The reference's view of a run's fields: ``(q, eps)`` per index,
    made again from the seed."""

    def __init__(self, config: dict, seed: int, device, dtype):
        self.config, self.seed, self.device, self.dtype = (
            config, seed, device, dtype)
        self._cache: dict[int, tuple] = {}

    def __call__(self, index: int):
        if index not in self._cache:
            x = synth.make_field(self.seed, index, tuple(self.config["dims"]),
                                 self.device)
            self._cache[index] = hsz.quantize(x, self.config["rel_eb"],
                                              self.dtype)
        return self._cache[index]


def _stack_gap(values: list, ref, scale: float) -> float:
    """The widest gap of many statistics against one reference value."""
    got = torch.stack([v.to(torch.float64) for v in values])
    d = (got - ref.to(torch.float64)).abs().max().item()
    return math.inf if math.isnan(d) else d / scale


def compare(config: dict, seed: int, device, sampled, control: bool = False):
    """``(stat_gap, stencil_gap, bad_stage)`` of the sampled answers; a gap
    is ``None`` where no answer of its kind was sampled.

    Answers to the same request at the same stage share one reference
    answer; ``control`` puts the bfloat16 reference's answer in place of
    each sampled one."""
    want = Fields(config, seed, device, torch.float32)
    low = Fields(config, seed, device, torch.bfloat16) if control else None
    groups: dict[tuple, list] = {}
    bad = 0
    for req, value, stage in sampled:
        if stage not in req.feasible(config):
            bad += 1
            continue
        groups.setdefault((req, stage), []).append(value)
    gaps: dict[str, float] = {}
    for (req, stage), values in groups.items():
        fields = [want(i) for i in req.fields]
        ref = req.reference(fields, stage, config, torch.float64)
        scale = max(float(eps) for _, eps in fields)
        if control:
            values = [req.reference([low(i) for i in req.fields], stage,
                                    config, torch.bfloat16)]
        if all(isinstance(v, torch.Tensor) and v.dim() == 0 for v in values):
            g = _stack_gap(values, ref, scale)
        else:
            g = max(hsz.gap(v, ref, scale) for v in values)
        cat = req.category
        gaps[cat] = max(gaps.get(cat, 0.0), g)
    return gaps.get("stat"), gaps.get("stencil"), bad


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, checks)``: each number compared beside its limit."""
    checks, correct = {}, True
    for name, value in numbers.items():
        if value is None:
            continue
        limit = limits[name]
        ok = value <= limit
        correct = correct and ok
        checks[name] = {"value": BIG if math.isinf(value) else value,
                        "limit": limit}
    return correct, checks
