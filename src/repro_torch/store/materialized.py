"""Materialized stage reconstructions: intermediate representations as values.

The operator-lowering core (``repro_torch.core.oplib``) shares one stage
reconstruction across an op *set*; a :class:`MaterializedStage` keeps that
reconstruction as a value — the intermediate representation of one
``(field, stage, region, closure)`` cell, held as tensors on the field's
device — so later queries can be seeded from it (``compute(..., seed=)``)
instead of decoding again.

What each stage keeps resident is exactly the *last integer-exact*
intermediate its postludes consume:

* stage ② — the decoded sub-field (``sub``): residuals + restricted
  metadata, i.e. the honest :class:`~repro_torch.core.stages.Compressed`
  that ``StageContext.sub`` would have decoded;
* stage ③ *and* stage ④ — ``q_spatial``: recorrelated quantization
  integers, cropped or windowed to the queried extent.  Stage ④ is the
  stage-③ intermediate plus a dequantize multiply, which stays in the op
  postlude: one materialization serves both stages.

Stage ① has nothing to materialize — its metadata is already resident in
the compressed container — so :func:`materialize` rejects it.  Integer
intermediates are exact however they are computed, so a seeded query and a
cold one share their whole floating-point tail and agree bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core import oplib
from ..core import region as region_mod
from ..core.region import Closure
from ..core.stages import Compressed, Encoded, Stage, layout_key

Field = Compressed | Encoded


def serves(seed_stage: Stage, ctx_stage: Stage) -> bool:
    """Can a materialization at ``seed_stage`` seed a ``ctx_stage`` prelude?
    Exact stage match, plus the one derived case: the stage-③ integers serve
    stage ④ (dequantize is an op-postlude multiply, not a reconstruction)."""
    seed_stage, ctx_stage = Stage(seed_stage), Stage(ctx_stage)
    return seed_stage == ctx_stage or (seed_stage == Stage.Q
                                       and ctx_stage == Stage.F)


def storage_stage(stage: Stage) -> Stage:
    """The stage a materialization is stored at: ④ canonicalizes to ③ (one
    resident integer intermediate serves both)."""
    stage = Stage(stage)
    return Stage.Q if stage == Stage.F else stage


@dataclass(frozen=True)
class MaterializedStage:
    """One resident intermediate representation.

    Exactly one of ``sub`` / ``q_spatial`` is populated (stage ② / ③); the
    other is ``None``.  The meta triple is the key a seed must match: the
    (storage) stage, the *canonical* region closure
    (:func:`repro_torch.core.region.canonical_closure`), and the normalized
    region (``None`` for full-field).
    """

    sub: Compressed | None            # stage ②: decoded sub-field
    q_spatial: torch.Tensor | None    # stage ③ (and ④): recorrelated integers

    stage: Stage
    closure: Closure
    region: tuple[tuple[int, int], ...] | None

    @property
    def nbytes(self) -> int:
        """Device bytes this materialization keeps resident."""
        if self.sub is not None:
            return self.sub.device_bytes()
        q = self.q_spatial
        return int(q.numel() * q.element_size())

    def serves(self, ctx_stage: Stage) -> bool:
        """Can this materialization seed a ``ctx_stage`` prelude?  The one
        authoritative copy of the stage-serving rule (``oplib.StageContext``
        calls it, so the core never depends on the store)."""
        return serves(self.stage, ctx_stage)

    def sig(self) -> tuple:
        """Hashable static signature: the key plus the layout of what the
        seed holds."""
        q = self.q_spatial
        return (self.stage, self.closure, self.region,
                layout_key(self.sub) if self.sub is not None else None,
                (tuple(q.shape), str(q.dtype).removeprefix("torch."))
                if q is not None else None)


def materialized_nbytes(field: Field, stage: Stage, *, region=None,
                        closure: Closure = "cover") -> int:
    """Exact device bytes :func:`materialize` would keep resident, from
    static geometry alone (no device work)."""
    stage = storage_stage(stage)
    if stage == Stage.M:
        raise ValueError("stage-1 metadata is never materialized")
    int32 = 4
    if region is not None:
        plan = region_mod.plan_region(field, region, closure)
        if stage == Stage.P:
            meta = (plan.n_sub_blocks if field.scheme.is_blockmean
                    else int(field.metadata.numel()))
            return int32 * (plan.gathered_elems + meta
                            + 2 * plan.n_sub_blocks) + 4  # + f32 eps
        return int32 * plan.n_window
    if stage == Stage.P:
        n = 1
        for s in field.padded_shape:
            n *= s
        meta = int(field.metadata.numel())
        return int32 * (n + meta + 2 * field.n_blocks) + 4
    return int32 * field.n


def materialize(field: Field, stage: Stage, *,
                region=None, closure: Closure = "cover") -> MaterializedStage:
    """Build the intermediate representation of one seed cell on the
    field's device.

    Runs the exact shared prelude the op lowerings use
    (:class:`repro_torch.core.oplib.StageContext`), forces the stage's
    resident intermediate, and wraps it.  Stage ④ requests return the
    stage-③ container (see :func:`storage_stage`).  ``closure`` matters only
    with ``region`` (it decides the gathered block set); full-field
    materializations share the canonical ``"cover"`` key.
    """
    stage = storage_stage(stage)
    if stage == Stage.M:
        raise ValueError(
            "stage-1 metadata is already resident in the compressed "
            "container; there is nothing to materialize")
    norm = (region_mod.normalize_region(region, field.shape)
            if region is not None else None)
    closure = region_mod.canonical_closure(field.scheme, closure, norm)
    ctx = oplib.StageContext(field, stage, region, closure)
    sub = q = None
    if stage == Stage.P:
        sub = ctx.sub
    else:
        # a window of the sub-field's integers: keep only the window
        q = ctx.q_spatial.contiguous()
    return MaterializedStage(sub=sub, q_spatial=q,
                             stage=stage, closure=closure, region=norm)
