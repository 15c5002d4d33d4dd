"""Fused lowering rules: the kernel-backed alternates of ``OpSpec`` cells.

Each :class:`FusedRule` pairs a rule callable (same ``fn(ctx, axis)``
signature as the torch rules in :mod:`repro_torch.core.oplib`) with a
``covers`` predicate; ``oplib._select`` picks the fused rule for a
``(stage, family)`` cell when the fused rules are selected
(``kernels.ops.override_mode`` is not ``"off"``) *and* the predicate accepts
the context — otherwise the cell's torch rule runs.

Coverage matrix (2-D nd schemes only — 1-D partitioning has no spatial
stencils, and rank != 2 fields fall back):

=============  ==========================  ==========================
op             lorenzo (HSZP_ND)           blockmean (HSZX_ND)
=============  ==========================  ==========================
derivative     ② ③ ④                       ② ③ ④
gradient       ② ③ ④                       ② ③ ④
laplacian      ②                           ② ③ ④
=============  ==========================  ==========================

The lorenzo ③④ laplacian stays uncovered, as in the reference.

The kernels emit exact-integer stencil planes (or, for the block-mean
laplacians, the pre-eps f32 accumulation in a fixed order); the rules here
apply the float tail — the same ``float()`` / eps multiply the torch rules
end with — on the sliced window interior, so each covered cell equals its
torch rule bit for bit, full-field and region-windowed.  Full-field
:class:`Encoded` contexts with 0 < bits < 32 and no seed take the
payload-input kernels (the residual plane never exists in device memory);
``Compressed`` containers, region plans and stage-② seeds take the
residual-plane kernels on ``ctx.sub``.  A stage-③ seed (serving ③ and ④)
holds the integers and no residuals, so its covered cells read those
instead of decoding the field again (the reference's rules decode):
derivatives and gradients take the stage-③ difference kernel
(``kernels.stencil_dq.grad2d_int``), the block-mean laplacian the
block-mean kernel's f32 ``lap_q`` over the integers as one block of mean 0.
(``laplacian2d`` would round the exact integer stencil once where the rule
rounds each f32 add: they differ once the partial sums pass 2^24.)
"""
from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass

import torch

from ..kernels import fused as fk
from ..kernels import stencil_dq as sk
from .stages import Encoded, Stage


@dataclass(frozen=True)
class FusedRule:
    """A kernel-backed lowering rule with a coverage predicate."""

    fn: Callable          # (ctx, axis) -> result, same signature as torch rules
    covers: Callable      # (ctx) -> bool: can this rule serve the context?

    def __call__(self, ctx, axis: int):
        return self.fn(ctx, axis)


def _covers_2d(ctx) -> bool:
    """Rank-2 nd fields only, judged on the container layout (coverage never
    forces a decode)."""
    return ctx.scheme.is_nd and len(ctx.field.padded_shape) == 2


def _q_seeded(ctx) -> bool:
    """Is the context seeded with the stage-③ integers alone?"""
    return ctx._seed is not None and ctx._seed.sub is None


def _payload2(ctx) -> bool:
    """Can this context take the single-pass payload kernels?  Full-field
    :class:`Encoded` queries with 0 < bits < 32 (bits == 0 is the all-zero
    fast path, bits == 32 stores raw words) and no materialized seed.
    Region plans keep the gather-then-unpack path (the plan's word gather
    already reads only the closure's payload) and run the residual-plane
    kernels on the gathered sub-field."""
    return (isinstance(ctx.field, Encoded) and ctx.plan is None
            and ctx._seed is None and 0 < ctx.field.bits < 32)


def _window2(ctx) -> tuple[slice, slice]:
    """The stencil-interior slices into the kernels' full padded-shape
    outputs: the region window in sub-field coordinates (or the padding
    crop) shrunk by one at each end, so slicing after the kernel reads
    exactly the elements the torch rules' window-then-stencil path reads."""
    if ctx.plan is not None:
        w0, w1 = ctx.plan.window
    else:
        w0, w1 = (slice(0, s) for s in ctx.field.shape)
    return slice(w0.start + 1, w0.stop - 1), slice(w1.start + 1, w1.stop - 1)


# -- lorenzo family ---------------------------------------------------------

def _lz(ctx, what: str):
    if _payload2(ctx):
        f = ctx.field
        return fk.lorenzo_enc2d(f.payload, tuple(f.padded_shape), f.bits,
                                what=what)
    return fk.lorenzo2d(ctx.sub.residuals, what=what)


# -- stage-③ seeds: kernels on the resident integers -------------------------

def _grad_seeded(ctx) -> tuple[torch.Tensor, ...]:
    """Both central differences of the seed's (cropped or windowed)
    integers: the interior the torch rules' ``_central_diff`` reads."""
    d0, d1 = sk.grad2d_int(ctx.q_spatial.contiguous())
    return d0.to(torch.float32) * ctx.eps, d1.to(torch.float32) * ctx.eps


def _lap_seeded(ctx) -> torch.Tensor:
    """The f32 5-point laplacian of the seed's integers in the torch rule's
    order (``-4c``, then the neighbours): ``lap_q`` of ``q + 0``, the plane
    one block whose mean is 0."""
    q = ctx.q_spatial.contiguous()
    zero = torch.zeros((1, 1), dtype=torch.int32, device=q.device)
    acc = fk.blockmean2d(q, zero, tuple(q.shape), what="lap_q")
    return acc[1:-1, 1:-1] * (2.0 * ctx.eps)


def _deriv_lorenzo(ctx, axis: int) -> torch.Tensor:
    if _q_seeded(ctx):
        return _grad_seeded(ctx)[axis]
    out = _lz(ctx, f"deriv{axis}")
    return out[_window2(ctx)].to(torch.float32) * ctx.eps


def _grad_lorenzo(ctx, axis: int) -> tuple[torch.Tensor, ...]:
    if _q_seeded(ctx):
        return _grad_seeded(ctx)
    d0, d1 = _lz(ctx, "grad")
    w = _window2(ctx)
    return (d0[w].to(torch.float32) * ctx.eps,
            d1[w].to(torch.float32) * ctx.eps)


def _lap_lorenzo(ctx, axis: int) -> torch.Tensor:
    out = _lz(ctx, "lap")
    return out[_window2(ctx)].to(torch.float32) * (2.0 * ctx.eps)


# -- blockmean family -------------------------------------------------------

def _bm(ctx, what: str):
    if _payload2(ctx):
        f = ctx.field
        return fk.blockmean_enc2d(f.payload, f.metadata,
                                  tuple(f.padded_shape), tuple(f.block),
                                  f.bits, what=what)
    sub = ctx.sub
    return fk.blockmean2d(sub.residuals, sub.metadata, tuple(sub.block),
                          what=what)


def _deriv_blockmean(ctx, axis: int) -> torch.Tensor:
    if _q_seeded(ctx):
        return _grad_seeded(ctx)[axis]
    out = _bm(ctx, f"deriv{axis}")
    return out[_window2(ctx)].to(torch.float32) * ctx.eps


def _grad_blockmean(ctx, axis: int) -> tuple[torch.Tensor, ...]:
    if _q_seeded(ctx):
        return _grad_seeded(ctx)
    d0, d1 = _bm(ctx, "grad")
    w = _window2(ctx)
    return (d0[w].to(torch.float32) * ctx.eps,
            d1[w].to(torch.float32) * ctx.eps)


def _lap_blockmean_p(ctx, axis: int) -> torch.Tensor:
    return _bm(ctx, "lap_p")[_window2(ctx)] * (2.0 * ctx.eps)


def _lap_blockmean_q(ctx, axis: int) -> torch.Tensor:
    if _q_seeded(ctx):
        return _lap_seeded(ctx)
    return _bm(ctx, "lap_q")[_window2(ctx)] * (2.0 * ctx.eps)


# -- registries wired onto the OpSpecs (oplib imports these) ----------------

def _rule(fn) -> FusedRule:
    return FusedRule(fn, _covers_2d)


#: derivative cells — also dispatched by ``oplib._derivative_at``, which
#: hands the kernels to gradient/divergence/curl compositions.
DERIVATIVE: dict[tuple[Stage, str], FusedRule] = {
    (Stage.P, "lorenzo"): _rule(_deriv_lorenzo),
    (Stage.Q, "lorenzo"): _rule(_deriv_lorenzo),
    (Stage.F, "lorenzo"): _rule(_deriv_lorenzo),
    (Stage.P, "blockmean"): _rule(_deriv_blockmean),
    (Stage.Q, "blockmean"): _rule(_deriv_blockmean),
    (Stage.F, "blockmean"): _rule(_deriv_blockmean),
}

#: gradient: one dual-output kernel pass instead of two.
GRADIENT: dict[tuple[Stage, str], FusedRule] = {
    (Stage.P, "lorenzo"): _rule(_grad_lorenzo),
    (Stage.Q, "lorenzo"): _rule(_grad_lorenzo),
    (Stage.F, "lorenzo"): _rule(_grad_lorenzo),
    (Stage.P, "blockmean"): _rule(_grad_blockmean),
    (Stage.Q, "blockmean"): _rule(_grad_blockmean),
    (Stage.F, "blockmean"): _rule(_grad_blockmean),
}

#: laplacian: lorenzo ③④ deliberately absent (see module docstring).
LAPLACIAN: dict[tuple[Stage, str], FusedRule] = {
    (Stage.P, "lorenzo"): _rule(_lap_lorenzo),
    (Stage.P, "blockmean"): _rule(_lap_blockmean_p),
    (Stage.Q, "blockmean"): _rule(_lap_blockmean_q),
    (Stage.F, "blockmean"): _rule(_lap_blockmean_q),
}
