"""Fused lowering rules: the kernel-backed alternates of ``OpSpec`` cells.

Each :class:`FusedRule` pairs a rule callable (same ``fn(ctx, axis)``
signature as the torch rules in :mod:`repro_torch.core.oplib`) with a
``covers`` predicate; ``oplib._select`` picks the fused rule for a
``(stage, family)`` cell when the fused rules are selected
(``kernels.ops.override_mode`` is not ``"off"``) *and* the predicate accepts
the context — otherwise the cell's torch rule runs.

Coverage matrix (2-D nd schemes — 1-D partitioning has no spatial
stencils; of rank 3, the Lorenzo derivative alone, and other ranks fall
back):

=============  ==========================  ==========================
op             lorenzo (HSZP_ND)           blockmean (HSZX_ND)
=============  ==========================  ==========================
derivative     ② ③ ④  (and rank 3)         ② ③ ④
gradient       ② ③ ④                       ② ③ ④
laplacian      ②                           ② ③ ④
=============  ==========================  ==========================

The lorenzo ③④ laplacian stays uncovered, as in the reference.  The
reference's fused rules decline rank 3; here a full-field rank-3
:class:`Encoded` Lorenzo context with 0 < bits < 32 and no seed takes the
rank-3 payload kernels (``kernels.fused.lorenzo_enc3d``) for its
derivatives at ② ③ ④ — the same exact integer ``q[i+1] - q[i-1] =
D[i+1] + D[i]`` scaled once, as at rank 2 — and rank-3 gradients,
divergences and curls reach them through ``oplib._derivative_at``.  Rank-3
regions, seeds, ``Compressed`` containers and block-mean fields keep their
torch rules; an axis whose interior is wider than the kernels take runs the
torch rule's ops (``lorenzo_enc3d_plain``) under the same ``hsz.op.torch``
span.

The 2-D Lorenzo rules (unseeded) take the f32 answer from the stencil
pass's epilogue — ``f32(plane) * eps`` as the torch rules round it, ``2 eps``
for the laplacian — and return its window interior as a view of the
kernel's padded-shape plane.  The other kernels emit exact-integer stencil
planes (or, for the block-mean laplacians, the pre-eps f32 accumulation in
a fixed order), and the rules here apply the float tail — the same
``float()`` / eps multiply the torch rules end with — on the sliced window
interior.  Either way each covered cell equals its torch rule bit for bit,
full-field and region-windowed.  A 2-D divergence or curl whose terms all
take the Lorenzo rule on planes of one shape and window accumulates them in
one f32 plane (:func:`signed_sum`, the epilogue's ``add`` / ``sub``
modes, in torch's order).  Every float-tail operation is counted in
``kernels.ops.TAILS``, under ``"kernel"`` where an epilogue does it.  Full-field
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

On a ``batch_stack`` view (the engine's batches: full field or region,
seeded or not) the same rules run once for the batch: the payload, the
residual planes (a region's gathered sub-planes, a stage-② seed's stacked
subs) or a stage-③ seed's stacked integers carry the leading axis into one
launch of each kernel pass, coverage is judged on the unbatched layout, the
window slices the trailing two dims and each field's own eps scales its
planes.
"""
from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass

import torch

from .. import trace
from ..kernels import fused as fk
from ..kernels import ops as kernel_ops
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


def _covers_3d(ctx) -> bool:
    """A full-field rank-3 nd context the rank-3 payload kernels can serve
    (:func:`_payload2`); an axis wider than they take is judged in the
    rule (:func:`_deriv_lorenzo`)."""
    return (ctx.scheme.is_nd and len(ctx.field.padded_shape) == 3
            and _payload2(ctx))


def _covers_lorenzo_deriv(ctx) -> bool:
    """The Lorenzo derivative: rank 2 as :func:`_covers_2d`, or rank 3 as
    :func:`_covers_3d`."""
    return _covers_2d(ctx) or _covers_3d(ctx)


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


def _interior(ctx, out: torch.Tensor) -> torch.Tensor:
    """:func:`_window2` of a kernel output's trailing two dims (a batch's
    leading dim kept whole)."""
    return out[(Ellipsis,) + _window2(ctx)]


# -- lorenzo family ---------------------------------------------------------

def _lz(ctx, what: str, eps: torch.Tensor, mode: str = "write",
        out: torch.Tensor | None = None):
    """The stencil pass's f32 answer over the context's full plane (the
    payload, or the residual plane of ``ctx.sub``), in ``mode``."""
    if _payload2(ctx):
        f = ctx.field
        return fk.lorenzo_enc2d(f.payload, tuple(f.padded_shape), f.bits,
                                what=what, eps=eps, mode=mode, out=out)
    return fk.lorenzo2d(ctx.sub.residuals, what=what, eps=eps, mode=mode,
                        out=out)


def _plane(ctx) -> tuple:
    """The shape of the full plane :func:`_lz` writes for ``ctx``."""
    if _payload2(ctx):
        return tuple(ctx.field.payload.shape[:-1]) + tuple(
            ctx.field.padded_shape)
    return tuple(ctx.sub.residuals.shape)


def _accumulates(ctxs) -> bool:
    """Can the Lorenzo derivatives of ``ctxs`` sum in one f32 plane?
    Rank-2 contexts that no stage-③ seed serves, whose planes and windows
    are one shape."""
    if not all(_covers_2d(c) and not _q_seeded(c) for c in ctxs):
        return False
    windows = {tuple((w.start, w.stop) for w in _window2(c)) for c in ctxs}
    return len({_plane(c) for c in ctxs}) == 1 and len(windows) == 1


def signed_sum(terms, rules) -> torch.Tensor | None:
    """``t0 ± t1 ± ...`` of the derivatives of ``terms`` (``(sign, ctx,
    axis)``, the first sign ``+``; ``rules`` the derivative rule each term's
    context selected) in one f32 plane, or None where no kernel epilogue can
    sum them: the caller then runs each rule and sums in torch.  Where every
    term takes the 2-D Lorenzo rule on planes of one shape and window, the
    stencil pass writes the first term and adds or subtracts each next one
    in its epilogue, in torch's order: bitwise the torch sum."""
    if not (all(r is _LORENZO_DERIV for r in rules)
            and _accumulates([ctx for _, ctx, _ in terms])):
        return None
    out = None
    for sign, ctx, axis in terms:
        mode = "write" if out is None else ("add" if sign > 0 else "sub")
        out = _lz(ctx, f"deriv{axis}", ctx.eps, mode, out)
    kernel_ops.tail("kernel", 2 * len(terms) - 1)
    return _interior(terms[0][1], out)


# -- stage-③ seeds: kernels on the resident integers -------------------------

def _grad_seeded(ctx) -> tuple[torch.Tensor, ...]:
    """Both central differences of the seed's (cropped or windowed)
    integers: the interior the torch rules' ``_central_diff`` reads (of
    every field of a batch, in one launch)."""
    d0, d1 = sk.grad2d_int(ctx.q_spatial.contiguous())
    kernel_ops.tail("torch", 2)
    return (d0.to(torch.float32) * ctx.spatial_eps,
            d1.to(torch.float32) * ctx.spatial_eps)


def _lap_seeded(ctx) -> torch.Tensor:
    """The f32 5-point laplacian of the seed's integers in the torch rule's
    order (``-4c``, then the neighbours): ``lap_q`` of ``q + 0``, each
    plane one block whose mean is 0."""
    q = ctx.q_spatial.contiguous()
    zero = torch.zeros(q.shape[:-2] + (1, 1), dtype=torch.int32,
                       device=q.device)
    acc = fk.blockmean2d(q, zero, tuple(q.shape[-2:]), what="lap_q")
    kernel_ops.tail("torch")
    return acc[..., 1:-1, 1:-1] * (2.0 * ctx.spatial_eps)


def _deriv_lorenzo(ctx, axis: int) -> torch.Tensor:
    f = ctx.field
    if len(f.padded_shape) == 3:
        args = (f.payload, tuple(f.padded_shape), tuple(f.shape), f.bits,
                axis, ctx.eps)
        if fk.lorenzo3d_fits(tuple(f.shape), axis):
            kernel_ops.tail("kernel")
            return fk.lorenzo_enc3d(*args)
        # wider than the kernels take along this axis: the torch rule's ops
        kernel_ops.tail("torch")
        with trace.span("hsz.op.torch"):
            return fk.lorenzo_enc3d_plain(*args)
    if _q_seeded(ctx):
        return _grad_seeded(ctx)[axis]
    kernel_ops.tail("kernel")
    return _interior(ctx, _lz(ctx, f"deriv{axis}", ctx.eps))


def _grad_lorenzo(ctx, axis: int) -> tuple[torch.Tensor, ...]:
    if _q_seeded(ctx):
        return _grad_seeded(ctx)
    kernel_ops.tail("kernel", 2)
    return tuple(_interior(ctx, d) for d in _lz(ctx, "grad", ctx.eps))


def _lap_lorenzo(ctx, axis: int) -> torch.Tensor:
    kernel_ops.tail("kernel")
    return _interior(ctx, _lz(ctx, "lap", 2.0 * ctx.eps))


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
    kernel_ops.tail("torch")
    return _interior(ctx, out).to(torch.float32) * ctx.spatial_eps


def _grad_blockmean(ctx, axis: int) -> tuple[torch.Tensor, ...]:
    if _q_seeded(ctx):
        return _grad_seeded(ctx)
    d0, d1 = _bm(ctx, "grad")
    kernel_ops.tail("torch", 2)
    return (_interior(ctx, d0).to(torch.float32) * ctx.spatial_eps,
            _interior(ctx, d1).to(torch.float32) * ctx.spatial_eps)


def _lap_blockmean_p(ctx, axis: int) -> torch.Tensor:
    kernel_ops.tail("torch")
    return _interior(ctx, _bm(ctx, "lap_p")) * (2.0 * ctx.spatial_eps)


def _lap_blockmean_q(ctx, axis: int) -> torch.Tensor:
    if _q_seeded(ctx):
        return _lap_seeded(ctx)
    kernel_ops.tail("torch")
    return _interior(ctx, _bm(ctx, "lap_q")) * (2.0 * ctx.spatial_eps)


# -- registries wired onto the OpSpecs (oplib imports these) ----------------

def _rule(fn) -> FusedRule:
    return FusedRule(fn, _covers_2d)


#: the Lorenzo derivative of every stage: rank 2, and rank 3 (payload kernels)
_LORENZO_DERIV = FusedRule(_deriv_lorenzo, _covers_lorenzo_deriv)


#: derivative cells — also dispatched by ``oplib._derivative_at``, which
#: hands the kernels to gradient/divergence/curl compositions.
DERIVATIVE: dict[tuple[Stage, str], FusedRule] = {
    (Stage.P, "lorenzo"): _LORENZO_DERIV,
    (Stage.Q, "lorenzo"): _LORENZO_DERIV,
    (Stage.F, "lorenzo"): _LORENZO_DERIV,
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
