"""Operator-lowering core: one stage reconstruction, many homomorphic results.

* :class:`OpSpec` — a declarative description of one analytical operation:
  name, arity (single field vs vector of components), per-scheme feasible
  stages (paper Table I), the region dependency closure, and one lowering
  rule per ``(stage, scheme family)`` cell, with optional kernel-backed
  :class:`FusedRule` alternates.
* :class:`StageContext` — the *prelude* of a lowering for a ``(field,
  stage, region, closure)``: payload decode (only the closure's words for a
  region), cumsum / block-mean-upsample recorrelation, window cropping and
  statistic weights, each computed lazily and **at most once**, so an op set
  reuses a single stage reconstruction; a materialized seed or pre-gathered
  payload words can stand in for the decode.  The field may be a
  ``batch_stack`` view — full field or a region, seeded by a stacked seed
  (``repro_torch.store.materialized.stack_seeds``) or not: every
  intermediate then carries the leading batch axis, the spatial dims are
  read from the end, a region plan (static, shared by the fields) gathers
  every field's closure at once, and each kernel launches once for the
  batch — the counterpart of the reference's ``jax.vmap`` over
  ``compute``.  Pre-gathered payload words take one field at a time.
* :func:`compute` — validates the op set, joins the per-op region closures
  into one gathered sub-field, builds the context(s) and runs every op's
  postlude, returning ``{op: result}``.

* :class:`TemporalSummary` — the integer-exact per-slab summary of a time
  slab (``repro_torch.stream``): the temporal ops ``tdelta`` / ``tmean`` /
  ``tmin`` / ``tmax`` / ``tstd`` are postludes on merged summaries
  (:data:`TEMPORAL_OPS`).

This module ports ``repro/core/oplib.py``; the float tails keep the
reference's order of operations, which is what the bit-identity of the
stencil and temporal results rests on.  The full-field path is the region
path with ``region=None``.  :func:`compute_exprs` lowers expression DAGs
(:mod:`repro_torch.core.expr`) onto one prelude per leaf.
"""
from __future__ import annotations

from collections.abc import Callable, Mapping, Sequence
from dataclasses import dataclass, field as dc_field, fields as dc_fields
from functools import cached_property, reduce

import numpy as np
import torch

from .. import trace
from ..kernels import ops as kernel_ops
from ..kernels import prefix_stats as kernel_stats
from . import blocking, quantize
from . import encode as encode_mod
from . import fused as fused_mod
from . import region as R
from .pipeline import HSZCompressor, UnsupportedStageError, by_name
from .stages import Compressed, Encoded, Scheme, Stage, batch_size, is_batch

Field = Compressed | Encoded


def _isum(x: torch.Tensor, nb: int = 0) -> torch.Tensor:
    """Flat int32 sum (of each field's values past ``nb`` leading batch
    dims), wrapping modulo 2^32 like the reference's int32 sums; exact in
    int64 first, so the grouping cannot change it."""
    return x.reshape(x.shape[:nb] + (-1,)).sum(
        -1, dtype=torch.int64).to(torch.int32)


#: byte alignment of a fresh allocation that a field's own view must keep
#: for a float reduction to take the kernel path a lone field takes
#: (vectorized loads peel an unaligned head and regroup the sums)
_OWN_ALIGN = 512


def _own(x: torch.Tensor) -> torch.Tensor:
    """One field's values laid out as a lone field's would be: the view
    itself where its start is aligned like a fresh allocation, else a
    copy."""
    return x if x.data_ptr() % _OWN_ALIGN == 0 else x.clone()


# ===========================================================================
# closure lattice
# ===========================================================================

def join_closures(closures: Sequence[R.Closure]) -> R.Closure:
    """Smallest closure containing every op's dependency closure.

    ``cover`` only ever joins with itself (block-mean family); Lorenzo
    closures are bands/hulls, and any two distinct ones join to the
    origin-anchored prefix hull (band ∪ band' ⊆ hull and hull absorbs all).
    """
    uniq = set(closures)
    if not uniq:
        raise ValueError("empty closure set")
    if len(uniq) == 1:
        return next(iter(uniq))
    if "cover" in uniq:
        # mixed families can't happen (closures are per-scheme); be safe
        raise ValueError(f"cannot join closures {sorted(map(str, uniq))}")
    return "hull"


def set_closure(ops: str | Sequence[str], scheme: Scheme, stage: Stage,
                axis: int = 0) -> R.Closure:
    """Joined region dependency closure of a *field-arity* op set — the
    closure :func:`compute` reconstructs, hence the materialization key a
    seed must match to serve the set's prelude."""
    names = canonical_ops(ops)
    if is_vector_ops(names):
        raise ValueError(
            f"vector op set {names} has per-component closures; "
            "use component_closures()")
    return join_closures(
        [OPS[n].closure(Scheme(scheme), Stage(stage), axis) for n in names])


def component_closures(ops: str | Sequence[str],
                       schemes: Sequence[Scheme],
                       stage: Stage) -> tuple[R.Closure, ...]:
    """Per-component joined closures of a *vector-arity* op set: each
    component's closure joins the derivative bands of every axis any op in
    the set differentiates it along."""
    names = canonical_ops(ops)
    if not is_vector_ops(names):
        raise ValueError(f"field op set {names} has one closure; "
                         "use set_closure()")
    stage = Stage(stage)
    axes_per_comp = [set() for _ in schemes]
    for name in names:
        for i, axes in enumerate(OPS[name].component_axes(len(schemes))):
            axes_per_comp[i].update(axes)
    return tuple(
        join_closures([_deriv_closure(Scheme(s), stage, a)
                       for a in sorted(axes)])
        for s, axes in zip(schemes, axes_per_comp))


# ===========================================================================
# the shared prelude
# ===========================================================================

def _same_device(what: str, t: torch.Tensor, field: Field) -> None:
    """Seeds and word sets must lie where their field lies: nothing moves
    between devices on its own."""
    if t.device != field.eps.device:
        raise ValueError(
            f"{what} lies on {t.device}, its field on {field.eps.device}")


class StageContext:
    """One stage reconstruction for a ``(field, stage, region, closure)``.

    Every intermediate is a cached property, so any number of op postludes
    share one decode / recorrelation / window-crop pass.  Host geometry
    (plans, weights) is static; device copies of it come from the plans'
    bounded device cache.

    ``seed`` is an optional materialized intermediate (duck-typed as
    ``repro_torch.store.MaterializedStage``: ``stage`` / ``closure`` /
    ``region`` meta plus ``sub`` / ``q_spatial`` tensors).  A seed whose key
    matches this context replaces the corresponding reconstruction — the
    tensors it holds were produced by this very prelude, so every downstream
    postlude is bit-identical to the unseeded path; a mismatched key raises.
    ``words`` optionally supplies the region plan's gathered payload words.

    On a ``batch_stack`` view the seed is the fields' seeds stacked
    (``stack_seeds``); ``words`` takes one field at a time.
    """

    def __init__(self, c: Field, stage: Stage, region, closure: R.Closure,
                 seed=None, words=None):
        self.field = c
        self.stage = Stage(stage)
        self.region = region
        self.closure = closure
        self._axis_diffs: dict[int, torch.Tensor] = {}
        #: leading batch dims of ``c``: 1 for a ``batch_stack`` view, else 0
        self.nb = int(is_batch(c))
        if self.nb and words is not None:
            raise ValueError(
                "payload words take one field at a time, not a batch_stack "
                "view")
        if words is not None:
            if region is None or not isinstance(c, Encoded):
                raise ValueError(
                    "words= supplies the region plan's gathered payload "
                    "words; it requires an Encoded field and a region")
            _same_device("payload_words", words, c)
        self._words = words
        if seed is not None:
            norm = (R.normalize_region(region, c.shape)
                    if region is not None else None)
            want = R.canonical_closure(c.scheme, closure, norm)
            got = (Stage(seed.stage), seed.closure, seed.region)
            # the seed owns the stage-serving rule (stage-③ integers serve
            # stage ④: dequantize is a postlude multiply)
            if not seed.serves(self.stage) or got[1:] != (want, norm):
                raise ValueError(
                    f"materialized seed {got} does not match context "
                    f"({self.stage}, {want}, {norm})")
            _same_device("materialized seed", seed.q_spatial if seed.sub is None
                         else seed.sub.eps, c)
        self._seed = seed

    # -- static layout ------------------------------------------------------
    @property
    def scheme(self) -> Scheme:
        return self.field.scheme

    @property
    def eps(self) -> torch.Tensor:
        """The error bound: 0-d, or ``(B,)`` on a batch view (each field's
        own)."""
        return self.field.eps

    def bcast(self, t: torch.Tensor, k: int) -> torch.Tensor:
        """A per-field value (0-d, or ``(B,)`` on a batch) shaped to
        broadcast over ``k`` trailing dims of each field."""
        return t.reshape(t.shape + (1,) * k) if self.nb else t

    @cached_property
    def spatial_eps(self) -> torch.Tensor:
        """:attr:`eps` broadcasting over a spatial result (a stencil plane
        or a stage-④ field)."""
        return self.bcast(self.eps, len(self.field.shape))

    def flat(self, x: torch.Tensor) -> torch.Tensor:
        """Each field's values in one flat dim: ``(N,)`` or ``(B, N)``."""
        return x.reshape(x.shape[:self.nb] + (-1,))

    def per_field(self, fn: Callable, *xs: torch.Tensor) -> torch.Tensor:
        """``fn`` (a float reduction) of one field's values; on a batch, of
        each field's own values, stacked.  Float sums are reduced field by
        field, each over memory laid out as a lone field's, so a batch
        rounds exactly as its fields do one at a time (a reduction over a
        ``(B, N)`` tensor promises no such order)."""
        if not self.nb:
            return fn(*xs)
        return torch.stack([fn(*(_own(x[b]) for x in xs))
                            for b in range(batch_size(self.field))])

    @cached_property
    def plan(self) -> R.RegionPlan | None:
        if self.region is None:
            return None
        return R.plan_region(self.field, self.region, self.closure)

    @property
    def n(self) -> int:
        """Valid element count of the queried extent (window or field)."""
        return self.plan.n_window if self.plan is not None else self.field.n

    @cached_property
    def compressor(self) -> HSZCompressor:
        return by_name(self.scheme.value, self.field.block)

    # -- decode (once) ------------------------------------------------------
    @cached_property
    @trace.spanned("hsz.prelude")
    def sub(self) -> Compressed:
        """The honest sub-field the ops run on: the gathered region closure,
        or the (decoded) full field.  From :class:`Encoded` the region path
        unpacks only the plan's payload words.  A stage-② seed skips the
        decode entirely."""
        if self._seed is not None and self._seed.sub is not None:
            return self._seed.sub
        if self.plan is not None:
            if self._words is not None:
                # bit-identical to gathering them from the resident payload
                return encode_mod.decode_region(self.field, self.plan,
                                                words=self._words)
            return R.extract(self.field, self.plan)
        c = self.field
        return encode_mod.decode_device(c) if isinstance(c, Encoded) else c

    # -- per-block metadata views (no payload decode) -----------------------
    @cached_property
    @trace.spanned("hsz.prelude")
    def metadata_blocks(self) -> torch.Tensor:
        """Metadata restricted to the gathered blocks, without touching the
        payload — the stage-① path must never decode."""
        if self.plan is not None:
            return self.plan.gather_metadata(self.field)
        return self.field.metadata

    @cached_property
    def block_overlap(self) -> torch.Tensor:
        """Per-gathered-block element counts inside the queried extent:
        window-overlap counts (region) or the field's valid counts (full)."""
        if self.plan is not None:
            return self.plan.on_device("overlap", self.eps.device)
        return self.field.valid_counts

    # -- windowing / masking helpers ----------------------------------------
    @cached_property
    def valid_weight(self) -> torch.Tensor | None:
        """Full-field only: spatial 0/1 mask of valid elements, or None
        without padding."""
        c = self.field
        shape = c.shape if c.scheme.is_nd else (c.n,)
        if not blocking.has_padding(shape, c.block):
            return None
        return torch.as_tensor(blocking.valid_mask(shape, c.block),
                               dtype=torch.int32, device=c.eps.device)

    def masked_sum(self, arr: torch.Tensor) -> torch.Tensor:
        """Exact (int32) sum over the queried extent — the window (region)
        or the padding-masked full array — reduced flat (per field)."""
        if self.plan is not None:
            return _isum(self.plan.window_of(arr), self.nb)
        w = self.valid_weight
        return _isum(arr if w is None else arr * w, self.nb)

    def stat_values(self, arr: torch.Tensor) -> torch.Tensor:
        """Flat f32 values a statistic reduces over: the window (region) or
        the full array with padding zeroed (full field); ``(B, N)`` on a
        batch."""
        if self.plan is not None:
            return self.flat(self.plan.window_of(arr).to(torch.float32))
        x = arr.to(torch.float32)
        w = self.valid_weight
        return self.flat(x if w is None else x * w)

    def spatial_window(self, arr: torch.Tensor) -> torch.Tensor:
        """Crop a sub-field spatial array to the stencil window: the region
        window, or the original shape (padding removed) for the full field."""
        if self.plan is not None:
            return self.plan.window_of(arr)
        return blocking.crop(arr, self.sub.shape)

    # -- recorrelation intermediates (the expensive, shared part) -----------
    def lorenzo_axis_diff(self, axis: int) -> torch.Tensor:
        """D_a = q - shift_a(q) from residuals: cumsum over all axes != a."""
        d = self._axis_diffs.get(axis)
        if d is None:
            with trace.span("hsz.prelude"):
                d = self.sub.residuals
                for a in range(d.ndim - self.nb):
                    if a != axis:
                        d = torch.cumsum(d, dim=self.nb + a,
                                         dtype=torch.int32)
            self._axis_diffs[axis] = d
        return d

    @cached_property
    @trace.spanned("hsz.prelude")
    def lorenzo_q(self) -> torch.Tensor:
        """Stage-③ integers of a Lorenzo sub-field (padded layout), derived
        from the axis-0 difference so a {derivative, std} set shares passes."""
        return torch.cumsum(self.lorenzo_axis_diff(0), dim=self.nb,
                            dtype=torch.int32)

    @cached_property
    def lorenzo_moments(self) -> torch.Tensor | None:
        """``(Σq, Σq²)`` f32 of the queried extent's stage-③ integers of a
        Lorenzo sub-field, ``(2,)`` or ``(B, 2)`` on a batch, from the
        prefix-stats kernels (one launch of each for the batch, ``q`` never
        written): the exact integer sums rounded once to f32.  None where
        they do not apply — a 1-D scheme, a spatial rank other than 2, a
        region plan, residuals off the card — and the rules take their
        torch path.  A padded layout runs on the residuals' valid crop,
        exactly: ``q[i, j]`` depends only on ``p[:i+1, :j+1]``.  The span
        opens after the decode's own, beside it: a profiler folds a span
        whose one child has its name into that child."""
        c = self.field
        if not (c.scheme.is_lorenzo and c.scheme.is_nd and len(c.shape) == 2
                and self.plan is None):
            return None
        p = self.sub.residuals
        if p.dtype != torch.int32 or not kernel_ops.on_card(p):
            return None
        with trace.span("hsz.prelude"):
            n0, n1 = c.shape
            if tuple(p.shape[-2:]) != (n0, n1):
                p = p[..., :n0, :n1].contiguous()
            return kernel_stats.prefix_stats_batch(p)

    @cached_property
    @trace.spanned("hsz.prelude")
    def upsampled_means(self) -> torch.Tensor:
        """Block means upsampled to the spatial layout (block-mean family)."""
        return blocking.upsample_block_means(self.sub.metadata, self.sub.block)

    @cached_property
    @trace.spanned("hsz.prelude")
    def q_spatial(self) -> torch.Tensor:
        """Stage-③ integers cropped/windowed to the queried extent (skipped
        when a stage-③ seed holds them resident)."""
        if self._seed is not None and self._seed.q_spatial is not None:
            return self._seed.q_spatial
        q = self.compressor.decompress(self.sub, Stage.Q,
                                       crop=self.plan is None)
        if self.plan is not None:
            return self.plan.window_of(q)
        return q

    @cached_property
    @trace.spanned("hsz.prelude")
    def f_spatial(self) -> torch.Tensor:
        """Stage-④ floats on the queried extent, derived from
        :attr:`q_spatial` even when seeded (dequantize commutes with the
        crop, and seeded and cold paths share this float tail)."""
        return quantize.dequantize(self.q_spatial, self.spatial_eps,
                                   self.field.orig_dtype)

    @cached_property
    def lorenzo_mean_weights(self) -> tuple[torch.Tensor, ...]:
        """Sum weights: ``sum_{i in extent} q_i = <weights, residuals>`` —
        per-axis separable (nd) or one flat vector (1-D schemes).  Both
        come from the device cache of plan arrays, one copy per layout and
        device, so a warm query copies nothing from the host."""
        dev = self.eps.device
        if self.plan is not None:
            return self.plan.device_weights(dev)
        c = self.field
        dims = tuple(c.shape) if c.scheme.is_nd else (c.n,)
        return full_field_weights(tuple(c.padded_shape), dims, dev)


def full_field_weights(padded_shape: tuple[int, ...], dims: tuple[int, ...],
                       device) -> tuple[torch.Tensor, ...]:
    """The full field's Lorenzo sum weights, ``max(nvalid - i, 0)`` per
    axis as f32, on ``device``: built on the host once per
    ``(padded_shape, dims, device)`` and kept in ``region``'s device cache."""
    return R._device_cached(
        ("full-field weights", padded_shape, dims, str(device)),
        lambda: tuple(
            torch.as_tensor(np.clip(nvalid - np.arange(npad), 0, None)
                            .astype(np.float32), device=device)
            for npad, nvalid in zip(padded_shape, dims)))


# ===========================================================================
# stencil helpers (shared by every lowering path)
# ===========================================================================

# Every helper takes ``nb`` leading batch dims (0 or 1), kept whole; ``axis``
# counts the spatial dims after them.

def _interior_index(nd: int, nb: int) -> list:
    return [slice(None)] * nb + [slice(1, -1)] * nd


def _interior(x: torch.Tensor, nb: int = 0) -> torch.Tensor:
    """Crop one element at each end of every axis (common stencil interior)."""
    return x[tuple(_interior_index(x.ndim - nb, nb))]


def _shift_pair(x: torch.Tensor, axis: int,
                nb: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """(x_{+1}, x_{-1}) views cropped to the common interior."""
    idx_p = _interior_index(x.ndim - nb, nb)
    idx_m = _interior_index(x.ndim - nb, nb)
    idx_p[nb + axis] = slice(2, None)
    idx_m[nb + axis] = slice(None, -2)
    return x[tuple(idx_p)], x[tuple(idx_m)]


def _central_diff(x: torch.Tensor, axis: int, scale,
                  nb: int = 0) -> torch.Tensor:
    """(x_{+1} - x_{-1}) * scale on the common interior (V-B.2)."""
    hi, lo = _shift_pair(x, axis, nb)
    return (hi - lo).to(torch.float32) * scale


def _lorenzo_deriv_stencil(d: torch.Tensor, axis: int,
                           nb: int = 0) -> torch.Tensor:
    """q_{+1} - q_{-1} = D_a[i+1] + D_a[i] on the interior (V-B.1), with
    ``d`` the cropped Lorenzo axis difference."""
    sl_hi = _interior_index(d.ndim - nb, nb)
    sl_hi[nb + axis] = slice(2, None)
    sl_lo = _interior_index(d.ndim - nb, nb)
    return (d[tuple(sl_hi)] + d[tuple(sl_lo)]).to(torch.float32)


def _lorenzo_lap_term(d: torch.Tensor, axis: int, nb: int = 0) -> torch.Tensor:
    """D_a[i+1] - D_a[i] on the interior — one axis term of V-B.3."""
    sl_hi = _interior_index(d.ndim - nb, nb)
    sl_hi[nb + axis] = slice(2, None)
    sl_lo = _interior_index(d.ndim - nb, nb)
    return d[tuple(sl_hi)] - d[tuple(sl_lo)]


def _laplacian_stencil(x: torch.Tensor, nb: int = 0) -> torch.Tensor:
    """Sum of neighbors minus 2·nd·center on the common interior, f32."""
    nd = x.ndim - nb
    acc = -2.0 * nd * _interior(x, nb).to(torch.float32)
    for a in range(nd):
        hi, lo = _shift_pair(x, a, nb)
        acc = acc + hi.to(torch.float32) + lo.to(torch.float32)
    return acc


def _blockmean_deriv_p(p: torch.Tensor, m: torch.Tensor, axis: int,
                       nb: int = 0) -> torch.Tensor:
    """(p_{+1} - p_{-1}) + (m_{+1} - m_{-1}): V-B §② with the border Delta
    terms realized as a shifted upsampled-mean difference."""
    p_hi, p_lo = _shift_pair(p, axis, nb)
    m_hi, m_lo = _shift_pair(m, axis, nb)
    return ((p_hi - p_lo) + (m_hi - m_lo)).to(torch.float32)


# ===========================================================================
# lowering rules: one per (op, stage, scheme family); fn(ctx, axis)
# ===========================================================================

def _mean_m(ctx: StageContext, axis: int) -> torch.Tensor:
    # ① metadata path: mu = (1/N) sum_b M_b S_b * 2eps  (V-A.1); read from
    # the container, never from ctx.sub: stage ① must not decode.  Partial-
    # block windows would weight block means by fractional coverage, voiding
    # the eps bias bound (§V-D.1), hence the alignment requirement
    if ctx.plan is not None and not ctx.plan.aligned:
        raise UnsupportedStageError(
            "stage-1 region mean needs a block-aligned window "
            f"(region {ctx.plan.region} vs block {ctx.field.block})")
    s = _isum(ctx.flat(ctx.metadata_blocks) * ctx.block_overlap, ctx.nb)
    return s / ctx.n * ctx.eps * 2.0


def _mean_p_blockmean(ctx: StageContext, axis: int) -> torch.Tensor:
    # ② sum q over extent = sum p over extent + sum_b M_b * overlap_b (V-A §②)
    sp = ctx.masked_sum(ctx.sub.residuals)
    sm = _isum(ctx.flat(ctx.sub.metadata) * ctx.block_overlap, ctx.nb)
    return (sp + sm) / ctx.n * ctx.eps * 2.0


def _mean_p_lorenzo(ctx: StageContext, axis: int) -> torch.Tensor:
    # ② Lorenzo: sum q = weighted sum of residuals; separable weights make
    # this a rank-1 contraction (w0^T P w1 ...) for nd, one dot for flat.
    # On the card, 2-D full fields take Σq from the prefix-stats kernels
    # (:attr:`StageContext.lorenzo_moments`): the exact sum rounded once to
    # f32, where the contraction rounds along the way.  Both lie within
    # ``error_analysis.mean_bias_bound`` of the stage-④ mean, so the two
    # paths differ by at most twice that bound.
    moments = ctx.lorenzo_moments
    if moments is not None:
        return moments[..., 0] / ctx.n * ctx.eps * 2.0
    weights = ctx.lorenzo_mean_weights

    def contract(acc: torch.Tensor) -> torch.Tensor:
        if ctx.scheme.is_nd:
            for w in weights:
                acc = torch.tensordot(acc, w, dims=([0], [0]))
            return acc
        return torch.dot(acc.reshape(-1), weights[0])

    acc = ctx.per_field(contract, ctx.sub.residuals.to(torch.float32))
    return acc / ctx.n * ctx.eps * 2.0


def _mean_q(ctx: StageContext, axis: int) -> torch.Tensor:
    qf = ctx.flat(ctx.q_spatial.to(torch.float32))
    return ctx.per_field(torch.mean, qf) * ctx.eps * 2.0


def _mean_f(ctx: StageContext, axis: int) -> torch.Tensor:
    return ctx.per_field(torch.mean, ctx.flat(ctx.f_spatial.to(torch.float32)))


def _std_p_blockmean(ctx: StageContext, axis: int) -> torch.Tensor:
    # ② decompose (q - mu) = (p) + (M_b - mu~) with integer mean mu~ (V-A §②)
    n = ctx.n
    s = _isum(ctx.flat(ctx.sub.metadata) * ctx.block_overlap, ctx.nb)
    if ctx.plan is None:
        # complete blocks keep per-block residual sums near zero, so the
        # metadata term alone anchors the integer mean
        tot = s
    else:
        # a partial block contributes a one-sided slice of its residuals, so
        # the exact integer window sum must include them
        tot = s + _isum(ctx.plan.window_of(ctx.sub.residuals), ctx.nb)
    mu_int = torch.round(tot / n).to(torch.int32)
    mu_sp = ctx.bcast(mu_int, len(ctx.field.padded_shape))
    x = ctx.stat_values(ctx.sub.residuals + (ctx.upsampled_means - mu_sp))
    ss = ctx.per_field(torch.sum, x * x)
    # remove the integer mean's first-order offset r, |r| <= 1/2, exactly
    r = tot / n - mu_int
    ss = ss - 2.0 * r * ctx.per_field(torch.sum, x) + n * r * r
    return torch.sqrt(torch.clamp(ss, min=0.0) / (n - 1)) * ctx.eps * 2.0


def _std_of_sums(ctx: StageContext, s1: torch.Tensor,
                 s2: torch.Tensor) -> torch.Tensor:
    n = ctx.n
    var = (s2 - s1 * s1 / n) / (n - 1)
    return torch.sqrt(torch.clamp(var, min=0.0)) * ctx.eps * 2.0


def _std_moments(ctx: StageContext, qf: torch.Tensor) -> torch.Tensor:
    return _std_of_sums(ctx, ctx.per_field(torch.sum, qf),
                        ctx.per_field(torch.sum, qf * qf))


def _std_p_lorenzo(ctx: StageContext, axis: int) -> torch.Tensor:
    # On the card, 2-D full fields take (Σq, Σq²) from the prefix-stats
    # kernels (:attr:`StageContext.lorenzo_moments`): the exact sums rounded
    # once to f32, where the torch path rounds its f32 sums along the way.
    # The float tail is the same; both lie within
    # ``error_analysis.std_bias_bound`` of the stage-④ std, so the two paths
    # differ by at most twice that bound.
    moments = ctx.lorenzo_moments
    if moments is not None:
        return _std_of_sums(ctx, moments[..., 0], moments[..., 1])
    return _std_moments(ctx, ctx.stat_values(ctx.lorenzo_q))


def _std_q(ctx: StageContext, axis: int) -> torch.Tensor:
    return _std_moments(ctx, ctx.flat(ctx.q_spatial.to(torch.float32)))


def _std_f(ctx: StageContext, axis: int) -> torch.Tensor:
    # two-pass (mean-subtracted): ④ is the accuracy reference the lower
    # stages are judged against
    xf = ctx.flat(ctx.f_spatial.to(torch.float32))
    n = ctx.n
    d = xf - ctx.bcast(ctx.per_field(torch.sum, xf) / n, 1)
    return torch.sqrt(torch.clamp(ctx.per_field(torch.sum, d * d) / (n - 1),
                                  min=0.0))


def _deriv_p_lorenzo(ctx: StageContext, axis: int) -> torch.Tensor:
    d = ctx.spatial_window(ctx.lorenzo_axis_diff(axis))
    return _lorenzo_deriv_stencil(d, axis, ctx.nb) * ctx.spatial_eps


def _deriv_p_blockmean(ctx: StageContext, axis: int) -> torch.Tensor:
    return _blockmean_deriv_p(ctx.spatial_window(ctx.sub.residuals),
                              ctx.spatial_window(ctx.upsampled_means),
                              axis, ctx.nb) * ctx.spatial_eps


def _deriv_q(ctx: StageContext, axis: int) -> torch.Tensor:
    return _central_diff(ctx.q_spatial, axis, ctx.spatial_eps, ctx.nb)


# stage ④ stencils ARE the stage-③ rules: (f_hi - f_lo)/2 with f = 2*eps*q
# is the exact integer difference scaled once — one f32 rounding
_deriv_f = _deriv_q


def _lap_p_lorenzo(ctx: StageContext, axis: int) -> torch.Tensor:
    # sum_a (D_a[+1] - D_a[0]) — paper Eq. V-B.3 generalized to n-D
    total = None
    for a in range(ctx.sub.residuals.ndim - ctx.nb):
        d = ctx.spatial_window(ctx.lorenzo_axis_diff(a))
        term = _lorenzo_lap_term(d, a, ctx.nb)
        total = term if total is None else total + term
    return total.to(torch.float32) * (2.0 * ctx.spatial_eps)


def _lap_p_blockmean(ctx: StageContext, axis: int) -> torch.Tensor:
    m = ctx.spatial_window(ctx.upsampled_means)
    p = ctx.spatial_window(ctx.sub.residuals)
    return ((_laplacian_stencil(p, ctx.nb) + _laplacian_stencil(m, ctx.nb))
            * (2.0 * ctx.spatial_eps))


def _lap_q(ctx: StageContext, axis: int) -> torch.Tensor:
    return (_laplacian_stencil(ctx.q_spatial, ctx.nb)
            * (2.0 * ctx.spatial_eps))  # (V-B.4)


# integer-stencil form of the float laplacian (see _deriv_f note)
_lap_f = _lap_q


# ===========================================================================
# op specs
# ===========================================================================

Rule = Callable[[StageContext, int], torch.Tensor]


@dataclass(frozen=True)
class OpSpec:
    """Declarative description of one analytical operation.

    ``lower`` maps ``(stage, family)`` — family one of ``"blockmean"``,
    ``"lorenzo"``, ``"any"`` — to the postlude rule for that cell; cells
    absent from both family and ``"any"`` keys are infeasible (Table I).
    ``fused`` optionally maps the same cells to kernel-backed
    :class:`~repro_torch.core.fused.FusedRule` alternates, each of which has
    a torch rule to fall back to (enforced by :func:`spec_violations`).
    ``closure`` gives the region dependency closure of the op's prelude;
    vector ops instead declare ``component_axes`` (which derivative axes
    each component feeds), from which per-component closures derive, and
    ``lower_vector``; temporal ops declare ``lower_temporal``, a postlude
    on one merged :class:`TemporalSummary`.
    """

    name: str
    arity: str                    # "field" | "vector" | "temporal"
    category: str                 # "statistic" | "differentiation" | "multivariate" | "temporal"
    feasible: Callable[[Scheme], tuple[Stage, ...]]
    needs_axis: bool = False
    closure: Callable[[Scheme, Stage, int], R.Closure] | None = None
    component_axes: Callable[[int], tuple[tuple[int, ...], ...]] | None = None
    lower: Mapping[tuple[Stage, str], Rule] = dc_field(default_factory=dict)
    fused: Mapping[tuple[Stage, str], fused_mod.FusedRule] = dc_field(
        default_factory=dict)
    lower_vector: Callable | None = None
    lower_temporal: Callable | None = None  # (TemporalSummary, eps) -> result


def _mean_stages(scheme: Scheme) -> tuple[Stage, ...]:
    return tuple(([Stage.M] if scheme.is_blockmean else [])
                 + [Stage.P, Stage.Q, Stage.F])


def _std_stages(scheme: Scheme) -> tuple[Stage, ...]:
    return (Stage.P, Stage.Q, Stage.F)


def _stencil_stages(scheme: Scheme) -> tuple[Stage, ...]:
    return tuple(([Stage.P] if scheme.is_nd else []) + [Stage.Q, Stage.F])


def _deriv_closure(scheme: Scheme, stage: Stage, axis: int) -> R.Closure:
    return R.op_closure(scheme, "derivative", stage, axis)


def _stat_closure(scheme: Scheme, stage: Stage, axis: int) -> R.Closure:
    return R.op_closure(scheme, "mean", stage, axis)


def _gradient_closure(scheme: Scheme, stage: Stage, axis: int) -> R.Closure:
    # every axis' derivative band, joined — the prefix hull for nd Lorenzo
    return R.op_closure(scheme, "gradient", stage, axis)


_DERIV_RULES: dict[tuple[Stage, str], Rule] = {
    (Stage.P, "lorenzo"): _deriv_p_lorenzo,
    (Stage.P, "blockmean"): _deriv_p_blockmean,
    (Stage.Q, "any"): _deriv_q,
    (Stage.F, "any"): _deriv_f,
}


def kernel_sig() -> str:
    """The kernel mode the lowering rules are selected under: ``"on"``
    (fused rules where they cover) or ``"off"`` (``kernels.ops.
    override_mode("off")``).  The engine's program keys include it, as the
    reference's jit keys include its backend mode."""
    return "on" if kernel_ops.kernels_enabled() else "off"


def _declined(rule: Rule) -> Rule:
    """``rule`` run under the ``hsz.op.torch`` span: a torch rule standing
    in for a fused rule that declined the context (a rank-3 field, say)."""
    def run(ctx: StageContext, axis: int):
        with trace.span("hsz.op.torch"):
            return rule(ctx, axis)
    return run


def _select(fused: Mapping, lower: Mapping, stage: Stage, family: str,
            ctx: StageContext) -> Rule:
    """The one dispatch rule: the cell's fused rule when fused rules are
    selected and it covers this context, else the torch rule (spanned as
    ``hsz.op.torch`` where the fused rule was asked and declined)."""
    fr = fused.get((stage, family))
    asked = fr is not None and kernel_ops.kernels_enabled()
    if asked and fr.covers(ctx):
        return fr
    rule = lower.get((stage, family)) or lower.get((stage, "any"))
    if rule is None:
        raise KeyError((stage, family))
    return _declined(rule) if asked else rule


def select_rule(spec: OpSpec, stage: Stage, family: str,
                ctx: StageContext) -> Rule:
    """Resolve the lowering rule :func:`compute` runs for one op cell."""
    return _select(spec.fused, spec.lower, Stage(stage), family, ctx)


def _derivative_at(ctx: StageContext, axis: int) -> torch.Tensor:
    """Dispatch the derivative rule for ``ctx`` — the shared postlude every
    multivariate/gradient lowering is assembled from."""
    family = family_of(ctx.scheme)
    rule = _select(fused_mod.DERIVATIVE, _DERIV_RULES, ctx.stage, family, ctx)
    return rule(ctx, axis)


def _gradient_rule(ctx: StageContext, axis: int) -> tuple[torch.Tensor, ...]:
    nd = len(ctx.field.shape)
    return tuple(_derivative_at(ctx, a) for a in range(nd))


def _divergence_vector(ctxs: Sequence[StageContext], axis: int) -> torch.Tensor:
    total = None
    for a, ctx in enumerate(ctxs):
        term = _derivative_at(ctx, a)
        total = term if total is None else total + term
    return total


def _curl_vector(ctxs: Sequence[StageContext], axis: int):
    """2-D: scalar dv/dx - du/dy (paper V-C.3 with (x,y)=(axis0,axis1));
    3-D: the full vector curl."""
    if len(ctxs) == 2:
        u, v = ctxs
        return _derivative_at(v, 0) - _derivative_at(u, 1)
    if len(ctxs) != 3:
        raise ValueError(f"curl needs 2 or 3 components, got {len(ctxs)}")
    u, v, w = ctxs
    return (
        _derivative_at(w, 1) - _derivative_at(v, 2),
        _derivative_at(u, 2) - _derivative_at(w, 0),
        _derivative_at(v, 0) - _derivative_at(u, 1),
    )


def _div_axes(n_components: int) -> tuple[tuple[int, ...], ...]:
    return tuple((i,) for i in range(n_components))


def _curl_axes(n_components: int) -> tuple[tuple[int, ...], ...]:
    if n_components == 2:
        return ((1,), (0,))
    if n_components == 3:
        return ((1, 2), (0, 2), (0, 1))
    raise ValueError(f"curl needs 2 or 3 components, got {n_components}")


#: the registry: declaration order is the canonical op-set order.
OPS: dict[str, OpSpec] = {
    spec.name: spec for spec in (
        OpSpec("mean", "field", "statistic", _mean_stages,
               closure=_stat_closure,
               lower={(Stage.M, "blockmean"): _mean_m,
                      (Stage.P, "blockmean"): _mean_p_blockmean,
                      (Stage.P, "lorenzo"): _mean_p_lorenzo,
                      (Stage.Q, "any"): _mean_q,
                      (Stage.F, "any"): _mean_f}),
        OpSpec("std", "field", "statistic", _std_stages,
               closure=_stat_closure,
               lower={(Stage.P, "blockmean"): _std_p_blockmean,
                      (Stage.P, "lorenzo"): _std_p_lorenzo,
                      (Stage.Q, "any"): _std_q,
                      (Stage.F, "any"): _std_f}),
        OpSpec("derivative", "field", "differentiation", _stencil_stages,
               needs_axis=True, closure=_deriv_closure, lower=_DERIV_RULES,
               fused=fused_mod.DERIVATIVE),
        OpSpec("gradient", "field", "differentiation", _stencil_stages,
               closure=_gradient_closure,
               lower={(Stage.P, "any"): _gradient_rule,
                      (Stage.Q, "any"): _gradient_rule,
                      (Stage.F, "any"): _gradient_rule},
               fused=fused_mod.GRADIENT),
        OpSpec("laplacian", "field", "differentiation", _stencil_stages,
               closure=_stat_closure,  # hull / cover: all axes' diffs
               lower={(Stage.P, "lorenzo"): _lap_p_lorenzo,
                      (Stage.P, "blockmean"): _lap_p_blockmean,
                      (Stage.Q, "any"): _lap_q,
                      (Stage.F, "any"): _lap_f},
               fused=fused_mod.LAPLACIAN),
        OpSpec("divergence", "vector", "multivariate", _stencil_stages,
               component_axes=_div_axes, lower_vector=_divergence_vector),
        OpSpec("curl", "vector", "multivariate", _stencil_stages,
               component_axes=_curl_axes, lower_vector=_curl_vector),
    )
}

# ===========================================================================
# temporal operations (streaming time-slab analytics)
# ===========================================================================
# A *temporal field* (``repro_torch.stream.TemporalField``) is an append-only
# sequence of error-bounded-compressed time slabs, each an ordinary
# Compressed/Encoded field of shape ``(k, *spatial)`` sharing one eps (one
# quantization grid).  Temporal ops reduce over the time axis and lower as
# homomorphic *merges* of per-slab integer summaries: every leaf of a
# :class:`TemporalSummary` is integer-exact (int32, modular), so merging
# slab summaries in any association is bit-identical to one reduction over
# the fully decompressed concatenated field (DESIGN.md §9).


@dataclass(frozen=True)
class TemporalSummary:
    """Integer-exact per-slab (or merged) temporal summary.

    All leaves are ``int32`` tensors over the queried spatial extent, on the
    slabs' device; sums are modular (two's-complement wrap), which keeps
    merging associative and bit-exact in any order — results are
    numerically meaningful while the true sums fit int32 (``|q| * T < 2^31``
    for ``q_sum``, ``q^2 * T < 2^31`` for ``q_sumsq``; the stream's capacity
    guard holds appends to that).  ``last2`` holds the quantization integers
    of the final two timesteps (duplicated while only one exists), which is
    what ``tdelta`` — the latest inter-timestep change — consumes.  The
    summaries of a batch of slabs (``summarize_slab`` on a ``batch_stack``
    view) carry a leading batch axis on every leaf.
    """

    count: torch.Tensor    # int32 0-d: timesteps summarized
    q_sum: torch.Tensor    # int32 (*extent,): sum over time of q
    q_sumsq: torch.Tensor  # int32 (*extent,): sum over time of q^2 (modular)
    q_min: torch.Tensor    # int32 (*extent,)
    q_max: torch.Tensor    # int32 (*extent,)
    last2: torch.Tensor    # int32 (2, *extent): q at timesteps T-2, T-1

    def leaves(self) -> tuple[torch.Tensor, ...]:
        return tuple(getattr(self, f.name) for f in dc_fields(self))

    @property
    def nbytes(self) -> int:
        """Device bytes kept resident (store LRU accounting)."""
        return sum(x.numel() * x.element_size() for x in self.leaves())

    def sig(self) -> tuple:
        """Hashable static signature (program-cache key component)."""
        return tuple((tuple(x.shape), str(x.dtype).removeprefix("torch."))
                     for x in self.leaves())


def map_summaries(fn: Callable, *summaries: TemporalSummary) -> TemporalSummary:
    """Apply ``fn`` leaf by leaf across summaries (the reference's
    ``jax.tree.map`` over its summary pytree): ``fn(*leaves)``."""
    return TemporalSummary(*(fn(*xs) for xs in
                             zip(*(s.leaves() for s in summaries))))


def summary_from_q(q: torch.Tensor, nb: int = 0) -> TemporalSummary:
    """Summarize a time-major integer block ``q`` of shape ``(k, *extent)``
    (after ``nb`` leading batch dims: a batch of slabs' blocks, each
    summarized on its own, every leaf with the batch dims in front).

    The one reduction rule both paths share: per-slab summaries (this, per
    slab, then merged) and the full-decompression reference (this, once,
    over the concatenated field) are bit-identical because every reduction
    is int32 (modular addition / min / max — associative, order-free).
    ``q * q`` wraps modulo 2^32 as the reference's int32 product does.
    """
    k = int(q.shape[nb])
    last2 = (q.narrow(nb, k - 2, 2) if k >= 2
             else torch.cat([q.narrow(nb, k - 1, 1)] * 2, dim=nb))
    return TemporalSummary(
        count=torch.full(q.shape[:nb], k, dtype=torch.int32, device=q.device),
        q_sum=torch.sum(q, dim=nb, dtype=torch.int32),
        q_sumsq=torch.sum(q * q, dim=nb, dtype=torch.int32),
        q_min=torch.amin(q, dim=nb),
        q_max=torch.amax(q, dim=nb),
        last2=last2.contiguous(),
    )


def merge_summaries(a: TemporalSummary, b: TemporalSummary) -> TemporalSummary:
    """Homomorphic merge of two temporally *adjacent* summaries (a before b).

    Integer-exact and associative — ``merge(s_1, merge(s_2, s_3))`` equals
    one pass over the concatenation — but not commutative: ``last2`` tracks
    the stream's final frames, so order is the append order.  Nothing is read
    back to the host: ``last2`` is selected on the device.
    """
    last2 = torch.where(b.count >= 2, b.last2,
                        torch.stack([a.last2[1], b.last2[1]]))
    return TemporalSummary(
        count=a.count + b.count,
        q_sum=a.q_sum + b.q_sum,
        q_sumsq=a.q_sumsq + b.q_sumsq,
        q_min=torch.minimum(a.q_min, b.q_min),
        q_max=torch.maximum(a.q_max, b.q_max),
        last2=last2,
    )


def _slab_q_view(ctx: StageContext) -> torch.Tensor:
    """Quantization integers of one slab on the queried extent, time-major.

    Stage ③/④ read the shared ``q_spatial`` reconstruction; stage ② derives
    q from the stage-② intermediates (block-mean: residuals + upsampled
    means, elementwise; Lorenzo: the context's cumsum recorrelation — the
    same stage-② work the spatial ``std@P`` lowerings do).  All paths
    produce the *same integers*, which is why one summary serves every
    feasible stage bit-identically.
    """
    if ctx.stage != Stage.P:
        return ctx.q_spatial
    if ctx.scheme.is_blockmean:
        return ctx.spatial_window(ctx.sub.residuals + ctx.upsampled_means)
    return ctx.spatial_window(ctx.lorenzo_q)


def temporal_region(c: Field, region) -> tuple | None:
    """Lift a *spatial* region to the slab layout (time axis 0 kept whole)."""
    if region is None:
        return None
    if len(region) != len(c.shape) - 1:
        raise ValueError(
            f"temporal region is spatial-only: rank {len(c.shape) - 1} "
            f"expected, got {len(region)}")
    return ((0, c.shape[0]),) + tuple(region)


def summarize_slab(c: Field, stage: Stage, *,
                   region=None) -> TemporalSummary:
    """One slab's integer temporal summary at ``stage`` (the per-append
    reconstruction unit: appending a slab summarizes *only* that slab).

    ``region`` is spatial (the slab's time axis is always axis 0 and always
    fully covered).  Infeasible stages raise ``UnsupportedStageError`` with
    the temporal ops' own error semantics.  On a ``batch_stack`` view of
    same-layout slabs one context summarizes them all (the region lifted
    from the unbatched shape): every leaf gains the leading batch axis.
    """
    stage = Stage(stage)
    _check_feasible(TEMPORAL_OPS["tmean"], c.scheme, stage)
    slab_region = temporal_region(c, region)
    closure = R.op_closure(c.scheme, "mean", stage)
    ctx = StageContext(c, stage, slab_region, closure)
    return summary_from_q(_slab_q_view(ctx), ctx.nb)


def _temporal_cnt(s: TemporalSummary) -> torch.Tensor:
    return s.count.to(torch.float32)


def _tmean_rule(s: TemporalSummary, eps) -> torch.Tensor:
    return s.q_sum.to(torch.float32) * (2.0 * eps) / _temporal_cnt(s)


def _tstd_rule(s: TemporalSummary, eps) -> torch.Tensor:
    n = _temporal_cnt(s)
    s1 = s.q_sum.to(torch.float32)
    s2 = s.q_sumsq.to(torch.float32)
    # frame-at-a-time streams query after a single timestep: ddof=1 would be
    # 0/0 there, so clamp the denominator — zero spread, not NaN, until a
    # second timestep arrives
    var = (s2 - s1 * s1 / n) / torch.clamp(n - 1.0, min=1.0)
    return torch.sqrt(torch.clamp(var, min=0.0)) * (2.0 * eps)


def _tmin_rule(s: TemporalSummary, eps) -> torch.Tensor:
    return s.q_min.to(torch.float32) * (2.0 * eps)


def _tmax_rule(s: TemporalSummary, eps) -> torch.Tensor:
    return s.q_max.to(torch.float32) * (2.0 * eps)


def _tdelta_rule(s: TemporalSummary, eps) -> torch.Tensor:
    # latest inter-timestep change, exact integer difference scaled once
    # (same single-rounding form as the spatial stage-④ stencils)
    return (s.last2[1] - s.last2[0]).to(torch.float32) * (2.0 * eps)


def _temporal_stages(scheme: Scheme) -> tuple[Stage, ...]:
    # stage ② needs the (time, *spatial) layout; 1-D partitioning flattens
    # it away, exactly like the spatial stencils (paper §V-B)
    return tuple(([Stage.P] if scheme.is_nd else []) + [Stage.Q, Stage.F])


#: temporal op registry: reductions over the time axis of an appended
#: stream, each a postlude on one merged :class:`TemporalSummary`.
TEMPORAL_OPS: dict[str, OpSpec] = {
    spec.name: spec for spec in (
        OpSpec("tdelta", "temporal", "temporal", _temporal_stages,
               lower_temporal=_tdelta_rule),
        OpSpec("tmean", "temporal", "temporal", _temporal_stages,
               lower_temporal=_tmean_rule),
        OpSpec("tmin", "temporal", "temporal", _temporal_stages,
               lower_temporal=_tmin_rule),
        OpSpec("tmax", "temporal", "temporal", _temporal_stages,
               lower_temporal=_tmax_rule),
        OpSpec("tstd", "temporal", "temporal", _temporal_stages,
               lower_temporal=_tstd_rule),
    )
}


def temporal_postlude(ops: str | Sequence[str], summary: TemporalSummary,
                      eps) -> dict[str, torch.Tensor]:
    """Lower a temporal op set onto one merged summary: ``{op: result}``.

    The summary already paid every reconstruction; postludes are tiny
    elementwise float tails, identical at every stage the summary serves
    (②③④ — the integers are the same, ④'s dequantize is the final multiply).
    """
    names = canonical_ops(ops)
    if not is_temporal_ops(names):
        raise ValueError(f"{names} is not a temporal op set")
    return {n: TEMPORAL_OPS[n].lower_temporal(summary, eps) for n in names}


def _merge_registries(*registries: Mapping[str, OpSpec]) -> dict[str, OpSpec]:
    """Combine op registries into the single lookup, rejecting name
    collisions: a name shadowed across registries would make
    ``canonical_ops`` / planning disagree about an op's arity and
    feasibility, so the merge fails loudly instead."""
    out: dict[str, OpSpec] = {}
    for reg in registries:
        for name, spec in reg.items():
            if name in out:
                raise ValueError(
                    f"op name collision: {name!r} is registered more than "
                    "once (the spatial OPS and temporal TEMPORAL_OPS "
                    "registries — and any user-registered spec — must use "
                    "unique names)")
            out[name] = spec
    return out


#: single lookup across both registries (spatial + temporal).
_ALL_OPS: dict[str, OpSpec] = _merge_registries(OPS, TEMPORAL_OPS)

_ORDER = {name: i for i, name in enumerate(_ALL_OPS)}


def family_of(scheme: Scheme) -> str:
    """The lowering-rule family key of a scheme: ``"lorenzo"`` for the HSZp
    pair, ``"blockmean"`` for HSZx."""
    return "lorenzo" if Scheme(scheme).is_lorenzo else "blockmean"


# ===========================================================================
# registry validation and user-registered ops
# ===========================================================================

def resolve_rules(spec: OpSpec, scheme: Scheme, stage: Stage) -> tuple[Rule, ...]:
    """Every lowering rule of ``spec`` matching the ``(stage, scheme)`` cell.

    The well-formed registry has exactly one match per feasible cell —
    either the scheme-family rule or the ``"any"`` rule, never both and
    never neither (:func:`spec_violations` enforces it).
    """
    stage = Stage(stage)
    rules = []
    fam = spec.lower.get((stage, family_of(scheme)))
    if fam is not None:
        rules.append(fam)
    any_rule = spec.lower.get((stage, "any"))
    if any_rule is not None:
        rules.append(any_rule)
    return tuple(rules)


#: valid string closures (tuple closures are ``("band", axis)``).
_CLOSURE_STRS = frozenset({"cover", "hull"})


def _closure_ok(value) -> bool:
    if isinstance(value, str):
        return value in _CLOSURE_STRS
    return (isinstance(value, tuple) and len(value) == 2
            and value[0] == "band" and isinstance(value[1], int))


def spec_violations(spec: OpSpec) -> list:
    """Enumerate structural violations of one :class:`OpSpec` as
    ``(invariant, message)`` pairs; :func:`register_op` raises on the
    rejecting subset."""
    out: list = []
    if spec.arity not in ("field", "vector", "temporal"):
        out.append(("invalid-arity",
                    f"op {spec.name!r} has arity {spec.arity!r}; expected "
                    "'field', 'vector', or 'temporal'"))
        return out

    if spec.arity == "temporal":
        if spec.lower_temporal is None:
            out.append(("missing-lowering-rule",
                        f"temporal op {spec.name!r} has no lower_temporal "
                        "rule"))
        return out

    if spec.arity == "vector":
        if spec.lower_vector is None:
            out.append(("missing-lowering-rule",
                        f"vector op {spec.name!r} has no lower_vector rule"))
        if spec.component_axes is None:
            out.append(("missing-closure",
                        f"vector op {spec.name!r} has no component_axes "
                        "(per-component region closures derive from it)"))
        else:
            for nc in (2, 3):
                try:
                    axes = spec.component_axes(nc)
                except ValueError:
                    continue  # op legitimately rejects this component count
                if len(axes) != nc or any(
                        a not in range(nc) for t in axes for a in t):
                    out.append(("invalid-closure",
                                f"vector op {spec.name!r}: component_axes"
                                f"({nc}) = {axes!r} is not {nc} in-range "
                                "axis tuples"))
        return out

    # field arity: every feasible (stage, scheme-family) cell needs exactly
    # one lowering rule, and a region closure must exist for each cell
    if spec.closure is None:
        out.append(("missing-closure",
                    f"op {spec.name!r}: field op has no closure callable "
                    "(region-capable cells need one)"))
    seen_cells: set = set()  # one report per (invariant, stage, family) cell
    for scheme in Scheme:
        fam = family_of(scheme)
        for stage in (Stage(s) for s in spec.feasible(scheme)):
            n_rules = len(resolve_rules(spec, scheme, stage))
            if n_rules == 0 and ("miss", stage, fam) not in seen_cells:
                seen_cells.add(("miss", stage, fam))
                out.append(("missing-lowering-rule",
                            f"op {spec.name!r}: feasible cell (stage "
                            f"{stage.name}, {fam}) has no lowering rule"))
            elif n_rules > 1 and ("ambig", stage, fam) not in seen_cells:
                seen_cells.add(("ambig", stage, fam))
                out.append(("ambiguous-lowering-rule",
                            f"op {spec.name!r}: cell (stage {stage.name}, "
                            f"{fam}) matches both a family rule and an "
                            "'any' rule — the family rule silently shadows"))
            if spec.closure is None:
                continue
            try:
                value = spec.closure(scheme, stage, 0)
            except Exception as e:  # noqa: BLE001 - report, don't crash
                out.append(("invalid-closure",
                            f"op {spec.name!r}: closure({scheme.value}, "
                            f"{stage.name}) raised {e!r}"))
                continue
            if not _closure_ok(value):
                out.append(("invalid-closure",
                            f"op {spec.name!r}: closure({scheme.value}, "
                            f"{stage.name}) = {value!r} is not a valid "
                            "region closure"))
    # fused cells are alternates: each needs a torch rule to fall back to and
    # must be a FusedRule (callable with a covers predicate)
    for (stage, fam), fr in spec.fused.items():
        stage = Stage(stage)
        if not (callable(fr) and callable(getattr(fr, "covers", None))):
            out.append(("invalid-fused-rule",
                        f"op {spec.name!r}: fused cell (stage {stage.name}, "
                        f"{fam}) holds {fr!r}, not a FusedRule (callable "
                        "with a covers predicate)"))
        if (spec.lower.get((stage, fam)) is None
                and spec.lower.get((stage, "any")) is None):
            out.append(("fused-cell-without-fallback",
                        f"op {spec.name!r}: fused cell (stage {stage.name}, "
                        f"{fam}) has no torch lowering rule to fall back to "
                        "when the fused rules are off or the context is "
                        "uncovered"))
    # a declared rule no feasible cell can ever reach is dead weight
    for (stage, fam), _rule in spec.lower.items():
        reachable = any(
            Stage(stage) in spec.feasible(scheme)
            and fam in ("any", family_of(scheme))
            for scheme in Scheme)
        if not reachable:
            out.append(("unreachable-lowering-rule",
                        f"op {spec.name!r}: rule for cell (stage "
                        f"{Stage(stage).name}, {fam}) is unreachable from "
                        "every scheme's feasibility row"))
    return out


#: violations that reject an OpSpec at registration time (unreachable rules
#: are reported but accepted).
_REJECTING = frozenset({
    "invalid-arity", "missing-lowering-rule", "ambiguous-lowering-rule",
    "missing-closure", "invalid-closure",
    "invalid-fused-rule", "fused-cell-without-fallback",
})


def register_op(spec: OpSpec) -> OpSpec:
    """Register a user-defined :class:`OpSpec` (collision-guarded): it joins
    the arity-appropriate registry and the canonical order, and plans like a
    built-in."""
    if spec.name in _ALL_OPS:
        raise ValueError(
            f"op name collision: {spec.name!r} is already registered")
    bad = [(inv, msg) for inv, msg in spec_violations(spec)
           if inv in _REJECTING]
    if bad:
        detail = "; ".join(msg for _, msg in bad)
        raise ValueError(
            f"malformed OpSpec {spec.name!r}: {detail} "
            "(every feasible (stage, scheme-family) cell needs exactly one "
            "lowering rule and a region closure)")
    registry = TEMPORAL_OPS if spec.arity == "temporal" else OPS
    registry[spec.name] = spec
    _ALL_OPS[spec.name] = spec
    _ORDER[spec.name] = len(_ORDER)
    return spec


# ===========================================================================
# op-set canonicalization / validation
# ===========================================================================

def canonical_ops(ops: str | Sequence[str]) -> tuple[str, ...]:
    """Validate and canonicalize an op set: known names, de-duplicated,
    registry order, single arity (field, vector and temporal ops consume
    different arguments)."""
    names = [ops] if isinstance(ops, str) else list(ops)
    if not names:
        raise ValueError("empty op set")
    out = []
    for name in names:
        if name not in _ALL_OPS:
            raise ValueError(
                f"unknown operation {name!r}; expected one of "
                f"{tuple(_ALL_OPS)}")
        if name not in out:
            out.append(name)
    out.sort(key=_ORDER.__getitem__)
    if len({_ALL_OPS[n].arity for n in out}) > 1:
        detail = ", ".join(f"{n} ({_ALL_OPS[n].arity})" for n in out)
        raise ValueError(
            f"cannot fuse ops of different arities in one set: {detail} "
            "(field, vector, and temporal ops consume different arguments)")
    return tuple(out)


def is_vector_ops(ops: Sequence[str]) -> bool:
    """True when the (canonical) op set takes vector-field arguments."""
    return _ALL_OPS[ops[0]].arity == "vector"


def is_temporal_ops(ops: Sequence[str]) -> bool:
    """True when the (canonical) op set reduces over a temporal stream."""
    return _ALL_OPS[ops[0]].arity == "temporal"


def _check_feasible(spec: OpSpec, scheme: Scheme, stage: Stage) -> None:
    """Raise with the ops' established error messages."""
    if stage in spec.feasible(scheme):
        return
    if spec.category == "statistic":
        if spec.name == "mean":
            raise UnsupportedStageError("stage-1 mean needs HSZx-family metadata")
        raise UnsupportedStageError("std needs pointwise info (stages 2-4)")
    if spec.category == "temporal":
        if stage == Stage.M:
            raise UnsupportedStageError(
                "temporal ops need pointwise info (stages 2-4)")
        # 1-D partitioning flattens the (time, spatial) layout away, like
        # the spatial stencils (paper §V-B)
        raise UnsupportedStageError("stage-2 temporal ops require nd schemes")
    if stage == Stage.M:
        raise UnsupportedStageError("stencils need pointwise info")
    # paper §V-B: 1-D partitioning destroys multidimensional layout
    raise UnsupportedStageError("stage-2 stencils require nd schemes")


# ===========================================================================
# the lowering pipeline
# ===========================================================================

def compute(target, ops: str | Sequence[str], stage: Stage, *,
            axis: int = 0, region: R.RegionSpec | None = None,
            seed=None, payload_words=None) -> dict[str, torch.Tensor]:
    """Lower an op set onto one shared stage reconstruction.

    ``target`` is a single :class:`Compressed`/:class:`Encoded` field for
    field-arity op sets, or a sequence of component fields for vector-arity
    sets (``divergence``/``curl``).  Returns ``{op: result}``; every value is
    bit-identical to the corresponding single-op call at the same stage.

    ``region`` restricts the query to a window (per-axis ``(start, stop)``,
    ``slice`` or ``None``): the prelude gathers only the blocks of the op
    set's joined dependency closure.  ``seed`` optionally supplies the
    materialized stage reconstruction (``repro_torch.store.
    MaterializedStage``) — one for field-arity sets, one per component for
    vector-arity sets — whose key must match this ``(stage, region,
    closure)``.  ``payload_words`` optionally supplies the region plan's
    gathered payload words (one int32 word tensor per field or component)
    instead of gathering them from ``target.payload``; it requires
    ``region`` and :class:`Encoded` targets.  Seeds and word sets must lie
    on their field's device.
    """
    stage = Stage(stage)
    names = canonical_ops(ops)
    if is_temporal_ops(names):
        raise ValueError(
            f"temporal op set {names} runs over an appended stream of time "
            "slabs; use repro_torch.stream (TemporalField / query) instead "
            "of compute()")
    specs = [OPS[n] for n in names]

    if is_vector_ops(names):
        comps = list(target)
        for spec in specs:
            for c in comps:  # every component must support the stage
                _check_feasible(spec, c.scheme, stage)
        closures = component_closures(names, [c.scheme for c in comps], stage)
        seeds = list(seed) if seed is not None else [None] * len(comps)
        if len(seeds) != len(comps):
            raise ValueError(f"{len(seeds)} seeds for {len(comps)} components")
        words = (list(payload_words) if payload_words is not None
                 else [None] * len(comps))
        if len(words) != len(comps):
            raise ValueError(
                f"{len(words)} payload word sets for {len(comps)} components")
        ctxs = [StageContext(c, stage, region, cl, seed=s, words=w)
                for c, cl, s, w in zip(comps, closures, seeds, words)]
        out = {}
        for spec in specs:
            with trace.span("hsz.op"):
                out[spec.name] = spec.lower_vector(ctxs, axis)
        return out

    c = target
    for spec in specs:
        _check_feasible(spec, c.scheme, stage)
    closure = set_closure(names, c.scheme, stage, axis)
    ctx = StageContext(c, stage, region, closure, seed=seed,
                       words=payload_words)
    family = family_of(c.scheme)
    out = {}
    for spec in specs:
        with trace.span("hsz.op"):
            out[spec.name] = select_rule(spec, stage, family, ctx)(ctx, axis)
    return out


def compute_exprs(exprs, stage: Stage, *,
                  region: R.RegionSpec | None = None, seeds=None):
    """Lower expression DAGs (:mod:`repro_torch.core.expr`) at one explicit
    stage.

    The core-level, storeless entry: every leaf must carry its data directly
    (containers, component bundles or ``TemporalField`` streams; string ids
    need the store-aware ``repro_torch.analytics.query(exprs=...,
    store=...)``).  Each leaf gets exactly one :class:`StageContext` prelude
    shared by all consuming expressions; temporal op nodes are summarized
    over their stream's slabs (the integer-exact per-slab summaries, merged
    in append order) and fed into the pointwise tail.  Returns one result
    per expression (a single expression returns its value directly), each
    bit-identical to composing the corresponding single-op results.
    ``seeds`` optionally maps leaf slots to resident ``MaterializedStage``
    intermediates, as in :func:`compute`.
    """
    from . import expr as expr_mod

    single = isinstance(exprs, expr_mod.Expr)
    program = expr_mod.analyze([exprs] if single else list(exprs))
    bindings = []
    for lf in program.leaves:
        src = lf.source
        flat = src if isinstance(src, tuple) else (src,)
        if any(isinstance(c, str) for c in flat):
            raise ValueError(
                f"leaf {lf.key} names a field id; ids resolve through a "
                "store — use repro_torch.analytics.query(exprs=..., store=...)")
        bindings.append(src)
    expr_mod.validate_bound(program, bindings, region=region)
    stage = Stage(stage)

    precomputed = {}
    for node in program.temporal_nodes:
        tf = bindings[program.slot_of(node.operand)]
        _check_feasible(node.spec, tf.scheme, stage)
        if not tf.slabs:
            raise ValueError("temporal field has no appended slabs")
        summary = reduce(merge_summaries,
                         [summarize_slab(s, stage, region=region)
                          for s in tf.slabs])
        precomputed[program.serial(node)] = node.spec.lower_temporal(
            summary, tf.eps)

    out = expr_mod.lower(program, bindings, (stage,) * program.n_components,
                         region=region, seeds=seeds, precomputed=precomputed)
    return out[0] if single else list(out)
