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
  payload words can stand in for the decode.
* :func:`compute` — validates the op set, joins the per-op region closures
  into one gathered sub-field, builds the context(s) and runs every op's
  postlude, returning ``{op: result}``.

This module ports the spatial half of the reference
(``repro/core/oplib.py``); the float tails keep the reference's order of
operations, which is what the bit-identity of the stencil results rests on.
The full-field path is the region path with ``region=None``.
:func:`compute_exprs` lowers expression DAGs (:mod:`repro_torch.core.expr`)
onto one prelude per leaf.  Temporal ops arrive with the stream slice of the
port.
"""
from __future__ import annotations

from collections.abc import Callable, Mapping, Sequence
from dataclasses import dataclass, field as dc_field
from functools import cached_property

import numpy as np
import torch

from ..kernels import ops as kernel_ops
from . import blocking, quantize
from . import encode as encode_mod
from . import fused as fused_mod
from . import region as R
from .pipeline import HSZCompressor, UnsupportedStageError, by_name
from .stages import Compressed, Encoded, Scheme, Stage

Field = Compressed | Encoded


def _isum(x: torch.Tensor) -> torch.Tensor:
    """Flat int32 sum, wrapping modulo 2^32 like the reference's int32 sums."""
    return x.reshape(-1).sum(dtype=torch.int64).to(torch.int32)


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
    """

    def __init__(self, c: Field, stage: Stage, region, closure: R.Closure,
                 seed=None, words=None):
        self.field = c
        self.stage = Stage(stage)
        self.region = region
        self.closure = closure
        self._axis_diffs: dict[int, torch.Tensor] = {}
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
        return self.field.eps

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
        or the padding-masked full array — reduced flat."""
        if self.plan is not None:
            return _isum(self.plan.window_of(arr))
        w = self.valid_weight
        return _isum(arr if w is None else arr * w)

    def stat_values(self, arr: torch.Tensor) -> torch.Tensor:
        """Flat f32 values a statistic reduces over: the window (region) or
        the full array with padding zeroed (full field)."""
        if self.plan is not None:
            return self.plan.window_of(arr).to(torch.float32).reshape(-1)
        x = arr.to(torch.float32)
        w = self.valid_weight
        return (x if w is None else x * w).reshape(-1)

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
            d = self.sub.residuals
            for a in range(d.ndim):
                if a != axis:
                    d = torch.cumsum(d, dim=a, dtype=torch.int32)
            self._axis_diffs[axis] = d
        return d

    @cached_property
    def lorenzo_q(self) -> torch.Tensor:
        """Stage-③ integers of a Lorenzo sub-field (padded layout), derived
        from the axis-0 difference so a {derivative, std} set shares passes."""
        return torch.cumsum(self.lorenzo_axis_diff(0), dim=0, dtype=torch.int32)

    @cached_property
    def upsampled_means(self) -> torch.Tensor:
        """Block means upsampled to the spatial layout (block-mean family)."""
        return blocking.upsample_block_means(self.sub.metadata, self.sub.block)

    @cached_property
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
    def f_spatial(self) -> torch.Tensor:
        """Stage-④ floats on the queried extent, derived from
        :attr:`q_spatial` even when seeded (dequantize commutes with the
        crop, and seeded and cold paths share this float tail)."""
        return quantize.dequantize(self.q_spatial, self.eps,
                                   self.field.orig_dtype)

    @cached_property
    def lorenzo_mean_weights(self) -> tuple[torch.Tensor, ...]:
        """Sum weights: ``sum_{i in extent} q_i = <weights, residuals>`` —
        per-axis separable (nd) or one flat vector (1-D schemes)."""
        dev = self.eps.device
        if self.plan is not None:
            return self.plan.device_weights(dev)
        c = self.field
        dims = c.shape if c.scheme.is_nd else (c.n,)
        return tuple(
            torch.as_tensor(np.clip(nvalid - np.arange(npad), 0, None)
                            .astype(np.float32), device=dev)
            for npad, nvalid in zip(c.padded_shape, dims))


# ===========================================================================
# stencil helpers (shared by every lowering path)
# ===========================================================================

def _interior(x: torch.Tensor) -> torch.Tensor:
    """Crop one element at each end of every axis (common stencil interior)."""
    return x[tuple(slice(1, -1) for _ in range(x.ndim))]


def _shift_pair(x: torch.Tensor, axis: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(x_{+1}, x_{-1}) views cropped to the common interior."""
    nd = x.ndim
    idx_p = [slice(1, -1)] * nd
    idx_m = [slice(1, -1)] * nd
    idx_p[axis] = slice(2, None)
    idx_m[axis] = slice(None, -2)
    return x[tuple(idx_p)], x[tuple(idx_m)]


def _central_diff(x: torch.Tensor, axis: int, scale) -> torch.Tensor:
    """(x_{+1} - x_{-1}) * scale on the common interior (V-B.2)."""
    hi, lo = _shift_pair(x, axis)
    return (hi - lo).to(torch.float32) * scale


def _lorenzo_deriv_stencil(d: torch.Tensor, axis: int) -> torch.Tensor:
    """q_{+1} - q_{-1} = D_a[i+1] + D_a[i] on the interior (V-B.1), with
    ``d`` the cropped Lorenzo axis difference."""
    sl_hi = [slice(1, -1)] * d.ndim
    sl_hi[axis] = slice(2, None)
    sl_lo = [slice(1, -1)] * d.ndim
    return (d[tuple(sl_hi)] + d[tuple(sl_lo)]).to(torch.float32)


def _lorenzo_lap_term(d: torch.Tensor, axis: int) -> torch.Tensor:
    """D_a[i+1] - D_a[i] on the interior — one axis term of V-B.3."""
    sl_hi = [slice(1, -1)] * d.ndim
    sl_hi[axis] = slice(2, None)
    sl_lo = [slice(1, -1)] * d.ndim
    return d[tuple(sl_hi)] - d[tuple(sl_lo)]


def _laplacian_stencil(x: torch.Tensor) -> torch.Tensor:
    """Sum of neighbors minus 2·nd·center on the common interior, f32."""
    acc = -2.0 * x.ndim * _interior(x).to(torch.float32)
    for a in range(x.ndim):
        hi, lo = _shift_pair(x, a)
        acc = acc + hi.to(torch.float32) + lo.to(torch.float32)
    return acc


def _blockmean_deriv_p(p: torch.Tensor, m: torch.Tensor, axis: int) -> torch.Tensor:
    """(p_{+1} - p_{-1}) + (m_{+1} - m_{-1}): V-B §② with the border Delta
    terms realized as a shifted upsampled-mean difference."""
    p_hi, p_lo = _shift_pair(p, axis)
    m_hi, m_lo = _shift_pair(m, axis)
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
    s = _isum(ctx.metadata_blocks.reshape(-1) * ctx.block_overlap)
    return s / ctx.n * ctx.eps * 2.0


def _mean_p_blockmean(ctx: StageContext, axis: int) -> torch.Tensor:
    # ② sum q over extent = sum p over extent + sum_b M_b * overlap_b (V-A §②)
    sp = ctx.masked_sum(ctx.sub.residuals)
    sm = _isum(ctx.sub.metadata.reshape(-1) * ctx.block_overlap)
    return (sp + sm) / ctx.n * ctx.eps * 2.0


def _mean_p_lorenzo(ctx: StageContext, axis: int) -> torch.Tensor:
    # ② Lorenzo: sum q = weighted sum of residuals; separable weights make
    # this a rank-1 contraction (w0^T P w1 ...) for nd, one dot for flat
    acc = ctx.sub.residuals.to(torch.float32)
    weights = ctx.lorenzo_mean_weights
    if ctx.scheme.is_nd:
        for w in weights:
            acc = torch.tensordot(acc, w, dims=([0], [0]))
    else:
        acc = torch.dot(acc.reshape(-1), weights[0])
    return acc / ctx.n * ctx.eps * 2.0


def _mean_q(ctx: StageContext, axis: int) -> torch.Tensor:
    return torch.mean(ctx.q_spatial.to(torch.float32).reshape(-1)) * ctx.eps * 2.0


def _mean_f(ctx: StageContext, axis: int) -> torch.Tensor:
    return torch.mean(ctx.f_spatial.to(torch.float32).reshape(-1))


def _std_p_blockmean(ctx: StageContext, axis: int) -> torch.Tensor:
    # ② decompose (q - mu) = (p) + (M_b - mu~) with integer mean mu~ (V-A §②)
    n = ctx.n
    s = _isum(ctx.sub.metadata.reshape(-1) * ctx.block_overlap)
    if ctx.plan is None:
        # complete blocks keep per-block residual sums near zero, so the
        # metadata term alone anchors the integer mean
        tot = s
    else:
        # a partial block contributes a one-sided slice of its residuals, so
        # the exact integer window sum must include them
        tot = s + _isum(ctx.plan.window_of(ctx.sub.residuals))
    mu_int = torch.round(tot / n).to(torch.int32)
    x = ctx.stat_values(ctx.sub.residuals + (ctx.upsampled_means - mu_int))
    ss = torch.sum(x * x)
    # remove the integer mean's first-order offset r, |r| <= 1/2, exactly
    r = tot / n - mu_int
    ss = ss - 2.0 * r * torch.sum(x) + n * r * r
    return torch.sqrt(torch.clamp(ss, min=0.0) / (n - 1)) * ctx.eps * 2.0


def _std_moments(qf: torch.Tensor, n: int, eps: torch.Tensor) -> torch.Tensor:
    s1, s2 = torch.sum(qf), torch.sum(qf * qf)
    var = (s2 - s1 * s1 / n) / (n - 1)
    return torch.sqrt(torch.clamp(var, min=0.0)) * eps * 2.0


def _std_p_lorenzo(ctx: StageContext, axis: int) -> torch.Tensor:
    return _std_moments(ctx.stat_values(ctx.lorenzo_q), ctx.n, ctx.eps)


def _std_q(ctx: StageContext, axis: int) -> torch.Tensor:
    return _std_moments(ctx.q_spatial.to(torch.float32).reshape(-1), ctx.n,
                        ctx.eps)


def _std_f(ctx: StageContext, axis: int) -> torch.Tensor:
    # two-pass (mean-subtracted): ④ is the accuracy reference the lower
    # stages are judged against
    xf = ctx.f_spatial.to(torch.float32).reshape(-1)
    n = ctx.n
    d = xf - torch.sum(xf) / n
    return torch.sqrt(torch.clamp(torch.sum(d * d) / (n - 1), min=0.0))


def _deriv_p_lorenzo(ctx: StageContext, axis: int) -> torch.Tensor:
    d = ctx.spatial_window(ctx.lorenzo_axis_diff(axis))
    return _lorenzo_deriv_stencil(d, axis) * ctx.eps


def _deriv_p_blockmean(ctx: StageContext, axis: int) -> torch.Tensor:
    return _blockmean_deriv_p(ctx.spatial_window(ctx.sub.residuals),
                              ctx.spatial_window(ctx.upsampled_means),
                              axis) * ctx.eps


def _deriv_q(ctx: StageContext, axis: int) -> torch.Tensor:
    return _central_diff(ctx.q_spatial, axis, ctx.eps)


# stage ④ stencils ARE the stage-③ rules: (f_hi - f_lo)/2 with f = 2*eps*q
# is the exact integer difference scaled once — one f32 rounding
_deriv_f = _deriv_q


def _lap_p_lorenzo(ctx: StageContext, axis: int) -> torch.Tensor:
    # sum_a (D_a[+1] - D_a[0]) — paper Eq. V-B.3 generalized to n-D
    total = None
    for a in range(ctx.sub.residuals.ndim):
        d = ctx.spatial_window(ctx.lorenzo_axis_diff(a))
        term = _lorenzo_lap_term(d, a)
        total = term if total is None else total + term
    return total.to(torch.float32) * (2.0 * ctx.eps)


def _lap_p_blockmean(ctx: StageContext, axis: int) -> torch.Tensor:
    m = ctx.spatial_window(ctx.upsampled_means)
    p = ctx.spatial_window(ctx.sub.residuals)
    return (_laplacian_stencil(p) + _laplacian_stencil(m)) * (2.0 * ctx.eps)


def _lap_q(ctx: StageContext, axis: int) -> torch.Tensor:
    return _laplacian_stencil(ctx.q_spatial) * (2.0 * ctx.eps)  # (V-B.4)


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
    ``lower_vector``.
    """

    name: str
    arity: str                    # "field" | "vector"
    category: str                 # "statistic" | "differentiation" | "multivariate"
    feasible: Callable[[Scheme], tuple[Stage, ...]]
    needs_axis: bool = False
    closure: Callable[[Scheme, Stage, int], R.Closure] | None = None
    component_axes: Callable[[int], tuple[tuple[int, ...], ...]] | None = None
    lower: Mapping[tuple[Stage, str], Rule] = dc_field(default_factory=dict)
    fused: Mapping[tuple[Stage, str], fused_mod.FusedRule] = dc_field(
        default_factory=dict)
    lower_vector: Callable | None = None


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


def _select(fused: Mapping, lower: Mapping, stage: Stage, family: str,
            ctx: StageContext) -> Rule:
    """The one dispatch rule: the cell's fused rule when fused rules are
    selected and it covers this context, else the torch rule."""
    fr = fused.get((stage, family))
    if fr is not None and kernel_ops.kernels_enabled() and fr.covers(ctx):
        return fr
    rule = lower.get((stage, family)) or lower.get((stage, "any"))
    if rule is None:
        raise KeyError((stage, family))
    return rule


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

_ORDER = {name: i for i, name in enumerate(OPS)}


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
    rejecting subset.  Temporal arity arrives with the stream slice."""
    out: list = []
    if spec.arity not in ("field", "vector"):
        out.append(("invalid-arity",
                    f"op {spec.name!r} has arity {spec.arity!r}; expected "
                    "'field' or 'vector'"))
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
    the registry and the canonical order, and plans like a built-in."""
    if spec.name in OPS:
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
    OPS[spec.name] = spec
    _ORDER[spec.name] = len(_ORDER)
    return spec


# ===========================================================================
# op-set canonicalization / validation
# ===========================================================================

def canonical_ops(ops: str | Sequence[str]) -> tuple[str, ...]:
    """Validate and canonicalize an op set: known names, de-duplicated,
    registry order, single arity."""
    names = [ops] if isinstance(ops, str) else list(ops)
    if not names:
        raise ValueError("empty op set")
    out = []
    for name in names:
        if name not in OPS:
            raise ValueError(
                f"unknown operation {name!r}; expected one of {tuple(OPS)}")
        if name not in out:
            out.append(name)
    out.sort(key=_ORDER.__getitem__)
    if len({OPS[n].arity for n in out}) > 1:
        detail = ", ".join(f"{n} ({OPS[n].arity})" for n in out)
        raise ValueError(
            f"cannot fuse ops of different arities in one set: {detail} "
            "(field and vector ops consume different arguments)")
    return tuple(out)


def is_vector_ops(ops: Sequence[str]) -> bool:
    """True when the (canonical) op set takes vector-field arguments."""
    return OPS[ops[0]].arity == "vector"


def _check_feasible(spec: OpSpec, scheme: Scheme, stage: Stage) -> None:
    """Raise with the ops' established error messages."""
    if stage in spec.feasible(scheme):
        return
    if spec.category == "statistic":
        if spec.name == "mean":
            raise UnsupportedStageError("stage-1 mean needs HSZx-family metadata")
        raise UnsupportedStageError("std needs pointwise info (stages 2-4)")
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
        return {spec.name: spec.lower_vector(ctxs, axis) for spec in specs}

    c = target
    for spec in specs:
        _check_feasible(spec, c.scheme, stage)
    closure = set_closure(names, c.scheme, stage, axis)
    ctx = StageContext(c, stage, region, closure, seed=seed,
                       words=payload_words)
    family = family_of(c.scheme)
    return {spec.name: select_rule(spec, stage, family, ctx)(ctx, axis)
            for spec in specs}


def compute_exprs(exprs, stage: Stage, *,
                  region: R.RegionSpec | None = None, seeds=None):
    """Lower expression DAGs (:mod:`repro_torch.core.expr`) at one explicit
    stage.

    The core-level, storeless entry: every leaf must carry its data directly
    (containers or component bundles; string ids need the store-aware
    ``repro_torch.analytics.query(exprs=..., store=...)``).  Each leaf gets
    exactly one :class:`StageContext` prelude shared by all consuming
    expressions.  Returns one result per expression (a single expression
    returns its value directly), each bit-identical to composing the
    corresponding single-op results.  ``seeds`` optionally maps leaf slots
    to resident ``MaterializedStage`` intermediates, as in :func:`compute`.
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
    out = expr_mod.lower(program, bindings,
                         (Stage(stage),) * program.n_components,
                         region=region, seeds=seeds, precomputed={})
    return out[0] if single else list(out)
