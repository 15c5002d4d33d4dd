"""Operator-lowering core: one stage reconstruction, many homomorphic results.

* :class:`OpSpec` — a declarative description of one analytical operation:
  name, arity (single field vs vector of components), per-scheme feasible
  stages (paper Table I), and one lowering rule per ``(stage, scheme
  family)`` cell, with optional kernel-backed :class:`FusedRule` alternates.
* :class:`StageContext` — the *prelude* of a lowering: payload decode,
  cumsum / block-mean-upsample recorrelation, cropping and statistic
  weights, each computed lazily and **at most once**, so an op set reuses a
  single stage reconstruction.
* :func:`compute` — validates the op set, builds the context(s) and runs
  every op's postlude, returning ``{op: result}``.

This module ports the full-field path of the reference
(``repro/core/oplib.py``); the float tails keep the reference's order of
operations, which is what the bit-identity of the stencil results rests on.
Region windows, materialized seeds and pre-gathered payload words arrive
with later slices of the port.
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
from .pipeline import HSZCompressor, UnsupportedStageError, by_name
from .stages import Compressed, Encoded, Scheme, Stage

Field = Compressed | Encoded

_LATER_SLICE = "region/store/shard slice"


def _isum(x: torch.Tensor) -> torch.Tensor:
    """Flat int32 sum, wrapping modulo 2^32 like the reference's int32 sums."""
    return x.reshape(-1).sum(dtype=torch.int64).to(torch.int32)


# ===========================================================================
# the shared prelude
# ===========================================================================

class StageContext:
    """One full-field stage reconstruction for a ``(field, stage)``.

    Every intermediate is a cached property, so any number of op postludes
    share one decode / recorrelation / crop pass.
    """

    def __init__(self, c: Field, stage: Stage):
        self.field = c
        self.stage = Stage(stage)
        self._axis_diffs: dict[int, torch.Tensor] = {}

    # -- static layout ------------------------------------------------------
    @property
    def scheme(self) -> Scheme:
        return self.field.scheme

    @property
    def eps(self) -> torch.Tensor:
        return self.field.eps

    @property
    def n(self) -> int:
        """Valid element count of the field."""
        return self.field.n

    @cached_property
    def compressor(self) -> HSZCompressor:
        return by_name(self.scheme.value, self.field.block)

    # -- decode (once) ------------------------------------------------------
    @cached_property
    def sub(self) -> Compressed:
        """The (decoded) field the ops run on."""
        c = self.field
        return encode_mod.decode_device(c) if isinstance(c, Encoded) else c

    # -- masking helpers ----------------------------------------------------
    @cached_property
    def valid_weight(self) -> torch.Tensor | None:
        """Spatial 0/1 mask of valid elements, or None without padding."""
        c = self.field
        shape = c.shape if c.scheme.is_nd else (c.n,)
        if not blocking.has_padding(shape, c.block):
            return None
        return torch.as_tensor(blocking.valid_mask(shape, c.block),
                               dtype=torch.int32, device=c.eps.device)

    def masked_sum(self, arr: torch.Tensor) -> torch.Tensor:
        """Exact (int32) sum over the padding-masked array, reduced flat."""
        w = self.valid_weight
        return _isum(arr if w is None else arr * w)

    def stat_values(self, arr: torch.Tensor) -> torch.Tensor:
        """Flat f32 values a statistic reduces over, padding zeroed."""
        x = arr.to(torch.float32)
        w = self.valid_weight
        return (x if w is None else x * w).reshape(-1)

    def spatial_window(self, arr: torch.Tensor) -> torch.Tensor:
        """Crop a padded spatial array to the original shape."""
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
        """Stage-③ integers of a Lorenzo field (padded layout), derived from
        the axis-0 difference so a {derivative, std} set shares passes."""
        return torch.cumsum(self.lorenzo_axis_diff(0), dim=0, dtype=torch.int32)

    @cached_property
    def upsampled_means(self) -> torch.Tensor:
        """Block means upsampled to the spatial layout (block-mean family)."""
        return blocking.upsample_block_means(self.sub.metadata, self.sub.block)

    @cached_property
    def q_spatial(self) -> torch.Tensor:
        """Stage-③ integers cropped to the original shape."""
        return self.compressor.decompress(self.sub, Stage.Q, crop=True)

    @cached_property
    def f_spatial(self) -> torch.Tensor:
        """Stage-④ floats (dequantize commutes with the crop)."""
        return quantize.dequantize(self.q_spatial, self.eps,
                                   self.field.orig_dtype)

    @cached_property
    def lorenzo_mean_weights(self) -> tuple[torch.Tensor, ...]:
        """Sum weights: ``sum_{valid} q_i = <weights, residuals>`` — per-axis
        separable (nd) or one flat vector (1-D schemes)."""
        c = self.field
        dims = c.shape if c.scheme.is_nd else (c.n,)
        return tuple(
            torch.as_tensor(np.clip(nvalid - np.arange(npad), 0, None)
                            .astype(np.float32), device=c.eps.device)
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
    # ① metadata path: mu = (1/N) sum_b M_b S_b * 2eps  (V-A.1)
    # read from the container, never from ctx.sub: stage ① must not decode
    s = _isum(ctx.field.metadata.reshape(-1) * ctx.field.valid_counts)
    return s / ctx.n * ctx.eps * 2.0


def _mean_p_blockmean(ctx: StageContext, axis: int) -> torch.Tensor:
    # ② sum q = sum p + sum_b M_b * count_b (V-A §②)
    sp = ctx.masked_sum(ctx.sub.residuals)
    sm = _isum(ctx.sub.metadata.reshape(-1) * ctx.field.valid_counts)
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
    # ② decompose (q - mu) = (p) + (M_b - mu~) with integer mean mu~ (V-A §②);
    # complete blocks keep per-block residual sums near zero, so the
    # metadata term alone anchors the integer mean
    n = ctx.n
    tot = _isum(ctx.sub.metadata.reshape(-1) * ctx.field.valid_counts)
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
    a torch rule to fall back to.  Vector ops declare ``lower_vector``.
    """

    name: str
    arity: str                    # "field" | "vector"
    category: str                 # "statistic" | "differentiation" | "multivariate"
    feasible: Callable[[Scheme], tuple[Stage, ...]]
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


_DERIV_RULES: dict[tuple[Stage, str], Rule] = {
    (Stage.P, "lorenzo"): _deriv_p_lorenzo,
    (Stage.P, "blockmean"): _deriv_p_blockmean,
    (Stage.Q, "any"): _deriv_q,
    (Stage.F, "any"): _deriv_f,
}


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


#: the registry: declaration order is the canonical op-set order.
OPS: dict[str, OpSpec] = {
    spec.name: spec for spec in (
        OpSpec("mean", "field", "statistic", _mean_stages,
               lower={(Stage.M, "blockmean"): _mean_m,
                      (Stage.P, "blockmean"): _mean_p_blockmean,
                      (Stage.P, "lorenzo"): _mean_p_lorenzo,
                      (Stage.Q, "any"): _mean_q,
                      (Stage.F, "any"): _mean_f}),
        OpSpec("std", "field", "statistic", _std_stages,
               lower={(Stage.P, "blockmean"): _std_p_blockmean,
                      (Stage.P, "lorenzo"): _std_p_lorenzo,
                      (Stage.Q, "any"): _std_q,
                      (Stage.F, "any"): _std_f}),
        OpSpec("derivative", "field", "differentiation", _stencil_stages,
               lower=_DERIV_RULES,
               fused=fused_mod.DERIVATIVE),
        OpSpec("gradient", "field", "differentiation", _stencil_stages,
               lower={(Stage.P, "any"): _gradient_rule,
                      (Stage.Q, "any"): _gradient_rule,
                      (Stage.F, "any"): _gradient_rule},
               fused=fused_mod.GRADIENT),
        OpSpec("laplacian", "field", "differentiation", _stencil_stages,
               lower={(Stage.P, "lorenzo"): _lap_p_lorenzo,
                      (Stage.P, "blockmean"): _lap_p_blockmean,
                      (Stage.Q, "any"): _lap_q,
                      (Stage.F, "any"): _lap_f},
               fused=fused_mod.LAPLACIAN),
        OpSpec("divergence", "vector", "multivariate", _stencil_stages,
               lower_vector=_divergence_vector),
        OpSpec("curl", "vector", "multivariate", _stencil_stages,
               lower_vector=_curl_vector),
    )
}

_ORDER = {name: i for i, name in enumerate(OPS)}


def family_of(scheme: Scheme) -> str:
    """The lowering-rule family key of a scheme: ``"lorenzo"`` for the HSZp
    pair, ``"blockmean"`` for HSZx."""
    return "lorenzo" if Scheme(scheme).is_lorenzo else "blockmean"


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
            axis: int = 0, region=None, seed=None,
            payload_words=None) -> dict[str, torch.Tensor]:
    """Lower an op set onto one shared full-field stage reconstruction.

    ``target`` is a single :class:`Compressed`/:class:`Encoded` field for
    field-arity op sets, or a sequence of component fields for vector-arity
    sets (``divergence``/``curl``).  Returns ``{op: result}``; every value is
    bit-identical to the corresponding single-op call at the same stage.
    ``region``, ``seed`` and ``payload_words`` belong to later slices of the
    port and raise ``NotImplementedError``.
    """
    if region is not None or seed is not None or payload_words is not None:
        raise NotImplementedError(_LATER_SLICE)
    stage = Stage(stage)
    names = canonical_ops(ops)
    specs = [OPS[n] for n in names]

    if is_vector_ops(names):
        comps = list(target)
        for spec in specs:
            for c in comps:  # every component must support the stage
                _check_feasible(spec, c.scheme, stage)
        ctxs = [StageContext(c, stage) for c in comps]
        return {spec.name: spec.lower_vector(ctxs, axis) for spec in specs}

    c = target
    for spec in specs:
        _check_feasible(spec, c.scheme, stage)
    ctx = StageContext(c, stage)
    family = family_of(c.scheme)
    return {spec.name: select_rule(spec, stage, family, ctx)(ctx, axis)
            for spec in specs}
