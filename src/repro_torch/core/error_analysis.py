"""Theoretical bias bounds for homomorphic operations (paper §V-D).

These closed forms are used as *oracles* by the tests: every homomorphic
result must sit within its proven bound of the stage-④ result.
"""
from __future__ import annotations

import torch

from .stages import Compressed, Encoded, Stage

_F32_EPS = float(torch.finfo(torch.float32).eps)


def mean_bias_bound(c: Compressed | Encoded, stage: Stage) -> float:
    """|mu_stage - mu_f| bound.

    §V-D.1: metadata means round each block to the nearest integer
    (|r_b| <= 1/2), so |mu_M - mu_f| <= eps.  §V-D.2: stages ②③ differ from ④
    only by float summation order — O(ulp) which we bound generously.
    """
    eps = float(c.eps.item())
    if stage == Stage.M:
        return eps
    return 64.0 * _F32_EPS * eps * max(1, c.n) ** 0.5


def std_bias_bound(c: Compressed | Encoded, stage: Stage) -> float:
    """§V-D.3: HSZx-family stage-② std uses the rounded integer mean, giving
    |sigma_p - sigma_f| <= eps; other stages are algebraically identical to
    V-A.2 (rounding only)."""
    eps = float(c.eps.item())
    if stage == Stage.P and c.scheme.is_blockmean:
        return eps
    return 64.0 * _F32_EPS * eps * max(1, c.n) ** 0.5


def stencil_bias_bound(c: Compressed | Encoded) -> float:
    """§V-D.5: finite differences are exact in the integer domain, so the
    stage-②/③ results differ from stage-④ only by float round-off."""
    return 32.0 * _F32_EPS * float(c.eps.item()) * 8.0


def temporal_round_bound(op: str, summary, eps) -> torch.Tensor:
    """Elementwise bound on how far two evaluations of a temporal postlude
    (§9: ``oplib.temporal_postlude`` on one merged summary) may differ when
    they round their float tails in another order.

    ``tdelta`` / ``tmin`` / ``tmax`` are one rounding of an exact integer
    times ``2 eps``: 0, they agree bitwise.  ``tmean`` rounds twice
    (``× 2 eps``, ``/ T``): 4 ulp of its value.  ``tstd``'s moments form
    cancels: ``s2 - s1²/n`` is rounded at the magnitude ``s2 + s1²/n``, so
    two orders differ in the variance by
    ``δ <= 4 ε (s2 + s1²/n) / max(n - 1, 1)`` (in q² units) and in the std
    by ``2 eps √δ`` (``|√a - √b| <= √|a - b|``), plus 4 ulp of the value.
    """
    e = float(eps)
    if op in ("tdelta", "tmin", "tmax"):
        return torch.zeros(summary.q_sum.shape, dtype=torch.float64)
    n = float(summary.count)
    s1 = summary.q_sum.cpu().double()
    if op == "tmean":
        return 4 * _F32_EPS * (s1 * 2 * e / n).abs()
    if op != "tstd":
        raise ValueError(f"not a temporal op: {op!r}")
    s2 = summary.q_sumsq.cpu().double()
    dof = max(n - 1.0, 1.0)
    delta = 4 * _F32_EPS * (s2 + s1 * s1 / n) / dof
    std = ((s2 - s1 * s1 / n) / dof).clamp(min=0.0).sqrt() * 2 * e
    return 2 * e * delta.sqrt() + 4 * _F32_EPS * std


def reconstruction_bound(c: Compressed | Encoded, max_abs: float = 0.0) -> float:
    """The compressor's contract: |d - d'| <= eps (paper §III-A), plus the
    f32 round-off of the dequantize product (a few ulps of |d|)."""
    return float(c.eps.item()) + 4 * _F32_EPS * max_abs
