"""Plain reference of HSZ error-bounded quantization and the analytics.

From the raw fields it works out again what the compressed store holds and
what each request asks of it: the error bound ``eps = rel_eb * (max - min)``,
the quantization integers ``q = round(x / (2 eps))`` (the format's f32
expression: ``x * (1 / (2 eps))``, rounded half to even), the block means of
the block-mean predictor (stage ①), and each answer on a window of ``q``
(paper §V: statistics over the window, stencils on its interior, all scaled
by the field's own ``eps``).

Answers are computed in float64 from integers, so they are exact but for
one rounding.  With ``dtype=torch.bfloat16`` every step, the quantization
included, runs in bfloat16 instead: that is the control, the reference put
in the system's place one precision below the float32 the configuration
states.
"""
from __future__ import annotations

import math

import torch

STAT_OPS = ("mean", "std")
STENCIL_OPS = ("derivative", "gradient", "laplacian")
VECTOR_OPS = ("divergence", "curl")


def quantize(x: torch.Tensor, rel_eb: float, dtype=torch.float32):
    """``(q, eps)``: int64 quantization integers and the absolute bound."""
    x = x.to(dtype)
    value_range = (x.max() - x.min()).to(dtype)
    eps = torch.where(value_range > 0, value_range * rel_eb,
                      torch.ones_like(value_range))
    inv = 1.0 / (2.0 * eps)
    return torch.round(x * inv).to(torch.int64), eps


def _padded(q: torch.Tensor, block) -> torch.Tensor:
    """``q`` padded with edge values to whole blocks."""
    for axis, b in enumerate(block):
        n = q.shape[axis]
        target = -(-n // b) * b
        if target != n:
            idx = torch.arange(target, device=q.device).clamp_(max=n - 1)
            q = q.index_select(axis, idx)
    return q


def _zero_padded(x: torch.Tensor, block) -> torch.Tensor:
    """``x`` padded with zeros to whole blocks."""
    shape = tuple(-(-n // b) * b for n, b in zip(x.shape, block))
    out = x.new_zeros(shape)
    out[tuple(slice(0, n) for n in x.shape)] = x
    return out


def _block_sums(x: torch.Tensor, block) -> torch.Tensor:
    """Per-block sums of a padded array, in block-grid layout."""
    shape = []
    for s, b in zip(x.shape, block):
        shape += [s // b, b]
    x = x.reshape(shape)
    return x.sum(dim=tuple(range(1, 2 * len(block), 2)))


def block_means(q: torch.Tensor, block) -> torch.Tensor:
    """Stage ① of the block-mean predictor: each block's mean over its valid
    (unpadded) elements, rounded half up, as integers in block-grid layout."""
    valid = _zero_padded(torch.ones_like(q), block)
    sums = _block_sums(_padded(q, block) * valid, block)
    counts = _block_sums(valid, block).clamp_(min=1)
    return torch.div(2 * sums + counts, 2 * counts, rounding_mode="floor")


def _window(x: torch.Tensor, window) -> torch.Tensor:
    if window is None:
        return x
    return x[tuple(slice(a, b) for a, b in window)]


def _interior(x: torch.Tensor, axis: int | None = None, shift: int = 0):
    """The common interior of ``x`` (one element off each end of every
    axis), moved by ``shift`` along ``axis``."""
    idx = [slice(1, n - 1) for n in x.shape]
    if axis is not None:
        n = x.shape[axis]
        idx[axis] = slice(1 + shift, n - 1 + shift)
    return x[tuple(idx)]


def _derivative(q, eps, axis, dtype):
    d = (_interior(q, axis, 1) - _interior(q, axis, -1)).to(dtype)
    return d * eps.to(dtype)


def _laplacian(q, eps, dtype):
    acc = -2 * q.ndim * _interior(q)
    for axis in range(q.ndim):
        acc = acc + _interior(q, axis, 1) + _interior(q, axis, -1)
    return acc.to(dtype) * (2.0 * eps.to(dtype))


def feasible_stages(op: str, scheme: str, window, block,
                    shape) -> tuple[int, ...]:
    """The stages (1 metadata, 2 residuals, 3 integers, 4 floats) that
    can answer ``op`` on a field of ``scheme`` and ``shape`` (paper Table
    I; stage ① only over whole blocks)."""
    nd = scheme.endswith("_nd")
    if op == "mean":
        aligned = window is None or all(
            a % b == 0 and (c % b == 0 or c == n)
            for (a, c), b, n in zip(window, block, shape))
        return ((1,) if scheme.startswith("hszx") and aligned else ()) + (2, 3, 4)
    if op == "std":
        return (2, 3, 4)
    return ((2,) if nd else ()) + (3, 4)


def answer(op: str, fields, *, stage: int, window=None, axis: int = 0,
           block=None, dtype=torch.float64):
    """The answer to one request.

    ``fields`` holds one ``(q, eps)`` pair, or one per component for
    ``divergence`` and ``curl``; ``q`` is the whole field's integers (block
    means need the whole field).  Statistics return a 0-d tensor, stencils
    an array on the window's interior, ``gradient`` a tuple of them."""
    if op in VECTOR_OPS:
        parts = [(_window(q, window), eps) for q, eps in fields]
        if op == "divergence":
            total = None
            for a, (q, eps) in enumerate(parts):
                term = _derivative(q, eps, a, dtype)
                total = term if total is None else total + term
            return total
        if len(parts) != 2:
            raise ValueError("the reference's curl is the 2-D one")
        (u, eu), (v, ev) = parts
        return _derivative(v, ev, 0, dtype) - _derivative(u, eu, 1, dtype)
    ((q_full, eps),) = fields
    q = _window(q_full, window)
    if op == "mean":
        if stage == 1:
            means = block_means(q_full, block)
            mask = torch.zeros_like(q_full)
            _window(mask, window).fill_(1)
            overlap = _block_sums(_zero_padded(mask, block), block)
            total = (means * overlap).sum().to(dtype)
        else:
            total = q.sum().to(dtype)
        return total / q.numel() * (2.0 * eps.to(dtype))
    if op == "std":
        qf = q.to(dtype)
        var = ((qf - qf.mean()) ** 2).sum() / (q.numel() - 1)
        return torch.sqrt(var) * (2.0 * eps.to(dtype))
    if op == "derivative":
        return _derivative(q, eps, axis, dtype)
    if op == "gradient":
        return tuple(_derivative(q, eps, a, dtype) for a in range(q.ndim))
    if op == "laplacian":
        return _laplacian(q, eps, dtype)
    raise ValueError(f"the reference has no op {op!r}")


def category(op: str) -> str:
    """``"stat"`` or ``"stencil"``: which compared number an op's answers
    count towards."""
    return "stat" if op in STAT_OPS else "stencil"


def gap(got, want, scale: float) -> float:
    """The widest gap between an answer and the reference, in units of
    ``scale`` (the fields' ``eps``); ``inf`` for a NaN or a shape that
    differs."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    if len(got) != len(want):
        return math.inf
    worst = 0.0
    for g, w in zip(got, want):
        if tuple(g.shape) != tuple(w.shape):
            return math.inf
        if g.numel() == 0:
            continue
        d = (g.to(torch.float64) - w.to(torch.float64)).abs().max().item()
        if math.isnan(d):
            return math.inf
        worst = max(worst, d / scale)
    return worst
