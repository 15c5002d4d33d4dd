"""Linear-scaling quantization (paper §IV, "Quantization").

``q_i = round(d_i / (2 eps))`` with round-half-even; decompression recovers
``d'_i = 2 q_i eps`` which guarantees ``|d_i - d'_i| <= eps``.
"""
from __future__ import annotations

import torch


def resolve_eps(data: torch.Tensor, *, abs_eb: float | None = None,
                rel_eb: float | None = None) -> torch.Tensor:
    """Resolve the absolute error bound as an f32 scalar on ``data``'s device.

    ``rel_eb`` follows the paper's value-range-based relative bound:
    ``eps = rel_eb * (max(d) - min(d))``.  Exactly one of ``abs_eb``/``rel_eb``
    must be provided.
    """
    if (abs_eb is None) == (rel_eb is None):
        raise ValueError("provide exactly one of abs_eb / rel_eb")
    if abs_eb is not None:
        return torch.tensor(abs_eb, dtype=torch.float32, device=data.device)
    value_range = (data.max() - data.min()).to(torch.float32)
    # Degenerate constant fields quantize to all-zero integers with any eps>0.
    return torch.where(value_range > 0, value_range * rel_eb,
                       torch.ones_like(value_range))


def quantize(data: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """Map floating-point data to int32 quantization indices.

    Uses ``round(d * inv)`` with ``inv = 1/(2 eps)`` in f32 — the exact
    expression is part of the format contract; ``torch.round`` rounds half to
    even like the reference.
    """
    inv = 1.0 / (2.0 * eps)
    return torch.round(data.to(torch.float32) * inv).to(torch.int32)


def dequantize(q: torch.Tensor, eps: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Recover floating-point values: ``d' = 2 q eps``."""
    return (q.to(torch.float32) * (2.0 * eps)).to(dtype)
