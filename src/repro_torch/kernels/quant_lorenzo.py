"""Fused quantize + 2-D Lorenzo decorrelation: the Hopper kernel and its
plain version.

Counterpart of ``repro/kernels/quant_lorenzo.py:quant_lorenzo2d``:
``p = lorenzo(round(x / 2eps))`` for a 2-D f32 field in one pass, equal bit
for bit to the residuals ``hszp_nd.compress`` stores for an unpadded field.
``inv = 1 / (2 eps)`` is computed in f32 exactly as ``core/quantize.py``
does and handed to the kernel (``csrc/quant_lorenzo.cu``) as a device
tensor, so the kernel never divides and the host never reads ``eps``.

Unlike the reference, which refuses shapes that are not a multiple of its
TPU tile (``tile=``), every 2-D shape is accepted, Ocean's 2400 × 3600 and
odd shapes alike.
"""
from __future__ import annotations

import torch

from . import build, ops


def _inv(eps, device) -> torch.Tensor:
    eps = torch.as_tensor(eps, dtype=torch.float32, device=device)
    return (1.0 / (2.0 * eps)).reshape(())


def quant_lorenzo2d_plain(x: torch.Tensor, eps) -> torch.Tensor:
    """Plain version: ``q = round(x · inv)`` (half to even), then
    ``q - q↑ - q← + q↖`` with zeros outside the plane (int32, modular)."""
    q = torch.round(x.to(torch.float32) * _inv(eps, x.device)).to(torch.int32)
    p = q.clone()
    p[1:] -= q[:-1]
    p[:, 1:] -= q[:, :-1]
    p[1:, 1:] += q[:-1, :-1]
    return p


def quant_lorenzo2d(x: torch.Tensor, eps) -> torch.Tensor:
    """Lorenzo residuals of the quantized 2-D field ``x`` (int32)."""
    if not ops.on_card(x, *([eps] if isinstance(eps, torch.Tensor) else [])):
        return quant_lorenzo2d_plain(x, eps)
    return quant_lorenzo_kernel(x, _inv(eps, x.device))


def quant_lorenzo_kernel(x: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """The kernel launch alone, from ``inv = 1 / (2 eps)`` on the card."""
    ops.check(x, "x", torch.float32)
    ops.check(inv, "inv", torch.float32, ())
    if x.ndim != 2 or x.numel() == 0:
        raise ValueError(f"quant_lorenzo2d takes a non-empty 2-D field, got "
                         f"{tuple(x.shape)}")
    if not ops.on_card(x, inv):
        raise ValueError("quant_lorenzo_kernel takes CUDA tensors")
    p = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    build.call("hsz_quant_lorenzo2d", x.data_ptr(), x.shape[0], x.shape[1],
               inv.data_ptr(), p.data_ptr(), ops.stream_ptr())
    ops.count("quant_lorenzo2d")
    return p
