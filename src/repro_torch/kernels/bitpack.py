"""Uniform-width bitplane unpack: the Hopper kernel and its plain version.

Counterpart of ``repro/kernels/bitpack.py:unpack``.  Payload words are
``int32`` tensors holding the ``uint32`` bit pattern; the result is ``n``
zigzag values, also as int32 bit patterns (``encode.unzigzag`` follows).
"""
from __future__ import annotations

import torch

from . import build, ops

_WORD_MASK = 0xFFFFFFFF


def unpack_plain(payload: torch.Tensor, n: int, bits: int) -> torch.Tensor:
    """Plain PyTorch unpack — the reference's ``encode.unpack_uniform``
    arithmetic in int64 (exact 32-bit shifts on every device)."""
    dev = payload.device
    if bits == 0:
        return torch.zeros((n,), dtype=torch.int32, device=dev)
    if bits == 32:
        return payload[:n].clone()
    mask = (1 << bits) - 1
    offs = torch.arange(n, dtype=torch.int64, device=dev) * bits
    widx = offs >> 5
    shift = offs & 31
    pad = torch.cat([payload.to(torch.int64) & _WORD_MASK,
                     torch.zeros((1,), dtype=torch.int64, device=dev)])
    lo = pad[widx] >> shift
    carry = shift > 32 - bits
    hi = torch.where(carry, (pad[widx + 1] << (32 - shift)) & _WORD_MASK, 0)
    return ((lo | hi) & mask).to(torch.int32)


def unpack(payload: torch.Tensor, n: int, bits: int) -> torch.Tensor:
    """``n`` zigzag values from a uniform-width payload.

    A CUDA payload launches the Hopper kernel (``csrc/unpack.cu``) for widths
    1..31; widths 0 and 32 are fast paths without a kernel, as in the
    reference.  A CPU payload takes :func:`unpack_plain`.
    """
    if not ops.on_card(payload):
        return unpack_plain(payload, n, bits)
    if bits in (0, 32):
        return unpack_plain(payload, n, bits)
    ops.check(payload, "payload", torch.int32)
    n_words = payload.shape[0]
    if n_words * 32 < n * bits:
        raise ValueError(f"payload of {n_words} words holds fewer than "
                         f"{n} values at {bits} bits")
    out = torch.empty((n,), dtype=torch.int32, device=payload.device)
    build.call("hsz_unpack", payload.data_ptr(), n_words, out.data_ptr(), n,
               bits, ops.stream_ptr())
    ops.count("unpack")
    return out
