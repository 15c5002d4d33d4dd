"""Uniform-width bitplane pack and unpack: the Hopper kernels and their plain
versions.

Counterparts of ``repro/kernels/bitpack.py:pack`` and ``:unpack``.  Payload
words are ``int32`` tensors holding the ``uint32`` bit pattern, and zigzag
values are int32 bit patterns too.  :func:`unpack_residuals` is the decode's
unpack: the same kernel with the unzigzag applied in registers, so the
residuals come out of one launch.  Every length ``n`` is accepted, as in the
reference.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ops

_WORD_MASK = 0xFFFFFFFF


def pack_plain(u: torch.Tensor, bits: int) -> torch.Tensor:
    """Plain version of :func:`pack`: the port's XLA-style packer
    ``core.encode.pack_uniform``, as the reference's oracle
    (``repro/kernels/ref.py:pack_uniform``) is its ``encode.pack_uniform``."""
    from ..core import encode  # core.encode imports this module

    return encode.pack_uniform(u, bits)


def pack(u: torch.Tensor, bits: int) -> torch.Tensor:
    """``ceil(n·bits/32)`` words holding ``n`` zigzag values, each masked to
    its low ``bits`` bits, at bit offset ``i·bits``.

    A CUDA tensor launches the Hopper kernel (``csrc/pack.cu``) for widths
    1..31; widths 0 and 32 are fast paths without a kernel, as in the
    reference.  A CPU tensor takes :func:`pack_plain`.
    """
    if not ops.on_card(u) or bits in (0, 32):
        return pack_plain(u, bits)
    if not 0 < bits < 32:
        raise ValueError(f"pack takes widths 0..32, got {bits}")
    ops.check(u, "values", torch.int32)
    if u.ndim != 1:
        raise ValueError(f"pack takes a flat tensor, got {tuple(u.shape)}")
    n = u.shape[0]
    n_words = -(-(n * bits) // 32)
    words = torch.empty((n_words,), dtype=torch.int32, device=u.device)
    if n_words:
        build.call("hsz_pack", u.data_ptr(), n, words.data_ptr(), n_words,
                   bits, ops.stream_ptr())
        ops.count("pack")
    return words


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


def _launch(payload: torch.Tensor, n: int, bits: int, residuals: bool,
            site: str) -> torch.Tensor:
    """Launch ``csrc/unpack.cu`` on a CUDA payload (widths 1..31)."""
    ops.check(payload, "payload", torch.int32)
    n_words = payload.shape[0]
    if n_words * 32 < n * bits:
        raise ValueError(f"payload of {n_words} words holds fewer than "
                         f"{n} values at {bits} bits")
    out = torch.empty((n,), dtype=torch.int32, device=payload.device)
    build.call("hsz_unpack", payload.data_ptr(), n_words, out.data_ptr(), n,
               bits, int(residuals), ops.stream_ptr())
    ops.count(site)
    return out


def unpack(payload: torch.Tensor, n: int, bits: int) -> torch.Tensor:
    """``n`` zigzag values from a uniform-width payload.

    A CUDA payload launches the Hopper kernel (``csrc/unpack.cu``) for widths
    1..31; widths 0 and 32 are fast paths without a kernel, as in the
    reference.  A CPU payload takes :func:`unpack_plain`.
    """
    if not ops.on_card(payload) or bits in (0, 32):
        return unpack_plain(payload, n, bits)
    return _launch(payload, n, bits, False, "unpack")


def unpack_residuals_plain(payload: torch.Tensor, n: int,
                           bits: int) -> torch.Tensor:
    """Plain version of :func:`unpack_residuals`: ``encode.unzigzag`` of
    :func:`unpack_plain`."""
    from ..core import encode  # core.encode imports this module

    return encode.unzigzag(unpack_plain(payload, n, bits))


def unpack_residuals(payload: torch.Tensor, n: int, bits: int) -> torch.Tensor:
    """``n`` residuals (unzigzagged values) from a uniform-width payload: the
    decode of an ``Encoded`` field.

    A CUDA payload launches the Hopper kernel with the unzigzag fused in
    (``csrc/unpack.cu``, ``unpack_kernel<true>``) for widths 1..31; widths 0
    and 32 take :func:`unpack_residuals_plain` without a kernel, as
    :func:`unpack` does.  A CPU payload takes :func:`unpack_residuals_plain`.
    """
    if not ops.on_card(payload) or bits in (0, 32):
        return unpack_residuals_plain(payload, n, bits)
    return _launch(payload, n, bits, True, "unpack.residuals")


def unpack_config(residuals: bool) -> tuple[int, int, int]:
    """(shared memory in bytes at 31 bits, registers per thread, resident
    blocks per SM) of one unpack instantiation, read from the library."""
    smem, regs, per_sm = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    build.call("hsz_unpack_info", int(residuals), ctypes.addressof(smem),
               ctypes.addressof(regs), ctypes.addressof(per_sm))
    return smem.value, regs.value, per_sm.value
