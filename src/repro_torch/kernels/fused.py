"""Fused recorrelation + stencil planes for 2-D fields: Hopper kernels and
their plain versions.

Counterparts of ``repro/kernels/fused.py``: ``lorenzo2d`` /
``lorenzo_enc2d`` (Lorenzo family) and ``blockmean2d`` / ``blockmean_enc2d``
(block-mean family).  The ``*_enc2d`` variants take the packed payload and
unpack it inside the kernel, so the residual plane never exists in device
memory; the others take a decoded int32 residual plane.  Every output is a
full padded-shape plane whose boundary rows and columns are don't-care (the
lowering rules in ``repro_torch.core.fused`` slice the interior and apply
the float tail).

A CUDA input launches the kernels in ``csrc/lorenzo_band.cu`` /
``csrc/blockmean_band.cu``; a CPU input takes the plain version, the
reference's band bodies (``_lorenzo_core`` / ``_blockmean_core``) written
over the whole plane with zero neighbours outside it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import bitpack, build, ops

LORENZO_WHATS = ("deriv0", "deriv1", "grad", "lap")
BLOCKMEAN_WHATS = ("deriv0", "deriv1", "grad", "lap_p", "lap_q")
_LZ_CODE = {w: i for i, w in enumerate(LORENZO_WHATS)}
_BM_CODE = {w: i for i, w in enumerate(BLOCKMEAN_WHATS)}


def _unzigzag(u: torch.Tensor) -> torch.Tensor:
    return (u >> 1) ^ -(u & 1)


def _next(x: torch.Tensor, axis: int) -> torch.Tensor:
    """``x[i+1]`` along ``axis``, 0 past the last element."""
    out = torch.zeros_like(x)
    n = x.shape[axis]
    out.narrow(axis, 0, n - 1).copy_(x.narrow(axis, 1, n - 1))
    return out


def _prev(x: torch.Tensor, axis: int) -> torch.Tensor:
    """``x[i-1]`` along ``axis``, 0 before the first element."""
    out = torch.zeros_like(x)
    n = x.shape[axis]
    out.narrow(axis, 1, n - 1).copy_(x.narrow(axis, 0, n - 1))
    return out


def _payload_plane(payload: torch.Tensor, shape: tuple, bits: int) -> torch.Tensor:
    n0, n1 = shape
    return _unzigzag(bitpack.unpack_plain(payload, n0 * n1, bits)).reshape(n0, n1)


def _check_what(what: str, whats: tuple) -> None:
    if what not in whats:
        raise ValueError(f"what={what!r}: expected one of {whats}")


def _check_payload(payload: torch.Tensor, shape: tuple, bits: int) -> None:
    ops.check(payload, "payload", torch.int32)
    if not 0 < bits < 32:
        raise ValueError(f"payload kernels take widths 1..31, got {bits}")
    if payload.ndim != 1 or payload.shape[0] * 32 < shape[0] * shape[1] * bits:
        raise ValueError(f"payload of shape {tuple(payload.shape)} is too "
                         f"short for a {shape} plane at {bits} bits")


def _outputs(shape: tuple, n_out: int, dtype, device) -> list[torch.Tensor]:
    return [torch.empty(shape, dtype=dtype, device=device) for _ in range(n_out)]


def _result(outs: list[torch.Tensor]):
    return tuple(outs) if len(outs) > 1 else outs[0]


# ---------------------------------------------------------------------------
# Lorenzo family
# ---------------------------------------------------------------------------

def lorenzo_core(p: torch.Tensor, what: str):
    """Plain version: D0 = cumsum(p, 1), D1 = cumsum(p, 0) (int32, modular;
    D0 = 0 below the last row, D1 = 0 right of the last column), then
    ``deriv0`` = D0[+1] + D0, ``deriv1`` = D1[+1] + D1, ``grad`` = both,
    ``lap`` = (D0[+1] - D0) + (D1[+1] - D1) — ``_lorenzo_core`` over the
    whole plane."""
    _check_what(what, LORENZO_WHATS)
    outs = []
    if what in ("deriv0", "grad", "lap"):
        d0 = torch.cumsum(p, dim=1, dtype=torch.int32)
        d0n = _next(d0, 0)
    if what in ("deriv1", "grad", "lap"):
        d1 = torch.cumsum(p, dim=0, dtype=torch.int32)
        d1n = _next(d1, 1)
    if what in ("deriv0", "grad"):
        outs.append(d0n + d0)
    if what in ("deriv1", "grad"):
        outs.append(d1n + d1)
    if what == "lap":
        outs.append((d0n - d0) + (d1n - d1))
    return _result(outs)


@functools.cache
def lorenzo_tile() -> tuple[int, int]:
    """(rows, columns) of the Lorenzo kernels' tiles, read from the library
    once."""
    th, tw = ctypes.c_int(), ctypes.c_int()
    build.call("hsz_lorenzo_tile", ctypes.addressof(th), ctypes.addressof(tw))
    return th.value, tw.value


def lorenzo_launch_config(from_payload: bool, what: str | None):
    """(static shared memory in bytes, registers per thread, resident blocks
    per SM) of the edge pass (``what=None``) or of the stencil pass launched
    for ``what``, read from the library."""
    smem, regs, per_sm = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    build.call("hsz_lorenzo_info", int(from_payload),
               -1 if what is None else _LZ_CODE[what], ctypes.addressof(smem),
               ctypes.addressof(regs), ctypes.addressof(per_sm))
    return smem.value, regs.value, per_sm.value


def lorenzo_edges_plain(p: torch.Tensor, tile: tuple[int, int]):
    """Per-tile row sums ``(n0, n_ct)`` and column sums ``(n_rt, n1)`` of
    ``p`` (int32, modular)."""
    n0, n1 = p.shape
    th, tw = tile
    n_rt, n_ct = -(-n0 // th), -(-n1 // tw)
    padded = torch.zeros((n_rt * th, n_ct * tw), dtype=torch.int64,
                         device=p.device)
    padded[:n0, :n1] = p
    rowsum = padded[:n0].reshape(n0, n_ct, tw).sum(2).to(torch.int32)
    colsum = padded[:, :n1].reshape(n_rt, th, n1).sum(1).to(torch.int32)
    return rowsum, colsum


def exclusive_prefix(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Exclusive int32 prefix sum along ``dim`` (modular)."""
    return torch.cumsum(x, dim=dim, dtype=torch.int32) - x


def lorenzo_edge_prefixes_plain(p: torch.Tensor, tile: tuple[int, int]):
    """Plain version of the edge pass: the row edge ``(n0, n_ct)`` (sum of
    ``p`` left of each tile, per row) and the column edge ``(n_rt, n1)`` (sum
    of ``p`` above each tile, per column), int32, modular."""
    rowsum, colsum = lorenzo_edges_plain(p, tile)
    return exclusive_prefix(rowsum, 1), exclusive_prefix(colsum, 0)


def lorenzo_edges(src: torch.Tensor, shape: tuple, bits: int, *,
                  from_payload: bool, site: str,
                  corners: torch.Tensor | None = None):
    """Edge pass (kernels): the row and column edges of
    :func:`lorenzo_edge_prefixes_plain`, from payload words or from the
    residual plane: the per-tile sums, then their prefixes, on the card.
    With ``corners`` (``(n_rt, ceil(n1/cols))`` int32, ``prefix_stats2d``,
    ``cols`` from :func:`prefix_stats.corner_cols`) the prefix kernel also
    writes the column edge summed over each ``cols`` columns there."""
    n0, n1 = shape
    th, tw = lorenzo_tile()
    n_rt, n_ct = -(-n0 // th), -(-n1 // tw)
    rowedge = torch.empty((n0, n_ct), dtype=torch.int32, device=src.device)
    coledge = torch.empty((n_rt, n1), dtype=torch.int32, device=src.device)
    build.call("hsz_lorenzo_edges", int(from_payload), src.data_ptr(),
               src.shape[0] if from_payload else 0, bits, n0, n1,
               rowedge.data_ptr(), coledge.data_ptr(),
               None if corners is None else corners.data_ptr(),
               ops.stream_ptr())
    ops.count(f"{site}.edges")
    return rowedge, coledge


def lorenzo_stencil(src: torch.Tensor, shape: tuple, bits: int,
                    rowedge: torch.Tensor, coledge: torch.Tensor, what: str, *,
                    from_payload: bool, site: str):
    """Stencil pass (kernel): D0 and D1 of each tile from its edges, the
    requested int32 planes."""
    n_out = 2 if what == "grad" else 1
    outs = _outputs(tuple(shape), n_out, torch.int32, src.device)
    build.call("hsz_lorenzo_stencil", int(from_payload), src.data_ptr(),
               src.shape[0] if from_payload else 0, bits, shape[0], shape[1],
               rowedge.data_ptr(), coledge.data_ptr(), _LZ_CODE[what],
               outs[0].data_ptr(), outs[-1].data_ptr() if n_out > 1 else None,
               ops.stream_ptr())
    ops.count(f"{site}.stencil")
    return _result(outs)


def _lorenzo_kernels(src, shape, bits, what, *, from_payload, site):
    edges = lorenzo_edges(src, shape, bits, from_payload=from_payload,
                          site=site)
    return lorenzo_stencil(src, shape, bits, *edges, what,
                           from_payload=from_payload, site=site)


def lorenzo2d(p: torch.Tensor, *, what: str):
    """Fused Lorenzo recorrelation + integer stencil over a 2-D residual
    plane: ``deriv0`` / ``deriv1`` (one int32 plane), ``grad`` (both), ``lap``."""
    _check_what(what, LORENZO_WHATS)
    if not ops.on_card(p):
        return lorenzo_core(p, what)
    ops.check(p, "residuals", torch.int32)
    if p.ndim != 2:
        raise ValueError(f"lorenzo2d takes a 2-D plane, got {tuple(p.shape)}")
    return _lorenzo_kernels(p, tuple(p.shape), 0, what, from_payload=False,
                            site="lorenzo2d")


def lorenzo_enc2d_plain(payload: torch.Tensor, shape: tuple, bits: int, *,
                        what: str):
    return lorenzo_core(_payload_plane(payload, shape, bits), what)


def lorenzo_enc2d(payload: torch.Tensor, shape: tuple, bits: int, *,
                  what: str):
    """Single-pass decode + Lorenzo stencil from the packed payload
    (widths 1..31); bit-identical to ``decode_device`` + :func:`lorenzo2d`."""
    _check_what(what, LORENZO_WHATS)
    if not ops.on_card(payload):
        return lorenzo_enc2d_plain(payload, shape, bits, what=what)
    _check_payload(payload, shape, bits)
    return _lorenzo_kernels(payload, tuple(shape), bits, what,
                            from_payload=True, site="lorenzo_enc2d")


# ---------------------------------------------------------------------------
# block-mean family
# ---------------------------------------------------------------------------

def _lap5(c, dn, up, right, left) -> torch.Tensor:
    # exact reference order: -2*nd*c, then +hi, +lo per axis
    acc = c.to(torch.float32) * -4.0
    acc = acc + dn.to(torch.float32)
    acc = acc + up.to(torch.float32)
    acc = acc + right.to(torch.float32)
    return acc + left.to(torch.float32)


def blockmean_core(p: torch.Tensor, meta: torch.Tensor, block: tuple, what: str):
    """Plain version: upsample the block means and emit ``deriv0`` /
    ``deriv1`` / ``grad`` (int32) or ``lap_p`` / ``lap_q`` (f32) — the
    reference's ``_blockmean_core`` over the whole plane, neighbours outside
    the plane read as 0."""
    _check_what(what, BLOCKMEAN_WHATS)
    b0, b1 = block
    m = torch.repeat_interleave(torch.repeat_interleave(meta, b0, dim=0),
                                b1, dim=1)
    p_up, p_dn, m_up, m_dn = _prev(p, 0), _next(p, 0), _prev(m, 0), _next(m, 0)
    p_l, p_r, m_l, m_r = _prev(p, 1), _next(p, 1), _prev(m, 1), _next(m, 1)
    outs = []
    if what in ("deriv0", "grad"):
        outs.append((p_dn - p_up) + (m_dn - m_up))
    if what in ("deriv1", "grad"):
        outs.append((p_r - p_l) + (m_r - m_l))
    if what == "lap_p":
        outs.append(_lap5(p, p_dn, p_up, p_r, p_l) + _lap5(m, m_dn, m_up, m_r, m_l))
    if what == "lap_q":
        outs.append(_lap5(p + m, p_dn + m_dn, p_up + m_up, p_r + m_r, p_l + m_l))
    return _result(outs)


def blockmean_launch_config(from_payload: bool, what: str) -> tuple[int, int]:
    """(dynamic shared memory in bytes, resident blocks per SM) of the
    block-mean kernel launched for ``what``, read from the library."""
    smem, per_sm = ctypes.c_int(), ctypes.c_int()
    build.call("hsz_blockmean_info", int(from_payload), _BM_CODE[what],
               ctypes.addressof(smem), ctypes.addressof(per_sm))
    return smem.value, per_sm.value


def _blockmean_kernel(src, meta, shape, block, bits, what, *, from_payload,
                      site):
    n0, n1 = shape
    b0, b1 = block
    if n0 % b0 or n1 % b1:
        raise ValueError(f"plane {shape} is not a multiple of block {block}")
    ops.check(meta, "metadata", torch.int32, (n0 // b0, n1 // b1))
    n_out = 2 if what == "grad" else 1
    dtype = torch.float32 if what in ("lap_p", "lap_q") else torch.int32
    outs = _outputs(tuple(shape), n_out, dtype, src.device)
    build.call("hsz_blockmean", int(from_payload), src.data_ptr(),
               src.shape[0] if from_payload else 0, bits, n0, n1,
               meta.data_ptr(), b0, b1, _BM_CODE[what], outs[0].data_ptr(),
               outs[-1].data_ptr() if n_out > 1 else None, ops.stream_ptr())
    ops.count(site)
    return _result(outs)


def blockmean2d(p: torch.Tensor, meta: torch.Tensor, block: tuple, *,
                what: str):
    """Fused block-mean upsample + stencil over a 2-D residual plane."""
    _check_what(what, BLOCKMEAN_WHATS)
    if not ops.on_card(p, meta):
        return blockmean_core(p, meta, block, what)
    ops.check(p, "residuals", torch.int32)
    if p.ndim != 2:
        raise ValueError(f"blockmean2d takes a 2-D plane, got {tuple(p.shape)}")
    return _blockmean_kernel(p, meta, tuple(p.shape), tuple(block), 0, what,
                             from_payload=False, site="blockmean2d")


def blockmean_enc2d_plain(payload: torch.Tensor, meta: torch.Tensor,
                          shape: tuple, block: tuple, bits: int, *, what: str):
    return blockmean_core(_payload_plane(payload, shape, bits), meta, block,
                          what)


def blockmean_enc2d(payload: torch.Tensor, meta: torch.Tensor, shape: tuple,
                    block: tuple, bits: int, *, what: str):
    """Single-pass decode + block-mean stencil from the packed payload
    (widths 1..31); bit-identical to ``decode_device`` + :func:`blockmean2d`."""
    _check_what(what, BLOCKMEAN_WHATS)
    if not ops.on_card(payload, meta):
        return blockmean_enc2d_plain(payload, meta, shape, block, bits,
                                     what=what)
    _check_payload(payload, shape, bits)
    return _blockmean_kernel(payload, meta, tuple(shape), tuple(block), bits,
                             what, from_payload=True, site="blockmean_enc2d")
