"""Blockwise fixed-rate encoding (paper §IV "Encoding").

The encoder records, per block, the bits needed for the largest zigzag value
``u = (p << 1) ^ (p >> 31)`` — the paper's magnitude bits + 1 sign bit.

* **Device packer** (`pack_uniform` / `unpack_uniform`): packs at one
  *uniform* width into 32-bit words.  Words travel as ``int32`` tensors
  holding the ``uint32`` bit pattern; the packer works in int64, where every
  shift and compare of a 32-bit value is exact on every device.
* **Host serializer** (`serialize` / `deserialize`): exact per-block
  variable-rate byte stream (the paper's storage format), numpy on the host,
  byte-identical to the reference package's ``HSZ2`` blobs.
"""
from __future__ import annotations

import struct

import numpy as np
import torch

from ..kernels import bitpack
from ..kernels import ops as kernel_ops
from . import blocking
from .stages import Compressed, Encoded, Scheme

# v2: padding values are stored at width 0 (stream length == the valid-only
# `serialized_bits` accounting); v1 blobs must be rejected.
_MAGIC = b"HSZ2"

_WORD_MASK = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# zigzag and 32-bit words as int32 bit patterns
# ---------------------------------------------------------------------------

def zigzag(p: torch.Tensor) -> torch.Tensor:
    """Signed int32 -> zigzag value, returned as its int32 bit pattern."""
    return (p << 1) ^ (p >> 31)


def unzigzag(u: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`zigzag` on int32 bit patterns (arithmetic shift,
    exactly the reference's ``(ui >> 1) ^ -(ui & 1)``)."""
    return (u >> 1) ^ -(u & 1)


def as_unsigned(words: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their uint32 values, as int64."""
    return words.to(torch.int64) & _WORD_MASK


def as_bit_pattern(values: torch.Tensor) -> torch.Tensor:
    """int64 values in ``[0, 2^32)`` -> int32 bit patterns."""
    return torch.where(values >= 2 ** 31, values - 2 ** 32,
                       values).to(torch.int32)


# ---------------------------------------------------------------------------
# per-block exact bitwidths (size accounting / serialization)
# ---------------------------------------------------------------------------

def bitwidth_per_block(residuals: torch.Tensor,
                       block: tuple[int, ...]) -> torch.Tensor:
    """Exact fixed-rate width (bits/value, sign incl.) per block, grid order."""
    u = as_unsigned(zigzag(residuals))
    blocked = blocking.to_blocked(u, block)
    nd = len(block)
    maxu = blocked.amax(dim=tuple(range(nd, 2 * nd)))
    # bit length = 32 - clz: frexp's exponent of an exactly representable
    # integer (< 2^53 in f64); 0 -> 0, the constant-block fast path
    _, bw = torch.frexp(maxu.to(torch.float64))
    return bw.reshape(-1).to(torch.int32)


def serialized_bits(bitwidths: torch.Tensor, valid_counts: torch.Tensor, *,
                    meta_bits_per_block: int,
                    global_meta_bits: int = 0) -> torch.Tensor:
    """Exact serialized size in bits: payload + per-block header + metadata.

    Per-block header = 6-bit width field (packed to a byte in `serialize`)
    + per-block scheme metadata (32-bit block mean for HSZx-family, 0 for
    HSZp-family); ``global_meta_bits`` is the HSZp-family anchor slot.  The
    payload sum accumulates in f32 (int32 overflows past 2^31 payload bits).
    """
    payload = (bitwidths * valid_counts).to(torch.float32).sum()
    header = bitwidths.shape[0] * (8 + meta_bits_per_block)
    return payload + header + global_meta_bits + 8 * 64  # + fixed global header


# ---------------------------------------------------------------------------
# device packer: uniform width
# ---------------------------------------------------------------------------

def words_for(n_values: int, bits: int) -> int:
    return -(-(n_values * bits) // 32) if bits > 0 else 0


def pack_uniform(u_flat: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack ``n`` zigzag values (int32 patterns) at width ``bits`` into words.

    Each value lands at bit offset ``i*bits`` (int64: no wrap at 2^32 bits);
    its (<=2) word contributions are scatter-summed with ``index_add_``.
    Fixed-rate => bit ranges are disjoint => sum == bitwise-or, and integer
    addition is exact in any order, so the result is deterministic.
    """
    n = u_flat.shape[0]
    dev = u_flat.device
    if bits == 0:
        return torch.zeros((0,), dtype=torch.int32, device=dev)
    if bits == 32:
        return u_flat.to(torch.int32)
    nw = words_for(n, bits)
    u = as_unsigned(u_flat) & ((1 << bits) - 1)
    offs = torch.arange(n, dtype=torch.int64, device=dev) * bits
    widx = offs >> 5
    shift = offs & 31
    low = (u << shift) & _WORD_MASK
    carry = shift > 32 - bits  # spills into the next word?
    high = torch.where(carry, u >> (32 - shift), 0)
    out = torch.zeros((nw + 1,), dtype=torch.int64, device=dev)
    out.index_add_(0, widx, low)
    out.index_add_(0, widx + 1, high)
    return as_bit_pattern(out[:nw])


#: inverse of :func:`pack_uniform` — the plain version of the unpack kernel,
#: kept beside the kernel in ``repro_torch.kernels.bitpack``.
unpack_uniform = bitpack.unpack_plain


def encode_device(c: Compressed, bits: int) -> Encoded:
    """Bit-pack a :class:`Compressed` field at uniform width ``bits``.

    Residuals wider than ``bits`` saturate in zigzag space; callers choose
    ``bits`` >= max bitwidth (host-read) for losslessness.
    """
    u = zigzag(c.residuals.reshape(-1))
    if bits < 32:
        u = as_unsigned(u).clamp_(max=(1 << bits) - 1).to(torch.int32)
    # torch packer, not the pack kernel (kernels.bitpack.pack): the
    # reference's encode_device likewise packs with its XLA pack_uniform and
    # leaves the Pallas pack to its kernel entry point
    payload = pack_uniform(u, bits)
    return Encoded(
        payload=payload, metadata=c.metadata, bitwidths=c.bitwidths, eps=c.eps,
        valid_counts=c.valid_counts, scheme=c.scheme, shape=c.shape,
        padded_shape=c.padded_shape, block=c.block, orig_dtype=c.orig_dtype,
        bits=bits,
    )


def decode_device(e: Encoded) -> Compressed:
    """Stage-2 decode: unpack the payload back to residuals (D_p).

    ``kernels.bitpack.unpack_residuals`` unpacks and unzigzags in one
    launch of the bitplane kernel for a CUDA payload, and runs its plain
    version (``unzigzag`` of the plain unpack) for a CPU one; both recover
    the exact packed integers.
    """
    n = 1
    for s in e.padded_shape:
        n *= s
    residuals = bitpack.unpack_residuals(e.payload, n, e.bits).reshape(
        e.padded_shape)
    return Compressed(
        residuals=residuals, metadata=e.metadata, bitwidths=e.bitwidths,
        eps=e.eps, valid_counts=e.valid_counts, scheme=e.scheme,
        shape=e.shape, padded_shape=e.padded_shape, block=e.block,
        orig_dtype=e.orig_dtype,
    )


# ---------------------------------------------------------------------------
# region path: gather-unpack only the words covering a block subset
# ---------------------------------------------------------------------------

def unpack_gather(payload: torch.Tensor, *, word_idx=None, pos0, pos1, shift,
                  bits: int) -> torch.Tensor:
    """Unpack a *subset* of a uniform-width payload through word gathers.

    ``word_idx`` selects the only payload words read; ``pos0``/``pos1``/
    ``shift`` (from ``RegionPlan.device_gather``) address each requested
    value's low/high word within that gathered set.  Cost scales with the
    gathered words, not the field.  ``word_idx=None`` means ``payload`` *is*
    the gathered word set already.  Torch ops, as the reference's XLA ops:
    each value's two words form one int64 window, so every shift is exact,
    and the result is the zigzag values' int32 bit patterns.
    """
    dev = payload.device

    def index(a) -> torch.Tensor:  # host arrays (tests) arrive as int64
        if isinstance(a, torch.Tensor):
            return a
        return torch.as_tensor(np.asarray(a, np.int64), device=dev)

    pos0, pos1, shift = index(pos0), index(pos1), index(shift)
    m = pos0.shape[0]
    if bits == 0:
        return torch.zeros((m,), dtype=torch.int32, device=dev)
    mask = _WORD_MASK if bits == 32 else (1 << bits) - 1
    gathered = payload if word_idx is None else payload.index_select(
        0, index(word_idx))
    words = torch.cat([gathered, gathered.new_zeros((1,))])
    # a value's <= 2 words as one 64-bit window: (w0 | w1 << 32) >> shift,
    # masked, is the reference's (w0 >> shift | carry ? w1 << 32 - shift : 0)
    # & mask — w1's bits land at or above bit 32 - shift, which is >= bits
    # unless the value spills into w1
    lo = words.index_select(0, pos0).to(torch.int64) & _WORD_MASK
    hi = words.index_select(0, pos1).to(torch.int64) << 32
    u = ((lo | hi) >> shift) & mask
    return as_bit_pattern(u) if bits == 32 else u.to(torch.int32)


def decode_region(e: Encoded, plan, words: torch.Tensor | None = None
                  ) -> Compressed:
    """Region path: stage-2 decode of only ``plan``'s gathered blocks.

    ``plan`` is a :class:`repro_torch.core.region.RegionPlan`; the result is
    the honest sub-field over the gathered blocks (metadata / bitwidths /
    valid counts restricted to them), never the full residual array.
    ``words`` optionally holds the plan's gathered payload words already
    (``compute(..., payload_words=)``); the decode is then the same
    unpack -> unzigzag -> assemble sequence on them.
    """
    src = e.payload if words is None else words
    gi = plan.device_gather(e.bits, src.device)
    u = unpack_gather(src, word_idx=gi.word_idx if words is None else None,
                      pos0=gi.pos0, pos1=gi.pos1, shift=gi.shift, bits=e.bits)
    residuals = unzigzag(u).reshape(plan.sub_padded_shape)
    return plan.assemble(residuals, e)


# ---------------------------------------------------------------------------
# host serializer: exact per-block variable rate (the paper's storage format)
# ---------------------------------------------------------------------------

def _np_zigzag(p: np.ndarray) -> np.ndarray:
    p = p.astype(np.int32)
    return ((p << 1) ^ (p >> 31)).astype(np.uint32)


def _np_unzigzag(u: np.ndarray) -> np.ndarray:
    ui = u.astype(np.int32)
    return (ui >> 1) ^ -(ui & 1)


def _np_pack_bits(values: np.ndarray, widths_per_value: np.ndarray,
                  total_bits: int) -> np.ndarray:
    """Scatter-pack uint32 ``values`` with per-value ``widths`` into a bitstream."""
    offs = np.zeros(values.shape[0], dtype=np.int64)
    np.cumsum(widths_per_value[:-1], out=offs[1:])
    nw = int(-(-total_bits // 32))
    # +2: zero-width values at the very end of the stream index up to word
    # nw+1 with a zero contribution
    buf = np.zeros(nw + 2, dtype=np.uint64)
    widx = offs >> 5
    shift = (offs & 31).astype(np.uint64)
    v = values.astype(np.uint64)
    np.add.at(buf, widx, v << shift)          # 64-bit shift keeps spill bits
    np.add.at(buf, widx + 1, (v << shift) >> np.uint64(32))
    return (buf & np.uint64(_WORD_MASK)).astype(np.uint32)[:nw]


def _np_unpack_bits(stream: np.ndarray, offs: np.ndarray,
                    widths: np.ndarray) -> np.ndarray:
    """Gather per-value uint32 values with per-value bit offsets/widths."""
    pad = np.concatenate([stream, np.zeros(2, np.uint32)]).astype(np.uint64)
    widx = offs >> 5
    shift = (offs & 31).astype(np.uint64)
    raw = (pad[widx] | (pad[widx + 1] << np.uint64(32))) >> shift
    mask = (np.uint64(1) << widths.astype(np.uint64)) - np.uint64(1)
    return (raw & mask).astype(np.uint32)


_SCHEME_CODE = {Scheme.HSZP: 0, Scheme.HSZP_ND: 1, Scheme.HSZX: 2,
                Scheme.HSZX_ND: 3}
_CODE_SCHEME = {v: k for k, v in _SCHEME_CODE.items()}


def _valid_mask_blocked(shape, block) -> np.ndarray:
    """0/1 per-value validity in blocked (grid-major) order; padding values
    get width 0 in the serialized stream."""
    work_shape = shape if len(shape) == len(block) else (int(np.prod(shape)),)
    mask = blocking.valid_mask(work_shape, block).astype(np.int64)
    return np.ascontiguousarray(blocking.to_blocked(mask, block)).reshape(-1)


def serialize(c: Compressed) -> bytes:
    """Exact per-block fixed-rate byte stream (paper's storage format)."""
    residuals = c.residuals.cpu().numpy()
    bitwidths = c.bitwidths.cpu().numpy().astype(np.uint8)
    metadata = c.metadata.cpu().numpy().astype(np.int32)
    vmask = _valid_mask_blocked(c.shape, c.block)
    widths_per_value_blocked = (
        np.repeat(bitwidths.astype(np.int64), c.block_elems) * vmask)
    blocked = np.ascontiguousarray(
        blocking.to_blocked(residuals.reshape(c.padded_shape), c.block)
    ).reshape(-1)
    ub = _np_zigzag(blocked) * vmask.astype(np.uint32)
    total_bits = int(widths_per_value_blocked.sum())
    stream = _np_pack_bits(ub, widths_per_value_blocked, max(total_bits, 1))

    hdr = struct.pack(
        "<4sBBBdi", _MAGIC, _SCHEME_CODE[c.scheme], len(c.shape), len(c.block),
        float(c.eps.item()), int(c.n_blocks),
    )
    dims = struct.pack(f"<{len(c.shape)}q{len(c.block)}q", *c.shape, *c.block)
    return b"".join([
        hdr, dims,
        bitwidths.tobytes(), metadata.tobytes(),
        np.int64(total_bits).tobytes(), stream.tobytes(),
    ])


def deserialize(data: bytes, *, device="cuda") -> Compressed:
    """Parse an ``HSZ2`` blob into a :class:`Compressed` on ``device``."""
    dev = kernel_ops.resolve_device(device)
    magic, scheme_code, ndim, bdim, eps, n_blocks = struct.unpack_from(
        "<4sBBBdi", data, 0)
    if magic != _MAGIC:
        raise ValueError("not an HSZ stream")
    off = struct.calcsize("<4sBBBdi")
    dims = struct.unpack_from(f"<{ndim + bdim}q", data, off)
    off += 8 * (ndim + bdim)
    shape, block = tuple(dims[:ndim]), tuple(dims[ndim:])
    scheme = _CODE_SCHEME[scheme_code]
    bitwidths = np.frombuffer(data, np.uint8, n_blocks, off).astype(np.int32)
    off += n_blocks
    meta_count = n_blocks if scheme.is_blockmean else 1
    metadata = np.frombuffer(data, np.int32, meta_count, off).copy()
    off += 4 * meta_count
    total_bits = int(np.frombuffer(data, np.int64, 1, off)[0])
    off += 8
    stream = np.frombuffer(data, np.uint32, -(-max(total_bits, 1) // 32), off)

    # 1-D schemes flatten n-D data; recover the blocking work-shape
    work_shape = shape if len(block) == len(shape) else (int(np.prod(shape)),)
    pshape = blocking.padded_shape(work_shape, block)
    block_elems = int(np.prod(block))
    widths = np.repeat(bitwidths.astype(np.int64), block_elems)
    widths *= _valid_mask_blocked(shape, block)
    if total_bits != int(widths.sum()):
        raise ValueError(
            f"corrupt HSZ stream: header claims {total_bits} payload bits, "
            f"metadata implies {int(widths.sum())}")
    offs = np.zeros(widths.shape[0], dtype=np.int64)
    np.cumsum(widths[:-1], out=offs[1:])
    blocked = _np_unzigzag(_np_unpack_bits(stream, offs, widths))
    grid = tuple(p // b for p, b in zip(pshape, block))
    residuals = np.ascontiguousarray(
        blocking.from_blocked(blocked.reshape(grid + block), block))
    vc = blocking.valid_counts(work_shape, block)
    meta = metadata.reshape(grid) if scheme.is_blockmean else metadata

    def put(a):
        return torch.as_tensor(a, device=dev)

    return Compressed(
        residuals=put(residuals), metadata=put(meta), bitwidths=put(bitwidths),
        eps=torch.tensor(eps, dtype=torch.float32, device=dev),
        valid_counts=put(vc), scheme=scheme, shape=shape,
        padded_shape=tuple(pshape), block=block, orig_dtype=torch.float32,
    )
