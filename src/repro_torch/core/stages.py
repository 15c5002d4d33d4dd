"""Data containers and stage definitions for the HSZ multi-stage pipeline.

The paper (§III-C, Table I) defines four progressive decompression stages:

    stage 1  D_m  metadata            (block anchors / block means, int)
    stage 2  D_p  decorrelated data   (prediction residuals, int)
    stage 3  D_q  quantized data      (linear-scaling quantization indices, int)
    stage 4  D_f  floating-point data (fully decompressed values)

The device container keeps a dense residual tensor plus per-block bitwidths;
the *encoded* container holds a bit-packed payload at one uniform width.
Payload words are carried as ``int32`` tensors holding the ``uint32`` bit
pattern: torch has no unsigned 32-bit shift, compare or max on every device.
True per-block variable-rate byte streams exist only at the host
serialization boundary (``repro_torch.core.encode.serialize``).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass

import torch


class Stage(enum.IntEnum):
    """Decompression stages, paper Table I."""

    M = 1  # metadata
    P = 2  # decorrelated residuals
    Q = 3  # quantization integers
    F = 4  # floating point


class Scheme(str, enum.Enum):
    """The four compressor instances implemented by the paper (§IV)."""

    HSZP = "hszp"        # 1-D Lorenzo, inter-block chained (paper HSZp)
    HSZP_ND = "hszp_nd"  # n-D Lorenzo (paper HSZp-nd)
    HSZX = "hszx"        # 1-D block-mean predictor (paper HSZx)
    HSZX_ND = "hszx_nd"  # n-D block-mean predictor (paper HSZx-nd)

    @property
    def is_nd(self) -> bool:
        return self in (Scheme.HSZP_ND, Scheme.HSZX_ND)

    @property
    def is_lorenzo(self) -> bool:
        return self in (Scheme.HSZP, Scheme.HSZP_ND)

    @property
    def is_blockmean(self) -> bool:
        return self in (Scheme.HSZX, Scheme.HSZX_ND)


def _prod(xs) -> int:
    size = 1
    for x in xs:
        size *= x
    return size


def _nbytes(*leaves: torch.Tensor) -> int:
    return int(sum(x.numel() * x.element_size() for x in leaves))


class _Layout:
    """Shape helpers shared by both containers."""

    shape: tuple[int, ...]
    padded_shape: tuple[int, ...]
    block: tuple[int, ...]

    @property
    def n(self) -> int:
        """Number of valid (original) elements."""
        return _prod(self.shape)

    @property
    def grid(self) -> tuple[int, ...]:
        return tuple(p // b for p, b in zip(self.padded_shape, self.block))

    @property
    def n_blocks(self) -> int:
        return _prod(self.grid)

    @property
    def block_elems(self) -> int:
        return _prod(self.block)


@dataclass(frozen=True)
class Compressed(_Layout):
    """Device-resident compressed field (information-complete).

    ``residuals`` is D_p in *spatial* layout (padded to block multiples);
    ``metadata`` is D_m: block means for HSZx-family (block-grid layout) or the
    global anchor for HSZp-family (shape ``(1,)``).  ``bitwidths`` is the exact
    per-block fixed-rate code width (bits/value, sign included) used for size
    accounting and serialization; blocks in row-major grid order.
    """

    residuals: torch.Tensor      # int32, spatial padded layout
    metadata: torch.Tensor       # int32
    bitwidths: torch.Tensor      # int32 (n_blocks,)
    eps: torch.Tensor            # f32 scalar: absolute error bound
    valid_counts: torch.Tensor   # int32 (n_blocks,): valid elements per block

    scheme: Scheme
    shape: tuple[int, ...]         # original (unpadded) data shape
    padded_shape: tuple[int, ...]  # residuals.shape
    block: tuple[int, ...]         # block shape (same rank as padded_shape)
    orig_dtype: torch.dtype

    def device_bytes(self) -> int:
        """On-device bytes of every leaf of the decoded container."""
        return _nbytes(self.residuals, self.metadata, self.bitwidths,
                       self.valid_counts, self.eps)


@dataclass(frozen=True)
class Encoded(_Layout):
    """Bit-packed compressed field (stage-0 on-device representation).

    ``payload`` packs zigzag-coded residuals at a *uniform* width ``bits``
    into 32-bit words, held as the ``int32`` bit pattern.  Decoding the
    payload is the stage-2 decompression step.
    """

    payload: torch.Tensor       # int32 bit pattern of uint32 words (n_words,)
    metadata: torch.Tensor      # int32
    bitwidths: torch.Tensor     # int32 (n_blocks,) exact per-block widths
    eps: torch.Tensor           # f32 scalar
    valid_counts: torch.Tensor  # int32 (n_blocks,)

    scheme: Scheme
    shape: tuple[int, ...]
    padded_shape: tuple[int, ...]
    block: tuple[int, ...]
    orig_dtype: torch.dtype
    bits: int                   # uniform packed width (zigzag bits per value)

    def device_bytes(self) -> int:
        """On-device compressed bytes of every leaf."""
        return _nbytes(self.payload, self.metadata, self.bitwidths,
                       self.valid_counts, self.eps)


Field = Compressed | Encoded


def layout_key(c: Field) -> tuple:
    """Hashable static layout of a field: the kind, scheme, shapes, block,
    original dtype and, for :class:`Encoded`, the packed width — everything
    two fields must share for one program to serve both (the reference's
    pytree-meta fields).  The dtype is named by its string (``"float32"``)."""
    key: tuple = (type(c).__name__, c.scheme, c.shape, c.padded_shape,
                  c.block, str(c.orig_dtype).removeprefix("torch."))
    if isinstance(c, Encoded):
        key = key + (c.bits,)
    return key
