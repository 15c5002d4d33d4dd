"""HSZ compression pipeline with multi-stage decompression (paper §IV, Alg. 1-2).

Four compressor instances share one pipeline::

    quantize -> partition -> metadata -> decorrelate -> encode

and decompression stops at any of the four stages (Table I).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..kernels import ops as kernel_ops
from . import blocking, decorrelate, encode, quantize
from .stages import Compressed, Encoded, Scheme, Stage

DEFAULT_BLOCKS = {1: (256,), 2: (16, 16), 3: (8, 8, 8)}


class UnsupportedStageError(NotImplementedError):
    """Raised when an operation is not defined at a decompression stage

    (e.g. stage-① mean for HSZp-family, stage-② stencils for 1-D schemes —
    paper §V-A/§V-B)."""


@dataclass(frozen=True)
class HSZCompressor:
    """One of the paper's four compressors (Table II)."""

    scheme: Scheme
    block: tuple[int, ...] | None = None  # None -> per-rank default

    def _layout(self, shape: tuple[int, ...]) -> tuple[tuple[int, ...], tuple[int, ...]]:
        """(logical working shape, block shape) for this scheme."""
        if self.scheme.is_nd:
            nd = len(shape)
            if nd not in (1, 2, 3):
                raise ValueError(f"nd schemes support 1-3 dims, got {nd}")
            block = self.block or DEFAULT_BLOCKS[nd]
            if len(block) != nd:
                raise ValueError("block rank != data rank")
            return shape, tuple(block)
        # 1-D schemes flatten the data (paper §IV: "treat the original data
        # as a 1D array regardless of their original dimensions")
        n = 1
        for s in shape:
            n *= s
        block = self.block or DEFAULT_BLOCKS[1]
        return (n,), tuple(block)

    # -- compression (Alg. 1) ---------------------------------------------
    def compress(self, data: torch.Tensor | np.ndarray, *,
                 abs_eb: float | None = None, rel_eb: float | None = None,
                 eps: torch.Tensor | float | None = None,
                 device="cuda") -> Compressed:
        """Compress ``data`` on ``device`` (the card unless the caller asks
        for ``"cpu"``)."""
        dev = kernel_ops.resolve_device(device)
        data = torch.as_tensor(data, device=dev)
        orig_shape = tuple(data.shape)
        work_shape, block = self._layout(orig_shape)
        if eps is None:
            eps = quantize.resolve_eps(data, abs_eb=abs_eb, rel_eb=rel_eb)
        eps = torch.as_tensor(eps, dtype=torch.float32, device=dev)
        q = quantize.quantize(data.reshape(work_shape), eps)
        q = blocking.pad_to_blocks(q, block)

        vc = torch.as_tensor(blocking.valid_counts(work_shape, block),
                             device=dev)
        if self.scheme.is_blockmean:
            valid = (torch.as_tensor(blocking.valid_mask(work_shape, block),
                                     device=dev)
                     if blocking.has_padding(work_shape, block) else None)
            means = decorrelate.block_means(q, block, valid=valid)
            residuals = decorrelate.blockmean_decorrelate(q, means, block)
            metadata = means
        else:
            residuals = decorrelate.lorenzo(q)
            # anchor q_0 lives in residuals
            metadata = torch.zeros((1,), dtype=torch.int32, device=dev)

        bitwidths = encode.bitwidth_per_block(residuals, block)
        return Compressed(
            residuals=residuals, metadata=metadata, bitwidths=bitwidths,
            eps=eps, valid_counts=vc, scheme=self.scheme, shape=orig_shape,
            padded_shape=tuple(residuals.shape), block=block,
            orig_dtype=data.dtype,
        )

    # -- multi-stage decompression (Alg. 2) --------------------------------
    def reconstruct_q(self, c: Compressed) -> torch.Tensor:
        """Stage ③: recorrelate residuals back to quantization indices (padded)."""
        if c.scheme.is_blockmean:
            return decorrelate.blockmean_recorrelate(c.residuals, c.metadata,
                                                     c.block)
        return decorrelate.unlorenzo(c.residuals)

    def decompress(self, c: Compressed | Encoded, stage: Stage = Stage.F, *,
                   crop: bool = True):
        """Return the intermediate representation at ``stage`` (paper Alg. 2)."""
        if isinstance(c, Encoded) and stage != Stage.M:
            c = encode.decode_device(c)
        if stage == Stage.M:
            return c.metadata
        if stage == Stage.P:
            return c.residuals
        q = self.reconstruct_q(c)
        if stage == Stage.Q:
            return self._restore(q, c) if crop else q
        d = quantize.dequantize(q, c.eps, dtype=c.orig_dtype)
        return self._restore(d, c) if crop else d

    def _restore(self, x: torch.Tensor, c: Compressed) -> torch.Tensor:
        """Crop padding and restore the original (pre-flatten) shape."""
        if self.scheme.is_nd:
            return blocking.crop(x, c.shape)
        return x.reshape(-1)[:c.n].reshape(c.shape)

    # -- encoding ----------------------------------------------------------
    def max_bits(self, c: Compressed) -> int:
        """Exact max per-block width as a Python int (one host read)."""
        return int(c.bitwidths.max().item())

    def encode(self, c: Compressed, bits: int | None = None) -> Encoded:
        """Bit-pack at uniform width; ``bits=None`` reads the exact max width
        from the device for a lossless container."""
        if bits is None:
            bits = self.max_bits(c)
        return encode.encode_device(c, bits)

    # -- accounting ---------------------------------------------------------
    def serialized_bits(self, c: Compressed | Encoded) -> torch.Tensor:
        # HSZx-family stores a 32-bit mean per block; HSZp-family serializes
        # one global 32-bit anchor slot (see `encode.serialize`)
        meta_bits = 32 if self.scheme.is_blockmean else 0
        global_bits = 0 if self.scheme.is_blockmean else 32
        return encode.serialized_bits(c.bitwidths, c.valid_counts,
                                      meta_bits_per_block=meta_bits,
                                      global_meta_bits=global_bits)

    def compression_ratio(self, c: Compressed | Encoded) -> torch.Tensor:
        # float: n*32 overflows int32 for fields >= 2^26 elements
        return float(c.n) * 32.0 / self.serialized_bits(c)


# the paper's four instances (Table II)
hszp = HSZCompressor(Scheme.HSZP)
hszp_nd = HSZCompressor(Scheme.HSZP_ND)
hszx = HSZCompressor(Scheme.HSZX)
hszx_nd = HSZCompressor(Scheme.HSZX_ND)

_BY_NAME = {"hszp": hszp, "hszp_nd": hszp_nd, "hszx": hszx, "hszx_nd": hszx_nd}


def by_name(name: str, block: tuple[int, ...] | None = None) -> HSZCompressor:
    base = _BY_NAME[name]
    return HSZCompressor(base.scheme, block) if block is not None else base
