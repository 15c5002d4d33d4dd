"""Append-only temporal fields: streaming time-slab ingestion (DESIGN.md §9).

Scientific producers (simulations, instruments) emit data as an append-only
stream of timesteps.  A :class:`TemporalField` error-bound-compresses each
appended *time slab* — a batch of timesteps, shape ``(k, *spatial)`` — as an
ordinary field of any of the four schemes, **without re-encoding history**.
All slabs share one quantization grid (``eps`` is resolved at the first
append and pinned), so their stage-③ integers concatenate into one coherent
field, and the temporal operations of :mod:`repro_torch.core.oplib`
(``tdelta``, ``tmean`` / ``tmin`` / ``tmax`` / ``tstd`` over the time axis)
lower as merges of per-slab integer summaries — bit-identical to the same
reduction over the full decompression of the concatenated field, because
every summary leaf is int32 (modular, associative, order-free).

The slabs live on the stream's device (``device="cuda"`` unless the caller
asks for the CPU); an ``Encoded`` slab decodes there through
``kernels.bitpack.unpack_residuals``.  Slabs appended with the same timestep
count encode to the same static layout, so the engine's per-slab summarizer
(``BatchedAnalytics.summarize``) batches them.
"""
from __future__ import annotations
from collections.abc import Sequence

import torch

from ..core import Compressed, Encoded, HSZCompressor, Stage, by_name, oplib
from ..core import quantize
from ..core import region as region_mod
from ..kernels import ops as kernel_ops

Field = Compressed | Encoded

_INT32_MAX = 2**31 - 1


class SummaryCapacityError(RuntimeError):
    """Appending this slab would overflow an int32 TemporalSummary leaf.

    The temporal merges are exact *because* every summary leaf is int32 and
    modular sums stay in range; past the capacity the Σq² (then Σq) leaf
    wraps silently and every downstream ``tstd``/``tmean`` is corrupt.
    Raised *before* the stream is mutated, so the caller can re-shard the
    stream, loosen the error bound (smaller ``|q|``), or open a new
    :class:`TemporalField`.
    """


def summary_capacity(q_abs: int) -> int:
    """Maximum total timesteps an int32 summary holds exactly when every
    quantization index in the stream satisfies ``|q| <= q_abs``.

    The binding leaf is ``Σq²`` (``T * q_abs**2 <= 2**31 - 1``), then
    ``Σq``, then ``count``.
    """
    q_abs = int(q_abs)
    if q_abs < 0:
        raise ValueError(f"negative |q| bound: {q_abs}")
    if q_abs == 0:
        return _INT32_MAX  # all-zero stream: only the count leaf can wrap
    return min(_INT32_MAX // (q_abs * q_abs), _INT32_MAX // q_abs, _INT32_MAX)


def _q_abs(q: torch.Tensor) -> int:
    """max |q| of int32 integers as a Python int (one host read; exact for
    -2^31 too)."""
    lo, hi = torch.aminmax(q)
    return max(-int(lo), int(hi))


class TemporalField:
    """An append-only stream of error-bounded-compressed time slabs.

    Parameters
    ----------
    compressor:
        An :class:`~repro_torch.core.HSZCompressor` (or scheme name) used for
        every slab.
    rel_eb / abs_eb / eps:
        Error-bound policy.  ``eps`` (the absolute quantization step) is
        resolved from the *first* appended slab and then pinned, so every
        slab shares one quantization grid — the precondition for merging
        per-slab integer summaries exactly.
    bits:
        Payload policy: ``"auto"`` (default) bit-packs each slab at the
        first slab's exact max width plus ``headroom`` spare bits; an int
        pins the width; ``None`` keeps slabs as decoded
        :class:`~repro_torch.core.Compressed` containers (no packing).  A
        slab whose residuals exceed the pinned width is encoded at its own
        exact width instead — correctness first; only the one-layout
        guarantee narrows to the conforming slabs.
    device:
        Where the slabs are compressed and kept: the card unless the caller
        asks for ``"cpu"``.
    """

    def __init__(self, compressor: HSZCompressor | str, *,
                 rel_eb: float | None = None,
                 abs_eb: float | None = None,
                 eps=None, bits: str | int | None = "auto",
                 headroom: int = 2, device="cuda"):
        self.compressor = (by_name(compressor)
                           if isinstance(compressor, str) else compressor)
        self.device = kernel_ops.resolve_device(device)
        self._rel_eb = rel_eb
        self._abs_eb = abs_eb
        self._eps = None
        if eps is not None:
            self._pin_eps(torch.as_tensor(eps, dtype=torch.float32,
                                          device=self.device))
        if not (bits is None or bits == "auto" or isinstance(bits, int)):
            raise ValueError(f"bits must be 'auto', an int, or None; got {bits!r}")
        self._bits = bits
        self._headroom = int(headroom)
        self.slabs: list[Field] = []
        self._spatial_shape: tuple[int, ...] | None = None
        self._dtype = None
        self._q_abs_max = 0

    def _pin_eps(self, eps: torch.Tensor) -> None:
        """Pin the quantization step, with its value on the host for the
        layout signature (one host read here, none per query)."""
        self._eps = eps
        self._eps_host = float(eps)

    # -- static identity ----------------------------------------------------
    @property
    def scheme(self):
        return self.compressor.scheme

    @property
    def eps(self) -> torch.Tensor:
        if self._eps is None:
            raise ValueError("eps is resolved at the first append; "
                             "no slab has been appended yet")
        return self._eps

    @property
    def shape(self) -> tuple[int, ...]:
        """The *spatial* shape (regions and results live here; time grows)."""
        if self._spatial_shape is None:
            raise ValueError("no slab has been appended yet")
        return self._spatial_shape

    @property
    def n_slabs(self) -> int:
        return len(self.slabs)

    @property
    def n_steps(self) -> int:
        """Total appended timesteps across all slabs."""
        return sum(s.shape[0] for s in self.slabs)

    def layout_sig(self) -> tuple:
        """Hashable grouping signature (streams that share compression
        identity batch together)."""
        eps = None if self._eps is None else self._eps_host
        return ("temporal", self.scheme, self._spatial_shape, eps,
                None if self._dtype is None
                else str(self._dtype).removeprefix("torch."))

    # -- ingestion ----------------------------------------------------------
    def append(self, data) -> int:
        """Compress (and encode) one time slab; returns its index.

        ``data`` has shape ``(k, *spatial)`` — ``k`` timesteps of the
        field.  History is never touched: the slab is compressed alone,
        against the stream's pinned ``eps``.  The capacity guard runs before
        the stream's state changes.
        """
        data = torch.as_tensor(data, device=self.device)
        if data.ndim < 2:
            raise ValueError(
                f"a time slab is (timesteps, *spatial); got shape "
                f"{tuple(data.shape)}")
        spatial = tuple(data.shape[1:])
        if self._spatial_shape is not None and spatial != self._spatial_shape:
            raise ValueError(
                f"slab spatial shape {spatial} != stream spatial shape "
                f"{self._spatial_shape}")
        eps = self._eps
        if eps is None:
            eps = quantize.resolve_eps(data, abs_eb=self._abs_eb,
                                       rel_eb=self._rel_eb).to(torch.float32)
        comp = self.compressor
        c = comp.compress(data, eps=eps, device=self.device)
        # capacity guard: the merged summary's Σq² leaf is int32; refuse an
        # append that could wrap it, before any state changes.  The slab's
        # stage-③ integers are its quantized values (decorrelation is
        # lossless), so the measured bound reads them from the quantizer.
        q_abs = max(self._q_abs_max,
                    _q_abs(quantize.quantize(data, c.eps)))
        steps = self.n_steps + int(data.shape[0])
        capacity = summary_capacity(q_abs)
        if steps > capacity:
            raise SummaryCapacityError(
                f"appending {int(data.shape[0])} timesteps would take the "
                f"stream to {steps} total steps, past the exact int32 "
                f"summary capacity of {capacity} for |q| <= {q_abs}; "
                "re-shard the stream, loosen the error bound, or open a "
                "new TemporalField")
        slab: Field = c
        if self._bits is not None:
            width = comp.max_bits(c)
            if self._bits == "auto" and not self.slabs:
                self._bits = min(32, width + self._headroom)
            if isinstance(self._bits, int):
                # a pinned width narrower than the slab's residuals would
                # corrupt the payload: encode such a slab at its own width
                slab = comp.encode(c, bits=max(self._bits, width))
        if self._spatial_shape is None:
            self._spatial_shape = spatial
            self._dtype = data.dtype
        if self._eps is None:
            self._pin_eps(eps)
        self.slabs.append(slab)
        self._q_abs_max = q_abs
        return len(self.slabs) - 1

    # -- reference path (full decompression of the concatenated field) ------
    def decompress_q(self, region=None) -> torch.Tensor:
        """Stage-③ integers of the *concatenated* field, ``(T, *spatial)``
        (optionally cropped to a spatial ``region``) — the full
        multi-stage decompression the homomorphic merges are pinned
        against."""
        if not self.slabs:
            raise ValueError("no slab has been appended yet")
        q = torch.cat([self.compressor.decompress(s, Stage.Q)
                       for s in self.slabs], dim=0)
        if region is not None:
            norm = region_mod.normalize_region(region, self.shape)
            q = q[(slice(None),) + tuple(slice(s, e) for s, e in norm)]
        return q

    def decompress(self, stage: Stage = Stage.F) -> torch.Tensor:
        """Fully decompress the concatenated stream at ``stage``."""
        stage = Stage(stage)
        if stage == Stage.Q:
            return self.decompress_q()
        return torch.cat([self.compressor.decompress(s, stage)
                          for s in self.slabs], dim=0)

    def reference(self, ops: str | Sequence[str],
                  region=None) -> dict[str, torch.Tensor]:
        """Temporal ops evaluated on the full decompression of the
        concatenated field: one direct reduction over the stage-③ integers
        of the whole stream, then the shared op postludes — the oracle the
        incremental (per-slab merged) path is held bit-identical to."""
        names = oplib.canonical_ops(ops)
        summary = oplib.summary_from_q(self.decompress_q(region=region))
        return oplib.temporal_postlude(names, summary, self.eps)
