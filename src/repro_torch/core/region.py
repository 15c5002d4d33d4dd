"""Block-sparse region queries over compressed/encoded fields.

An analytical operation over a spatial sub-region touches only the blocks
that cover it, not the whole field.  Because the device container packs
residuals at a *uniform* width (``Encoded.bits``), the payload words holding
any block are computable on the host: a region query gathers exactly those
words (plus the per-block metadata / bitwidths / valid counts of the
covering blocks) and unpacks nothing else.

The gathered blocks always form an *honest sub-field* — a smaller
:class:`~repro_torch.core.stages.Compressed` whose every invariant holds —
so the homomorphic operators reuse their stage arithmetic on it:

* **block-mean family** (HSZx/HSZx-nd): every block is self-contained, so
  the closure of a region is its geometric covering block set;
* **Lorenzo family** (HSZp/HSZp-nd): recorrelation is a prefix sum, so the
  closure is the origin-anchored *prefix hull* ``[0, stop)`` per axis.
  Stage-② derivatives only prefix-sum over the non-derivative axes, so their
  closure narrows to a *band*: covering range on the derivative axis, hull
  on the others.

All plan geometry (block ranges, flat indices, payload word indices, window
index maps, statistic weights) is numpy on the host, built once per plan
and memoized.  What a query reads on its device (gather indices, block ids,
window positions, overlap counts, weights) is copied there once and kept in
a small byte-bounded cache keyed by (plan, array, device), so repeated
queries copy nothing from the host and idle plans pin no device memory.
"""
from __future__ import annotations

from collections import OrderedDict
from collections.abc import Callable, Sequence

import numpy as np
import torch

from . import encode
from .stages import Compressed, Encoded, Scheme, Stage

#: one axis of a region: ``None`` (full axis), a ``slice``, or ``(start, stop)``.
AxisSpec = None | slice | tuple[int, int] | Sequence[int]
RegionSpec = Sequence[AxisSpec]

#: closure kinds: ``"cover"`` (geometric covering blocks), ``"hull"``
#: (origin-anchored prefix rectangle), ``("band", axis)`` (cover on ``axis``,
#: hull on the others — Lorenzo stage-② derivatives).
Closure = str | tuple[str, int]


def normalize_region(region: RegionSpec, shape: Sequence[int]) -> tuple[tuple[int, int], ...]:
    """Canonicalize a region to per-axis ``(start, stop)`` over ``shape``.

    Accepts ``None`` / ``slice(start, stop)`` / ``(start, stop)`` per axis;
    negative indices count from the axis end, python-style.
    """
    if len(region) != len(shape):
        raise ValueError(f"region rank {len(region)} != field rank {len(shape)}")
    out = []
    for spec, s in zip(region, shape):
        if spec is None:
            start, stop = 0, s
        elif isinstance(spec, slice):
            if spec.step not in (None, 1):
                raise ValueError("region slices must have step 1")
            start, stop, _ = spec.indices(s)
        else:
            start, stop = spec
            start = int(start) + (s if start < 0 else 0)
            stop = int(stop) + (s if stop < 0 else 0)
        if not (0 <= start < stop <= s):
            raise ValueError(f"region axis ({start}, {stop}) out of bounds for size {s}")
        out.append((int(start), int(stop)))
    return tuple(out)


class GatherIndex:
    """Payload-gather arrays for one ``(plan, bits)`` pair.

    ``word_idx`` are the only payload words touched; ``pos0``/``pos1``/
    ``shift`` address each gathered value's (<= 2) word contributions within
    that gathered word set (``pos1`` may point at the appended zero word).
    Host plans hold numpy arrays; :meth:`RegionPlan.device_gather` holds the
    same values as int32 tensors on a device.
    """

    def __init__(self, word_idx, pos0, pos1, shift, n_values: int):
        self.word_idx = word_idx
        self.pos0 = pos0
        self.pos1 = pos1
        self.shift = shift
        self.n_values = n_values

    @property
    def n_words(self) -> int:
        """Number of payload words a region decode gathers."""
        return int(self.word_idx.shape[0])


# ---------------------------------------------------------------------------
# device copies of plan arrays: one bounded LRU for every plan
# ---------------------------------------------------------------------------

#: device bytes the cache may pin (a Lorenzo hull at the far corner of a
#: 2400 x 3600 field needs about 104 MB of gather indices)
DEVICE_CACHE_BYTES = 512 * 2 ** 20
_DEVICE_CACHE: "OrderedDict[tuple, tuple[object, int]]" = OrderedDict()


def _nbytes(value) -> int:
    items = value if isinstance(value, tuple) else (value,)
    return sum(t.numel() * t.element_size() for t in items
               if isinstance(t, torch.Tensor))


def _lead(x: torch.Tensor, rank: int) -> tuple[int, ...]:
    """The leading (batch) dims of ``x`` before its last ``rank`` dims."""
    return tuple(x.shape[:x.ndim - rank])


def _put(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), device=device)


def _device_cached(key: tuple, make: Callable[[], object]):
    """The cached device value under ``key``, made by ``make`` on a miss;
    least recently used entries leave once the cache holds more than
    :data:`DEVICE_CACHE_BYTES` (the newest entry always stays)."""
    hit = _DEVICE_CACHE.get(key)
    if hit is not None:
        _DEVICE_CACHE.move_to_end(key)
        return hit[0]
    value = make()
    _DEVICE_CACHE[key] = (value, _nbytes(value))
    total = sum(n for _, n in _DEVICE_CACHE.values())
    while total > DEVICE_CACHE_BYTES and len(_DEVICE_CACHE) > 1:
        _, (_, n) = _DEVICE_CACHE.popitem(last=False)
        total -= n
    return value


class RegionPlan:
    """Host-side static plan of one region query over one field layout.

    Built once per ``(layout, region, closure)`` and memoized; holds the
    gathered block set, the sub-field geometry, the window index map, and the
    lazily-built payload word-gather / statistic-weight arrays.
    """

    def __init__(self, scheme: Scheme, shape: tuple[int, ...],
                 padded_shape: tuple[int, ...], block: tuple[int, ...],
                 region: tuple[tuple[int, int], ...], closure: Closure):
        self.scheme = scheme
        self.shape = shape              # original (logical) data shape
        self.padded_shape = padded_shape
        self.block = block
        self.region = region            # normalized, original-shape coords
        self.closure = closure
        self.key = (scheme, shape, padded_shape, block, region, closure)
        self._gather_cache: dict[int, GatherIndex] = {}
        self._weights: tuple[np.ndarray, ...] | None = None

        grid = tuple(p // b for p, b in zip(padded_shape, block))
        self.grid = grid
        if scheme.is_nd:
            self._build_nd(grid)
        else:
            self._build_flat(grid)
        self.win_shape = tuple(e - s for s, e in region)
        self.n_window = int(np.prod(self.win_shape))
        self.n_sub_blocks = int(self.block_ids.shape[0])
        self.gathered_elems = int(np.prod(self.sub_padded_shape))

    # -- construction -------------------------------------------------------
    def _axis_block_range(self, axis: int, s: int, e: int) -> tuple[int, int]:
        b = self.block[axis]
        if self.closure == "hull" or (
                isinstance(self.closure, tuple) and self.closure[1] != axis):
            return 0, -(-e // b)
        return s // b, -(-e // b)

    def _build_nd(self, grid: tuple[int, ...]) -> None:
        block = self.block
        ranges = tuple(self._axis_block_range(a, s, e)
                       for a, (s, e) in enumerate(self.region))
        self.grid_ranges = ranges
        self.sub_padded_shape = tuple((hi - lo) * b for (lo, hi), b in zip(ranges, block))
        self.sub_shape = tuple(min(hi * b, s) - lo * b
                               for (lo, hi), b, s in zip(ranges, block, self.shape))
        self.window = tuple(slice(s - lo * b, e - lo * b)
                            for (s, e), (lo, _), b in zip(self.region, ranges, block))
        self.spatial_slices = tuple(slice(lo * b, hi * b)
                                    for (lo, hi), b in zip(ranges, block))
        self.grid_slices = tuple(slice(lo, hi) for lo, hi in ranges)
        axes = [np.arange(lo, hi) for lo, hi in ranges]
        mesh = np.meshgrid(*axes, indexing="ij")
        self.block_ids = np.ravel_multi_index(tuple(mesh), grid).reshape(-1)
        self.win_pos = None
        # per-gathered-block window-overlap element counts (outer product)
        per_axis = []
        for (s, e), (lo, hi), b in zip(self.region, ranges, block):
            i = np.arange(lo, hi)
            per_axis.append(np.clip(np.minimum(e, (i + 1) * b)
                                    - np.maximum(s, i * b), 0, None))
        ov = per_axis[0]
        for a in per_axis[1:]:
            ov = np.multiply.outer(ov, a)
        self.overlap = ov.reshape(-1).astype(np.int32)
        self.aligned = all(s % b == 0 and (e % b == 0 or e == dim)
                           for (s, e), b, dim in zip(self.region, block, self.shape))

    def _build_flat(self, grid: tuple[int, ...]) -> None:
        """1-D schemes flatten the data; a spatial region becomes a union of
        row-major flat runs whose covering block *set* (not range) is gathered."""
        b = self.block[0]
        n = int(np.prod(self.shape))
        lead = [np.arange(s, e) for s, e in self.region[:-1]]
        s_last, e_last = self.region[-1]
        if lead:
            mesh = np.meshgrid(*lead, indexing="ij")
            starts = np.ravel_multi_index(
                tuple(mesh) + (np.full(mesh[0].shape, s_last),), self.shape).reshape(-1)
        else:
            starts = np.asarray([s_last], dtype=np.int64)
        win_flat = (starts[:, None] + np.arange(e_last - s_last)).reshape(-1)
        self.win_flat = win_flat  # ascending (row-major region order)
        cover_ids = np.unique(win_flat // b)
        if self.scheme.is_lorenzo:
            # prefix hull: every block up to the last one the window touches
            self.block_ids = np.arange(int(cover_ids[-1]) + 1, dtype=np.int64)
        else:
            self.block_ids = cover_ids
        nb = int(self.block_ids.shape[0])
        self.sub_padded_shape = (nb * b,)
        # only the field's final block is partial, and it sorts last — so the
        # gathered valid elements are a prefix of the gathered layout
        per_block_valid = np.minimum(b, n - self.block_ids * b)
        self.sub_shape = (int(per_block_valid.sum()),)
        self.window = None
        rank = np.searchsorted(self.block_ids, win_flat // b)
        self.win_pos = (rank * b + win_flat % b).astype(np.int32)
        self.overlap = np.bincount(rank, minlength=nb).astype(np.int32)
        cover_rank = np.searchsorted(self.block_ids, cover_ids)
        self.aligned = bool(
            np.array_equal(self.overlap[cover_rank],
                           np.minimum(b, n - cover_ids * b)))
        self.grid_ranges = None
        self.grid_slices = None
        self.spatial_slices = None

    # -- payload word gather (Encoded path) ---------------------------------
    def payload_gather(self, bits: int) -> GatherIndex:
        """Host word-gather arrays for a uniform-width payload at ``bits``."""
        gi = self._gather_cache.get(bits)
        if gi is not None:
            return gi
        if self.scheme.is_nd:
            axes = [np.arange(lo * b, hi * b)
                    for (lo, hi), b in zip(self.grid_ranges, self.block)]
            mesh = np.meshgrid(*axes, indexing="ij")
            gflat = np.ravel_multi_index(tuple(mesh), self.padded_shape).reshape(-1)
        else:
            b = self.block[0]
            gflat = (self.block_ids[:, None] * b + np.arange(b)).reshape(-1)
        m = int(gflat.shape[0])
        if bits == 0:
            gi = GatherIndex(np.zeros((0,), np.int32), np.zeros((m,), np.int32),
                             np.zeros((m,), np.int32), np.zeros((m,), np.uint32), m)
        else:
            total_words = encode.words_for(int(np.prod(self.padded_shape)), bits)
            offs = gflat.astype(np.int64) * bits
            w0 = offs >> 5
            uniq = np.unique(np.concatenate([w0, w0 + 1]))
            uniq = uniq[uniq < total_words]
            pos0 = np.searchsorted(uniq, w0).astype(np.int32)
            w1 = w0 + 1
            pos1 = np.where(w1 < total_words, np.searchsorted(uniq, w1),
                            uniq.shape[0]).astype(np.int32)
            gi = GatherIndex(uniq.astype(np.int32), pos0, pos1,
                             (offs & 31).astype(np.uint32), m)
        self._gather_cache[bits] = gi
        return gi

    def device_gather(self, bits: int, device) -> GatherIndex:
        """:meth:`payload_gather` as int32 tensors on ``device``, copied once
        and kept in the bounded device cache (the host arrays are freed with
        the plan; the device copies leave the cache by recency)."""
        def make():
            gi = self.payload_gather(bits)
            return GatherIndex(*(_put(a.astype(np.int32), device) for a in (
                gi.word_idx, gi.pos0, gi.pos1, gi.shift)), gi.n_values)

        return _device_cached(self.key + (("gather", bits), str(device)), make)

    def on_device(self, name: str, device) -> torch.Tensor:
        """One host array of the plan (``block_ids`` as int32, ``win_pos``,
        ``overlap``) as a tensor on ``device``, through the device cache."""
        return _device_cached(
            self.key + (name, str(device)),
            lambda: _put(getattr(self, name).astype(np.int32), device))

    # -- sub-field assembly --------------------------------------------------
    def gather_metadata(self, c: Compressed | Encoded) -> torch.Tensor:
        """Metadata restricted to the gathered blocks (no payload decode);
        a ``batch_stack`` view's leading dim is kept whole."""
        if not c.scheme.is_blockmean:
            return c.metadata  # Lorenzo: global anchor lives in the residuals
        if self.grid_slices is not None:
            return c.metadata[(Ellipsis,) + self.grid_slices].contiguous()
        ids = self.on_device("block_ids", c.metadata.device)
        return c.metadata.reshape(_lead(c.metadata, 1) + (-1,)).index_select(
            -1, ids)

    def assemble(self, residuals: torch.Tensor, src: Compressed | Encoded) -> Compressed:
        """Build the honest sub-field around gathered residuals (of each
        field of a ``batch_stack`` view: the block ids index the last dim
        of its per-block leaves)."""
        ids = self.on_device("block_ids", src.bitwidths.device)
        return Compressed(
            residuals=residuals.contiguous(), metadata=self.gather_metadata(src),
            bitwidths=src.bitwidths.index_select(-1, ids), eps=src.eps,
            valid_counts=src.valid_counts.index_select(-1, ids),
            scheme=src.scheme, shape=self.sub_shape,
            padded_shape=self.sub_padded_shape, block=src.block,
            orig_dtype=src.orig_dtype)

    # -- window access -------------------------------------------------------
    def window_of(self, arr: torch.Tensor) -> torch.Tensor:
        """Crop a sub-field spatial array to the requested window.

        nd schemes slice the gathered rectangle; 1-D schemes gather the
        window's flat positions and restore the n-D shape.  Leading dims
        (a batch) are kept whole.
        """
        if self.window is not None:
            return arr[(Ellipsis,) + self.window]
        pos = self.on_device("win_pos", arr.device)
        lead = _lead(arr, 1)
        return arr.reshape(lead + (-1,)).index_select(-1, pos).reshape(
            lead + self.win_shape)

    def lorenzo_mean_weights(self) -> tuple[np.ndarray, ...]:
        """Window-sum weights: ``sum_{i in window} q_i = <weights, residuals>``.

        Per-axis weights ``w_a[i] = #{j in window_a : j >= i}`` (separable,
        nd) or one flat weight vector counting window positions at-or-after
        each index (1-D).
        """
        if self._weights is not None:
            return self._weights
        if self.scheme.is_nd:
            ws = []
            for (s, e), length in zip(self.region, self.sub_padded_shape):
                i = np.arange(length)
                ws.append(np.clip(e - np.maximum(i, s), 0, None).astype(np.float32))
            self._weights = tuple(ws)
        else:
            i = np.arange(self.sub_padded_shape[0])
            w = self.n_window - np.searchsorted(self.win_flat, i, side="left")
            self._weights = (w.astype(np.float32),)
        return self._weights

    def device_weights(self, device) -> tuple[torch.Tensor, ...]:
        """:meth:`lorenzo_mean_weights` as f32 tensors on ``device``."""
        return _device_cached(
            self.key + ("weights", str(device)),
            lambda: tuple(_put(w, device) for w in self.lorenzo_mean_weights()))


# ---------------------------------------------------------------------------
# plan construction / memoization
# ---------------------------------------------------------------------------

_PLAN_CACHE: "OrderedDict[tuple, RegionPlan]" = OrderedDict()
_PLAN_CACHE_LIMIT = 256


def canonical_closure(scheme: Scheme, closure: Closure,
                      region: object | None = None) -> Closure:
    """Canonical cache/plan-key form of a closure.

    1-D layouts have no per-axis bands (``("band", a)`` degrades to the
    prefix hull — exactly what :func:`plan_region` executes), and with no
    region the closure never enters any computation, so every full-field
    materialization shares one key (``"cover"``).
    """
    if region is None:
        return "cover"
    if not Scheme(scheme).is_nd and isinstance(closure, tuple):
        return "hull"
    return closure


def plan_region(c: Compressed | Encoded, region: RegionSpec,
                closure: Closure = "cover") -> RegionPlan:
    """Plan (and memoize) a region query over ``c``'s layout."""
    norm = normalize_region(region, c.shape)
    closure = canonical_closure(c.scheme, closure, norm)
    key = (c.scheme, c.shape, c.padded_shape, c.block, norm, closure)
    plan = _PLAN_CACHE.get(key)
    if plan is not None:
        _PLAN_CACHE.move_to_end(key)
        return plan
    plan = RegionPlan(c.scheme, c.shape, c.padded_shape, c.block, norm, closure)
    _PLAN_CACHE[key] = plan
    while len(_PLAN_CACHE) > _PLAN_CACHE_LIMIT:
        _PLAN_CACHE.popitem(last=False)
    return plan


def op_closure(scheme: Scheme, op: str, stage: Stage, axis: int = 0) -> Closure:
    """Dependency closure an op needs at a stage (see module docstring)."""
    if not Scheme(scheme).is_lorenzo:
        return "cover"
    if Scheme(scheme).is_nd and Stage(stage) == Stage.P and op == "derivative":
        return ("band", axis)
    return "hull"


def extract(c: Compressed | Encoded, plan: RegionPlan) -> Compressed:
    """The gathered sub-field; from :class:`Encoded` this unpacks only the
    payload words covering the plan's blocks
    (:func:`repro_torch.core.encode.decode_region`)."""
    if isinstance(c, Encoded):
        return encode.decode_region(c, plan)
    if plan.spatial_slices is not None:
        residuals = c.residuals[(Ellipsis,) + plan.spatial_slices]
    else:
        b = c.block[0]
        lead = _lead(c.residuals, 1)
        ids = plan.on_device("block_ids", c.residuals.device)
        residuals = c.residuals.reshape(lead + (-1, b)).index_select(
            -2, ids).reshape(lead + (-1,))
    return plan.assemble(residuals, c)


def region_aligned(c: Compressed | Encoded, region: RegionSpec) -> bool:
    """Is the window block-aligned (so stage-① statistics stay eps-exact)?"""
    return plan_region(c, region, "cover").aligned


def closure_fraction(c: Compressed | Encoded, op: str, stage: Stage,
                     region: RegionSpec, axis: int = 0) -> float:
    """Fraction of the field a region query must touch at ``stage``.

    Stage ① touches metadata only, so its fraction is in blocks; other stages
    are in elements of the gathered closure.  Multivariate ops average their
    per-axis derivative closures.
    """
    stage = Stage(stage)
    if op in ("divergence", "curl"):
        nd = len(c.shape)
        fr = [closure_fraction(c, "derivative", stage, region, axis=a)
              for a in range(nd)]
        return float(np.mean(fr))
    if stage == Stage.M:
        plan = plan_region(c, region, "cover")
        n_blocks = int(np.prod(plan.grid))
        return plan.n_sub_blocks / max(n_blocks, 1)
    plan = plan_region(c, region, op_closure(c.scheme, op, stage, axis))
    return plan.gathered_elems / max(int(np.prod(c.padded_shape)), 1)
