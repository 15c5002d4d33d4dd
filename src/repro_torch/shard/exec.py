"""Shard programs: word-merge region decode and homomorphic temporal-summary
all-reduce over the analytics mesh.

Two program families, both built on one invariant — every cross-shard
combination is an **exact associative integer merge**, so the sharded
result is bit-identical to the single-device path by construction, never
by tolerance:

* **Word merge** (:meth:`ShardPrograms.region_compute`): a region query's
  :class:`~repro_torch.core.region.RegionPlan` names the exact payload
  words the single-device path gathers (``payload_gather``).  Each word is
  owned by exactly one shard (:meth:`~repro_torch.shard.placement
  .BlockPlacement.word_owner` — words are never split), so each shard reads
  its owned words from its *local* stripe, scatter-adds them into the
  gathered-word layout (int32 ``index_add_``: each kept slot receives one
  word plus zeros), and an int32 sum over the shard axis reassembles exactly
  ``payload[word_idx]``.  From there the op set lowers through the very
  same ``unpack -> unzigzag -> assemble -> postlude`` sequence as
  ``encode.decode_region`` (``oplib.compute(payload_words=...)``), or, for
  the full field, through ``decode_device`` on the reassembled payload — so
  the port's decode and band kernels run unchanged after the merge.

* **Summary merge** (:meth:`ShardPrograms.merge_band_summaries`):
  per-band partial :class:`~repro_torch.core.oplib.TemporalSummary` leaves
  are all int32 with modular sums, so spatial reassembly is a disjoint
  scatter into merge-neutral buffers followed by a sum / min / max over the
  shard axis — associative in any order.  A summary's per-position leaves
  depend only on the q integers at that position, so band partials
  scattered into the window equal the full-window summary bit for bit.

The store is single-controller: one process holds every shard's stripe on
that shard's device (``mesh.devices[s]``), and the shard axis's collective
(:func:`all_reduce`) moves the per-shard buffers to ``devices[0]`` and
reduces them there in int32; the merged words then run once, on
``devices[0]``, through the port's own lowering.  Devices may repeat (eight
shards on one card).  The merge is torch ops (gather, ``index_add_``,
adds); it launches none of the port's kernels.

Each call runs its merge and lowering directly; nothing is cached but
data.  The host routing of a merge (which stripe slot feeds which gathered
slot, :func:`gather_routing`) is built once per (placement, width, plan) and
its device copies kept in the region plans' bounded device cache.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import Encoded, Stage, oplib
from ..core import encode as encode_mod
from ..core import region as region_mod
from ..core.oplib import TemporalSummary
from .placement import BlockPlacement

_INT32_MAX = 2**31 - 1
_INT32_MIN = -2**31


def mesh_sig(mesh) -> tuple:
    """Hashable mesh identity (routing cache key component)."""
    return (tuple(mesh.axis_names), tuple(str(d) for d in mesh.devices))


def gather_routing(n_shards: int, placement: BlockPlacement, bits: int,
                   word_idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-shard (stripe-local source, gathered-set destination) index
    arrays for merging ``word_idx``.  Padding rows scatter into the
    dropped slot ``len(word_idx)``.

    Module-level (mesh-free) so a static audit can prove scatter-target
    disjointness for world sizes the host has no devices for.
    """
    word_idx = np.asarray(word_idx, dtype=np.int64)
    n_out = len(word_idx)
    owners = placement.word_owner(bits)[word_idx] if n_out else \
        np.zeros((0,), np.int32)
    stripes = placement.shard_word_index(bits)
    per_shard = []
    g_max = 1
    for s in range(n_shards):
        sel = np.nonzero(owners == s)[0]
        src = np.searchsorted(stripes[s], word_idx[sel])
        per_shard.append((src, sel))
        g_max = max(g_max, len(sel))
    src_arr = np.zeros((n_shards, g_max), np.int32)
    dst_arr = np.full((n_shards, g_max), n_out, np.int32)
    for s, (src, sel) in enumerate(per_shard):
        src_arr[s, :len(src)] = src
        dst_arr[s, :len(sel)] = sel
    return src_arr, dst_arr


def all_reduce(bufs, how: str, device) -> torch.Tensor:
    """The shard axis's collective: each shard's buffer moved to ``device``
    and reduced there — ``"sum"`` in int32 (two's-complement wrap, no
    promotion), ``"min"`` / ``"max"`` elementwise.  Reduces into the first
    buffer, which the caller gives up."""
    acc = bufs[0].to(device)
    for b in bufs[1:]:
        b = b.to(device)
        if how == "sum":
            acc.add_(b)
        elif how == "min":
            torch.minimum(acc, b, out=acc)
        else:
            torch.maximum(acc, b, out=acc)
    return acc


def _word_idx(field: Encoded, plan) -> np.ndarray:
    """The payload words a decode reads: the plan's gather, or all of them."""
    if plan is not None:
        return np.asarray(plan.payload_gather(field.bits).word_idx)
    return np.arange(
        encode_mod.words_for(int(np.prod(field.padded_shape, dtype=np.int64)),
                             field.bits), dtype=np.int64)


def _n_words(field: Encoded, plan) -> int:
    if plan is not None:
        return plan.payload_gather(field.bits).n_words
    return encode_mod.words_for(
        int(np.prod(field.padded_shape, dtype=np.int64)), field.bits)


class ShardPrograms:
    """Shard programs for one analytics mesh.

    Host-static routing (which words / bands belong to which shard) is
    derived from a :class:`BlockPlacement`; every shard runs the same steps
    on its own stripe and only the data differs.
    """

    def __init__(self, mesh):
        self.mesh = mesh
        self.n_shards = int(mesh.size)

    # -- payload striping ---------------------------------------------------
    def shard_payload(self, e: Encoded, placement: BlockPlacement
                      ) -> tuple[torch.Tensor, ...]:
        """Split a field's payload into per-shard word stripes.

        Returns one int32 bit-pattern tensor per shard, on that shard's
        device: shard ``s``'s owned words in ascending global order,
        zero-padded to the longest stripe (at least one word, so padding
        rows always read a valid slot).  Built once when a field enters the
        sharded store; every query reads from these stripes only.  The
        payload is gathered where it lies; nothing is read back to the host.
        """
        self._check(placement)
        idx = placement.shard_word_index(e.bits)
        w_max = max(max((len(i) for i in idx), default=0), 1)
        out = []
        for dev, i in zip(self.mesh.devices, idx):
            row = torch.zeros((w_max,), dtype=torch.int32, device=dev)
            if len(i):
                words = e.payload.index_select(
                    0, torch.as_tensor(i, device=e.payload.device))
                row[:len(i)] = words.to(dev)
            out.append(row)
        return tuple(out)

    def _check(self, placement: BlockPlacement):
        if placement.n_shards != self.n_shards:
            raise ValueError(
                f"placement has {placement.n_shards} shards but the mesh "
                f"has {self.n_shards} devices")

    def _check_device(self, field) -> None:
        dev0 = self.mesh.devices[0]
        if field.eps.device != dev0:
            raise ValueError(
                f"merged words land on the mesh's first device {dev0}; the "
                f"field lies on {field.eps.device}")

    def routing(self, field: Encoded, placement: BlockPlacement, plan):
        """Device copies of one merge's routing: ``(src, dst)`` per shard on
        that shard's device, built once per (mesh, placement, width, plan)."""
        key = ("__shard_routing__", mesh_sig(self.mesh), placement.sig(),
               field.bits, plan.key if plan is not None else None)

        def make():
            src, dst = gather_routing(self.n_shards, placement, field.bits,
                                      _word_idx(field, plan))
            devs = self.mesh.devices
            return (tuple(torch.as_tensor(s, device=d) for s, d in zip(src, devs))
                    + tuple(torch.as_tensor(t, device=d)
                            for t, d in zip(dst, devs)))

        flat = region_mod._device_cached(key, make)
        return flat[:self.n_shards], flat[self.n_shards:]

    def merge_words(self, stripes, routing, n_out: int) -> torch.Tensor:
        """Reassemble ``n_out`` gathered payload words on ``devices[0]``:
        each shard gathers its owned words from its stripe and scatter-adds
        them into the gathered layout (padding rows land in the dropped slot
        ``n_out``, where they may wrap: int32, never float); the shard-axis
        int32 sum is then exactly ``payload[word_idx]``."""
        bufs = []
        for st, src, dst in zip(stripes, *routing):
            buf = torch.zeros((n_out + 1,), dtype=torch.int32,
                              device=st.device)
            buf.index_add_(0, dst, st.index_select(0, src))
            bufs.append(buf[:n_out])
        return all_reduce(bufs, "sum", self.mesh.devices[0])

    # -- region / full-field op execution -----------------------------------
    def region_compute(self, target, ops, stage: Stage, *, axis: int = 0,
                       region=None, placements=None, stripes=None) -> dict:
        """Lower an op set over shard-striped payload(s), bit-identically.

        ``target`` is one :class:`Encoded` field (field-arity op sets) or a
        sequence of component fields (vector sets); ``placements`` /
        ``stripes`` follow the same arity (``stripes=None`` re-stripes on
        the fly — the store passes its resident stripes).  Returns the same
        ``{op: value}`` dict as :func:`repro_torch.core.oplib.compute`.
        """
        stage = Stage(stage)
        names = oplib.canonical_ops(ops)
        vector = oplib.is_vector_ops(names)
        comps = list(target) if vector else [target]
        for c in comps:
            if not isinstance(c, Encoded):
                raise TypeError(
                    "sharded execution requires Encoded fields (the payload "
                    f"is what is striped); got {type(c).__name__}")
            self._check_device(c)
        if placements is None:
            placements = [BlockPlacement.of(c, self.n_shards) for c in comps]
        placements = list(placements) if vector else \
            ([placements] if isinstance(placements, BlockPlacement)
             else list(placements))
        for p in placements:
            self._check(p)
        if stripes is None:
            stripes = [self.shard_payload(c, p)
                       for c, p in zip(comps, placements)]
        elif isinstance(stripes[0], torch.Tensor):
            stripes = [stripes]  # one field's stripes
        else:
            stripes = list(stripes)

        # host-static routing: the exact words the single-device gather reads
        norm = (region_mod.normalize_region(region, comps[0].shape)
                if region is not None else None)
        if vector:
            closures = oplib.component_closures(
                names, [c.scheme for c in comps], stage)
        else:
            closures = [oplib.set_closure(names, comps[0].scheme, stage, axis)]
        plans = [region_mod.plan_region(c, norm, cl) if norm is not None
                 else None for c, cl in zip(comps, closures)]
        merged = [self.merge_words(st, self.routing(c, p, pl), _n_words(c, pl))
                  for c, p, pl, st in zip(comps, placements, plans, stripes)]
        # the lowering reads the merged words only, never a payload
        ecs = [_stripped(c) for c in comps]
        if norm is None:
            # full field: the merge reassembles the entire payload exactly,
            # so the standard full decode runs unchanged
            full = tuple(dataclasses.replace(ec, payload=m)
                         for ec, m in zip(ecs, merged))
            return oplib.compute(full if vector else full[0], names, stage,
                                 axis=axis)
        return oplib.compute(tuple(ecs) if vector else ecs[0], names, stage,
                             axis=axis, region=norm,
                             payload_words=merged if vector else merged[0])

    # -- integer stage materialization ---------------------------------------
    def materialize(self, e: Encoded, stage: Stage, *, region=None,
                    closure="cover", placement: BlockPlacement | None = None,
                    stripes=None):
        """Stage-②/③ *integer* intermediate from shard-striped payload.

        Returns what ``oplib.StageContext`` keeps resident at the storage
        stage — the decoded ``sub`` container (stage ②) or the recorrelated
        ``q_spatial`` integers (stage ③, a contiguous window) — computed
        from the merged owned words.  Every array in either intermediate is
        int32, and integer reconstruction is exact, so the result is
        bit-identical to the single-device ``repro_torch.store.materialize``
        — which is what lets the sharded store seed the engine's standard
        calls and inherit the store's seeded == unseeded bit-identity.
        The full-field stage-② path runs ``encode.decode_device`` on the
        merged payload, i.e. the unpack kernel on a card.
        """
        stage = Stage(stage)
        if stage not in (Stage.P, Stage.Q):
            raise ValueError(
                f"materializations are stage-② or -③ intermediates, got {stage}")
        if not isinstance(e, Encoded):
            raise TypeError("sharded materialization requires an Encoded field")
        self._check_device(e)
        if placement is None:
            placement = BlockPlacement.of(e, self.n_shards)
        self._check(placement)
        if stripes is None:
            stripes = self.shard_payload(e, placement)
        norm = (region_mod.normalize_region(region, e.shape)
                if region is not None else None)
        closure = region_mod.canonical_closure(e.scheme, closure, norm)
        plan = (region_mod.plan_region(e, norm, closure) if norm is not None
                else None)
        merged = self.merge_words(stripes, self.routing(e, placement, plan),
                                  _n_words(e, plan))
        ec = _stripped(e)
        if norm is None:
            full = dataclasses.replace(ec, payload=merged)
            ctx = oplib.StageContext(full, stage, None, closure)
        else:
            ctx = oplib.StageContext(ec, stage, norm, closure, words=merged)
        return ctx.sub if stage == Stage.P else ctx.q_spatial.contiguous()

    # -- temporal summary merge ---------------------------------------------
    def merge_band_summaries(self, bands, win_rows: int,
                             rest: tuple[int, ...]) -> TemporalSummary:
        """Homomorphic all-reduce of per-band partial summaries.

        ``bands`` is a list of ``(owner_shard, row0, summary)`` where each
        summary covers rows ``[row0, row0 + rows)`` of a ``(win_rows,
        *rest)`` spatial window (leaves WITHOUT a batch axis).  Each shard
        scatters its bands into the window layout over merge-neutral
        buffers (0 for modular sums and ``last2``, INT32_MAX / MIN for min
        / max; ``count`` the maximum) and the shard axis's sum / min / max
        reassembles the full-window summary — int32-exact, so bit-identical
        to summarizing the whole window at once.
        """
        by_shard: list[list] = [[] for _ in range(self.n_shards)]
        for owner, row0, summ in bands:
            by_shard[int(owner) % self.n_shards].append((int(row0), summ))
        rest = tuple(rest)
        parts = [_scatter_bands(g, win_rows, rest, dev)
                 for g, dev in zip(by_shard, self.mesh.devices)]
        dev0 = self.mesh.devices[0]
        how = ("max", "sum", "sum", "min", "max", "sum")
        return TemporalSummary(*(all_reduce([p[i] for p in parts], h, dev0)
                                 for i, h in enumerate(how)))


def _stripped(c: Encoded) -> Encoded:
    """``c`` without its payload: a lowering reads only the stripes."""
    return dataclasses.replace(c, payload=c.payload.new_zeros((0,)))


def _scatter_bands(group, win_rows: int, rest: tuple[int, ...], dev
                   ) -> tuple[torch.Tensor, ...]:
    """One shard's bands scattered into merge-neutral window buffers, in
    ``TemporalSummary`` leaf order (count, q_sum, q_sumsq, q_min, q_max,
    last2).  Bands are disjoint, so each row is written by at most one."""
    shape = (win_rows, *rest)
    count = torch.zeros((), dtype=torch.int32, device=dev)
    q_sum = torch.zeros(shape, dtype=torch.int32, device=dev)
    q_sumsq = torch.zeros(shape, dtype=torch.int32, device=dev)
    q_min = torch.full(shape, _INT32_MAX, dtype=torch.int32, device=dev)
    q_max = torch.full(shape, _INT32_MIN, dtype=torch.int32, device=dev)
    last2 = torch.zeros((2, *shape), dtype=torch.int32, device=dev)
    for row0, s in group:
        s = oplib.map_summaries(lambda x: x.to(dev), s)
        rows = slice(row0, row0 + int(s.q_sum.shape[0]))
        q_sum[rows] += s.q_sum
        q_sumsq[rows] += s.q_sumsq
        q_min[rows] = torch.minimum(q_min[rows], s.q_min)
        q_max[rows] = torch.maximum(q_max[rows], s.q_max)
        last2[:, rows] += s.last2
        count = torch.maximum(count, s.count)
    return count, q_sum, q_sumsq, q_min, q_max, last2


def spatial_bands(field, placement: BlockPlacement, region=None
                  ) -> list[tuple[int, int, int, tuple]]:
    """Owner-assigned spatial bands of a slab field's query window.

    Returns ``(owner, row0_in_window, unit_row0, band_region)`` per band,
    where ``band_region`` is the spatial sub-window the owning shard
    summarizes (rows of spatial axis 0, full extent elsewhere).  nd slab
    layouts band by the compressor's block-rows along slab axis 1 — exactly
    the placement's stripe units, so each band's q reconstruction is
    shard-local; flat layouts split the window into ``n_shards`` contiguous
    bands (block ownership interleaves timesteps there, so banding is a
    grouping heuristic — the merge stays exact either way).
    """
    spatial = field.shape[1:]
    win = (region_mod.normalize_region(region, spatial) if region is not None
           else tuple((0, s) for s in spatial))
    s0, e0 = win[0]
    rest = tuple(win[1:])
    bands = []
    if field.scheme.is_nd:
        h = field.block[1]
        for u in range(s0 // h, -(-e0 // h)):
            r0, r1 = max(s0, u * h), min(e0, (u + 1) * h)
            if r1 <= r0:
                continue
            bands.append((u % placement.n_shards, r0 - s0, r0,
                          ((r0, r1),) + rest))
    else:
        n = placement.n_shards
        h = max(1, -(-(e0 - s0) // n))
        for b in range(-(-(e0 - s0) // h)):
            r0, r1 = s0 + b * h, min(s0 + (b + 1) * h, e0)
            bands.append((b % n, r0 - s0, r0, ((r0, r1),) + rest))
    return bands
