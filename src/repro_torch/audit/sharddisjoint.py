"""Analyzer (6): shard-partition exactness.

The shard layer's bit-identity claim — "scatter-add + shard-axis sum over
*disjoint* word sets reassembles the single-device gather bitwise" —
decomposes into exactly the invariants this pass proves:

* **word-owner partition** — :meth:`BlockPlacement.word_owner` assigns
  every payload word to exactly one shard.  Symbolically: a word's owner
  is the round-robin residue of its first value's block-row, a total
  function, so ownership is a partition *by construction*; this pass
  re-derives the residue formula independently and then runs a
  bounded-exhaustive sweep over (world, layout, bits) checking that the
  per-shard stripes (:meth:`shard_word_index`) are pairwise disjoint and
  cover every word — so a refactor that breaks the construction (caching
  bug, straddle-word special case) is caught off any example the unit
  tests happen to use.
* **scatter disjointness** — the :func:`repro_torch.shard.exec.gather_routing`
  destination index sets are pairwise disjoint across shards and cover
  the gathered word set exactly (padding rows land in the dropped slot),
  and each routed word is read from the right stripe position — the
  precondition for the shard-axis int32 sum being *reassembly*, never
  accumulation.
* **band tiling** — :func:`repro_torch.shard.exec.spatial_bands` tiles a query
  window's rows exactly once, which pins the summary-merge fan-in at 1.
* **world-scaled envelope** — the cross-shard sum of
  :class:`TemporalSummary` leaves stays inside the ``intwidth`` envelope:
  with fan-in ``f`` (measured from the band tiling), the Σq² accumulator
  reaches ``f * max_slab_steps * q_abs**2``, which must fit int32.  The
  per-world safe-size table (:func:`shard_safe_size_table`) goes into
  AUDIT.json next to the single-device one.
* **collective container** — the int16 compressed-psum bit budget
  (:func:`repro_torch.comm.hom_collectives.bit_budget`) keeps the worst-case
  accumulator under ``PSUM_CONTAINER_MAX`` for every supported world
  size (swept exhaustively; the ``max(2, ...)`` usability floor caps
  support below world 32768, documented at the source).

All checks are host-side numpy/arithmetic over *static* layout math — no
mesh, no devices — so a run on the CPU and a run on the card produce
identical findings.

Findings are deduplicated per invariant (first witness wins) and routing
checks are skipped for a layout whose partition already failed — one root
cause, one finding.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from ..core import Scheme, encode
from .findings import Finding
from .intwidth import DEFAULT_ENVELOPE, INT32_MAX, Envelope, summary_capacity

_ANALYZER = "sharddisjoint"

#: world sizes for the layout sweeps (placements, routing, bands).
DEFAULT_WORLDS = (1, 2, 3, 4, 8)
#: upper bound of the exhaustive collective-container sweep; the
#: ``bit_budget`` floor makes larger worlds unsupported by construction.
MAX_COLLECTIVE_WORLD = 4096

#: layout sweep: (scheme, shape, padded_shape, block, bits, axis) —
#: covers nd/flat schemes, word-straddling bit widths (bits not dividing
#: 32), a non-zero shard axis, and ragged true shapes inside padding.
DEFAULT_CASES = (
    (Scheme.HSZP_ND, (100, 96), (112, 96), (16, 32), 7, 0),
    (Scheme.HSZP_ND, (100, 96), (112, 96), (16, 32), 12, 0),
    (Scheme.HSZX_ND, (12, 40, 16), (12, 48, 16), (1, 8, 16), 9, 1),
    (Scheme.HSZP, (1000,), (1024,), (256,), 5, 0),
    (Scheme.HSZX, (1000,), (1024,), (256,), 11, 0),
)


class _Collector:
    """First witness per invariant: an auditor wants the root cause, not
    every layout the same bug breaks."""

    def __init__(self):
        self.findings: list[Finding] = []
        self._seen: set[str] = set()

    def add(self, f: Finding) -> None:
        if f.invariant not in self._seen:
            self._seen.add(f.invariant)
            self.findings.append(f)


def _case_subject(scheme, padded, block, bits, world) -> str:
    return (f"BlockPlacement[{getattr(scheme, 'value', scheme)} "
            f"{padded}/{block} bits={bits} world={world}]")


def _ref_word_owner(placement, bits: int) -> np.ndarray:
    """Independent re-derivation of the round-robin residue formula: a
    word belongs to the shard owning the block-row of its first value."""
    n_values = int(np.prod(placement.padded_shape, dtype=np.int64))
    n_words = encode.words_for(n_values, bits)
    first_value = np.minimum(
        (np.arange(n_words, dtype=np.int64) * 32) // max(bits, 1),
        max(n_values - 1, 0))
    if placement.scheme.is_nd:
        stride = int(np.prod(placement.padded_shape[placement.axis + 1:],
                             dtype=np.int64))
        coord = (first_value // stride) % placement.padded_shape[
            placement.axis]
        return ((coord // placement.block[placement.axis])
                % placement.n_shards).astype(np.int32)
    return ((first_value // placement.block[0])
            % placement.n_shards).astype(np.int32)


def _check_partition(out: _Collector, placement, bits: int,
                     subject: str) -> bool:
    """Word stripes pairwise disjoint + covering; formula drift; unit
    round-robin.  Returns True when the partition holds (routing checks
    depend on it)."""
    n_values = int(np.prod(placement.padded_shape, dtype=np.int64))
    n_words = encode.words_for(n_values, bits)
    stripes = placement.shard_word_index(bits)
    allw = np.concatenate([np.asarray(s, dtype=np.int64) for s in stripes]) \
        if stripes else np.zeros((0,), np.int64)
    ok = True
    uniq, counts = np.unique(allw, return_counts=True)
    dup = uniq[counts > 1]
    if dup.size:
        ok = False
        out.add(Finding(
            _ANALYZER, "word-owner-overlap",
            f"payload word {int(dup[0])} appears in "
            f"{int(counts[counts > 1][0])} shards' word stripes — the sum "
            "would accumulate it, not reassemble it",
            subject=subject,
            suggestion="word_owner must assign each word to exactly one "
                       "shard (the word's first value's block-row owner)"))
    missing = np.setdiff1d(np.arange(n_words, dtype=np.int64), uniq,
                           assume_unique=True)
    if missing.size:
        ok = False
        out.add(Finding(
            _ANALYZER, "word-owner-gap",
            f"payload word {int(missing[0])} of {n_words} belongs to no "
            "shard's word stripe — its bits vanish from the merged "
            "payload",
            subject=subject,
            suggestion="every word index in [0, words_for(n, bits)) must "
                       "appear in exactly one shard_word_index stripe"))
    ref = _ref_word_owner(placement, bits)
    live = np.asarray(placement.word_owner(bits))
    if live.shape != ref.shape or not np.array_equal(live, ref):
        ok = False
        where = (int(np.nonzero(live != ref)[0][0])
                 if live.shape == ref.shape else -1)
        out.add(Finding(
            _ANALYZER, "stripe-formula-drift",
            "word_owner no longer matches the round-robin stripe residue "
            f"formula (first divergence at word {where}); the audited "
            "partition argument no longer describes the shipped code",
            subject=subject,
            suggestion="keep owner(word) == (block_row(first_value(word)) "
                       "% n_shards) or update the audit's reference "
                       "derivation with the new construction"))
    units = np.concatenate([placement.units_of(s)
                            for s in range(placement.n_shards)])
    if not np.array_equal(np.sort(units),
                          np.arange(placement.n_units, dtype=np.int64)):
        ok = False
        out.add(Finding(
            _ANALYZER, "unit-owner-drift",
            "units_of() does not partition the stripe units "
            f"[0, {placement.n_units})",
            subject=subject))
    return ok


def _check_routing(out: _Collector, routing_fn, placement, bits: int,
                   subject: str) -> None:
    """Scatter targets partition the gathered set; sources read the words
    they claim."""
    n_values = int(np.prod(placement.padded_shape, dtype=np.int64))
    n_words = encode.words_for(n_values, bits)
    stripes = placement.shard_word_index(bits)
    for word_idx in (np.arange(n_words, dtype=np.int64),
                     np.arange(0, n_words, 2, dtype=np.int64)):
        n_out = len(word_idx)
        src, dst = routing_fn(placement.n_shards, placement, bits, word_idx)
        live = dst[dst != n_out]
        uniq, counts = np.unique(live, return_counts=True)
        if np.any(counts > 1):
            out.add(Finding(
                _ANALYZER, "scatter-overlap",
                f"gathered word slot {int(uniq[counts > 1][0])} is a "
                "scatter-add target of more than one shard — the sum "
                "accumulates instead of reassembling",
                subject=subject,
                suggestion="each gathered word must be scattered by its "
                           "single owner; all other shards pad into the "
                           "dropped slot"))
            return
        missing = np.setdiff1d(np.arange(n_out, dtype=np.int64), uniq,
                               assume_unique=True)
        if missing.size:
            out.add(Finding(
                _ANALYZER, "scatter-gap",
                f"gathered word slot {int(missing[0])} of {n_out} is no "
                "shard's scatter target — it stays zero in the merged "
                "payload",
                subject=subject))
            return
        for s in range(placement.n_shards):
            live_k = np.nonzero(dst[s] != n_out)[0]
            stripe = np.asarray(stripes[s], dtype=np.int64)
            srcs = src[s, live_k].astype(np.int64)
            if srcs.size and (srcs.max(initial=-1) >= len(stripe)
                              or not np.array_equal(
                                  stripe[srcs], word_idx[dst[s, live_k]])):
                out.add(Finding(
                    _ANALYZER, "scatter-misroute",
                    f"shard {s} routes a stripe word to a slot expecting "
                    "a different global word — the merge would be "
                    "bit-wrong even though targets are disjoint",
                    subject=subject))
                return


def _check_bands(out: _Collector, bands_fn, placement, scheme, shape,
                 block, regions, subject: str) -> int:
    """Band row ranges tile each query window exactly once; returns the
    largest fan-in observed (1 when exact)."""
    field = SimpleNamespace(scheme=scheme, shape=shape, block=block)
    fanin = 1
    for region in regions:
        spatial = shape[1:]
        if region is None:
            s0, e0 = 0, spatial[0]
        else:
            s0, e0 = region[0]
        nrows = e0 - s0
        cover = np.zeros(nrows, dtype=np.int64)
        for owner, row0, _unit_row0, band_region in \
                bands_fn(field, placement, region):
            r0, r1 = band_region[0]
            cover[r0 - s0:r1 - s0] += 1
            if not (0 <= owner < placement.n_shards):
                out.add(Finding(
                    _ANALYZER, "band-overlap",
                    f"band owner {owner} outside [0, "
                    f"{placement.n_shards})", subject=subject))
                return int(cover.max(initial=1))
        fanin = max(fanin, int(cover.max(initial=1)))
        if np.any(cover > 1):
            row = int(np.nonzero(cover > 1)[0][0]) + s0
            out.add(Finding(
                _ANALYZER, "band-overlap",
                f"window row {row} is covered by {int(cover.max())} "
                "bands — the summary merge would double-count its q "
                "integers",
                subject=subject,
                suggestion="spatial_bands must tile the window rows "
                           "exactly once per shard axis"))
        elif np.any(cover == 0):
            row = int(np.nonzero(cover == 0)[0][0]) + s0
            out.add(Finding(
                _ANALYZER, "band-gap",
                f"window row {row} is covered by no band — its q "
                "integers never reach the merged summary",
                subject=subject))
    return fanin


def shard_safe_size_table(env: Envelope = DEFAULT_ENVELOPE,
                          worlds=DEFAULT_WORLDS,
                          container_bits: int = 16) -> dict:
    """Per-world safe sizes for AUDIT.json (the sharded analogue of
    ``intwidth.safe_size_table``).

    ``summary_capacity`` is world-*independent* because the band scatter
    is disjoint (fan-in 1) — that is the point the analyzer proves; the
    ``accumulating`` column shows what the capacity would shrink to if the
    merge ever became a true accumulation, which is why drift matters.
    """
    from ..comm.hom_collectives import bit_budget, worst_case_psum

    cap = summary_capacity(env.q_abs)
    table = {}
    for w in worlds:
        bits = bit_budget(w, container_bits)
        table[str(w)] = {
            "summary_capacity_disjoint": cap,
            "summary_capacity_if_accumulating": cap // max(w, 1),
            "collective_bits": bits,
            "collective_qmax": 2 ** (bits - 1) - 1,
            "collective_worst_psum": worst_case_psum(w, container_bits),
        }
    return {
        "envelope": {"q_bits": env.q_bits, "q_abs": env.q_abs,
                     "max_slab_steps": env.max_slab_steps},
        "per_world": table,
    }


def analyze_shard_disjoint(env: Envelope = DEFAULT_ENVELOPE, *,
                           worlds=DEFAULT_WORLDS, cases=DEFAULT_CASES,
                           placement_cls=None, routing_fn=None,
                           bands_fn=None, bit_budget_fn=None,
                           max_collective_world: int = MAX_COLLECTIVE_WORLD
                           ) -> list[Finding]:
    """Run the shard-partition verifier.

    Every collaborator is injectable (``placement_cls`` / ``routing_fn`` /
    ``bands_fn`` / ``bit_budget_fn``) so the sabotage fixtures can break
    one invariant at a time; defaults audit the live shard layer.
    """
    from ..comm import hom_collectives as hc
    from ..shard import exec as exec_mod
    from ..shard.placement import BlockPlacement

    placement_cls = placement_cls or BlockPlacement
    routing_fn = routing_fn or exec_mod.gather_routing
    bands_fn = bands_fn or exec_mod.spatial_bands
    bit_budget_fn = bit_budget_fn or hc.bit_budget

    out = _Collector()

    # (1) + (2): word partition, then routing over the proven partition
    for scheme, shape, padded, block, bits, axis in cases:
        for world in worlds:
            subject = _case_subject(scheme, padded, block, bits, world)
            placement = placement_cls(scheme, shape, padded, block, world,
                                      axis)
            if _check_partition(out, placement, bits, subject):
                _check_routing(out, routing_fn, placement, bits, subject)

    # (3): band tiling of slab query windows (nd slab layout: time axis 0,
    # banded spatial axis == placement axis 1; flat: contiguous split)
    fanin = 1
    slab_cases = (
        (Scheme.HSZX_ND, (12, 40, 16), (12, 48, 16), (1, 8, 16), 1,
         (None, ((5, 27), (0, 16)))),
        (Scheme.HSZP, (16, 64), (16, 64), (1, 64), 0, (None,)),
    )
    for scheme, shape, padded, block, axis, regions in slab_cases:
        for world in worlds:
            subject = (f"spatial_bands[{scheme.value} {shape} "
                       f"world={world}]")
            placement = placement_cls(scheme, shape, padded, block, world,
                                      axis)
            fanin = max(fanin, _check_bands(
                out, bands_fn, placement, scheme, shape, block, regions,
                subject))

    # (4): world-scaled Σq² envelope — the merge adds `fanin` real
    # contributions per window position, so capacity is world-independent
    # exactly when fanin == 1
    worst = fanin * env.max_slab_steps * env.q_abs * env.q_abs
    if worst > INT32_MAX:
        out.add(Finding(
            _ANALYZER, "world-sumsq-overflow",
            f"merged summary Σq² reaches {worst} (band fan-in {fanin} x "
            f"{env.max_slab_steps} steps x q_abs {env.q_abs}²), over "
            f"int32 max {INT32_MAX} — the cross-shard merge overflows "
            "where the single-device summary would not",
            subject="TemporalSummary.q_sumsq",
            suggestion="restore disjoint band tiling (fan-in 1) or "
                       "shrink the envelope's max_slab_steps / q_bits"))

    # (5): int16 collective container, exhaustive over supported worlds
    for w in range(1, max_collective_world + 1):
        bits = bit_budget_fn(w)
        worst = w * (2 ** (bits - 1) - 1)
        if worst > hc.PSUM_CONTAINER_MAX:
            out.add(Finding(
                _ANALYZER, "collective-overflow",
                f"compressed psum at world {w} can reach {worst}, over "
                f"the int16 container max {hc.PSUM_CONTAINER_MAX} "
                f"(bit budget {bits})",
                subject="comm.bit_budget",
                suggestion="bit_budget must satisfy world * (2**(b-1)-1) "
                           "<= 2**15 - 1 for every supported world size"))
            break
    return out.findings
