"""Streaming ingest of the port (``repro_torch.stream``) against the JAX
reference (``repro.stream``).

Every test feeds the reference and the port the same numpy slabs: the
reference's ``TemporalField`` and the port's, compressed on the CPU, or the
reference's stream carried across with ``convert.temporal_from_arrays``.
What is held, with its tolerance:

* summary leaves (``count``, ``q_sum``, ``q_sumsq``, ``q_min``, ``q_max``,
  ``last2``) **bitwise** equal to the reference's, for all four schemes at
  every feasible stage, ± a spatial region; the slabs' containers bitwise;
* ``tdelta`` / ``tmin`` / ``tmax`` **bitwise** equal to the reference's;
  ``tmean`` and ``tstd`` within ``error_analysis.temporal_round_bound`` (4
  ulp for ``tmean``; the moments form's cancellation bound for ``tstd``):
  the float tails keep the reference's order of operations, but XLA may
  contract them otherwise;
* inside the port, **bitwise**: served incrementally through a
  ``StreamFieldStore`` (after every append, and after eviction and
  recompute) equals ``TemporalField.reference``, one reduction over the full
  decompression;
* the same exception types for the same conditions.

The reference's two ``test_serve_append_*`` tests are mirrored in
``tests/test_torch_serve.py``.  The ``gpu`` tests need a card and skip
without one.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import analytics as janalytics
from repro import stream as jstream
from repro.analytics import BatchedAnalytics as JBatched
from repro.core import Stage as JStage
from repro.core import oplib as joplib
from repro.stream import temporal as jtemporal
from repro_torch import analytics, convert, stream
from repro_torch.analytics import BatchedAnalytics, CostModel, query
from repro_torch.core import (Scheme, Stage, UnsupportedStageError, by_name,
                              encode, error_analysis, oplib)
from repro_torch.core.stages import LEAVES
from repro_torch.kernels import bitpack, ops
from repro_torch.store import FieldStore
from repro_torch.stream import (StreamFieldStore, TemporalField,
                                merge_summaries, query_temporal,
                                summarize_slab, summary_from_q)
from repro_torch.stream.temporal import SummaryCapacityError, summary_capacity

ALL = ["hszp", "hszx", "hszp_nd", "hszx_nd"]
TOPS = ("tdelta", "tmean", "tmin", "tmax", "tstd")
SPATIAL = (48, 40)
REGION = ((10, 40), (5, 29))     # unaligned spatial window
LEAF_NAMES = ("count", "q_sum", "q_sumsq", "q_min", "q_max", "last2")


def _slab(i, k=3, spatial=SPATIAL, seed=0):
    rng = np.random.default_rng(seed + 100 * i)
    t = np.arange(i * k, (i + 1) * k, dtype=np.float32)[:, None, None]
    x = (np.linspace(0, 2 * np.pi, spatial[0])[None, :, None]
         + np.linspace(0, np.pi, spatial[1])[None, None, :])
    return (np.sin(x + 0.1 * t) * 2 + 0.05 * t
            + rng.normal(0, 0.02, (k,) + spatial)).astype(np.float32)


def _pair_streams(scheme, n_slabs=4, k=3, **kw):
    """(reference stream, port stream on the CPU, raw data) of the same
    numpy slabs."""
    jt = jstream.TemporalField(scheme, rel_eb=1e-3, **kw)
    pt = TemporalField(scheme, rel_eb=1e-3, device="cpu", **kw)
    raw = [_slab(i, k=k) for i in range(n_slabs)]
    for d in raw:
        jt.append(d)
        pt.append(d)
    return jt, pt, np.concatenate(raw, axis=0)


def _triple(jc):
    """A reference container as ``convert.from_arrays``' triple."""
    kind = type(jc).__name__
    arrays = {n: np.asarray(getattr(jc, n)) for n in LEAVES[kind]}
    meta = {"scheme": jc.scheme.value, "shape": jc.shape,
            "padded_shape": jc.padded_shape, "block": jc.block,
            "orig_dtype": np.dtype(jc.orig_dtype).name}
    if kind == "Encoded":
        meta["bits"] = jc.bits
    return kind, arrays, meta


def _carry(jt):
    """The reference stream ``jt`` as the port's, on the CPU."""
    return convert.temporal_from_arrays(
        jt.scheme.value, [_triple(s) for s in jt.slabs],
        eps=None if jt._eps is None else np.asarray(jt._eps),
        bits=jt._bits, headroom=jt._headroom, q_abs_max=jt._q_abs_max,
        block=jt.compressor.block, device="cpu")


def _feasible(scheme):
    return analytics.feasible_stages(Scheme(scheme), "tmean")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(got, ref):
    a, b = _np(got), _np(ref)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _same_summary(got, ref):
    """Leaf for leaf, bitwise (``ref`` a reference or port summary)."""
    for name in LEAF_NAMES:
        _same(getattr(got, name), getattr(ref, name))


def _close_op(op, got, ref, summary, eps):
    """A port postlude against the reference's: tdelta / tmin / tmax
    bitwise, tmean / tstd within ``temporal_round_bound``."""
    g, r = _np(got).astype(np.float64), _np(ref).astype(np.float64)
    assert _np(got).dtype == np.float32 and g.shape == r.shape
    tol = error_analysis.temporal_round_bound(op, summary, eps).numpy()
    if op in ("tdelta", "tmin", "tmax"):
        _same(got, ref)
    assert np.all(np.abs(g - r) <= tol), (op, np.abs(g - r).max())


def _cpu_containers_equal(jslab, pslab):
    assert type(jslab).__name__ == type(pslab).__name__
    kind, arrays, meta = _triple(jslab)
    _, parrays, pmeta = convert.to_arrays(pslab)
    assert pmeta == meta
    for name in LEAVES[kind]:
        np.testing.assert_array_equal(parrays[name], arrays[name])


# -- the reference's containers and summaries --------------------------------

@pytest.mark.parametrize("scheme", ALL)
def test_slabs_and_pinned_state_match_reference(scheme):
    """The same numpy slabs give the reference's containers bitwise, its
    pinned eps, payload width and measured |q| bound."""
    jt, pt, _ = _pair_streams(scheme, n_slabs=3)
    assert float(pt.eps) == float(jt.eps)
    assert pt._bits == jt._bits and pt._q_abs_max == jt._q_abs_max
    assert pt.n_steps == jt.n_steps == 9 and pt.shape == jt.shape
    for js, ps in zip(jt.slabs, pt.slabs, strict=True):
        _cpu_containers_equal(js, ps)
    tag, sch, shape, eps, dtype = pt.layout_sig()
    jtag, jsch, jshape, jeps, jdtype = jt.layout_sig()
    assert (tag, sch.value, shape, eps, dtype) == (jtag, jsch.value, jshape,
                                                   jeps, str(jdtype))


@pytest.mark.parametrize("scheme", ALL)
def test_slab_summaries_match_reference_at_every_stage(scheme):
    """Per-slab and merged summaries equal the reference's leaf for leaf,
    bitwise, at every feasible stage, ± region; the reduction over the full
    decompression too."""
    jt, pt, _ = _pair_streams(scheme, n_slabs=3)
    for region in (None, REGION):
        for stage in _feasible(scheme):
            js = [joplib.summarize_slab(s, JStage(int(stage)), region=region)
                  for s in jt.slabs]
            ps = [summarize_slab(s, stage, region=region) for s in pt.slabs]
            for a, b in zip(ps, js):
                _same_summary(a, b)
                assert a.sig() == b.sig() and a.nbytes == b.nbytes
            jm = functools.reduce(joplib.merge_summaries, js)
            pm = functools.reduce(merge_summaries, ps)
            _same_summary(pm, jm)
            _same_summary(pm, summary_from_q(pt.decompress_q(region)))
        _same(pt.decompress_q(region), jt.decompress_q(region))


@pytest.mark.parametrize("scheme", ALL)
def test_store_served_bit_identical_to_full_decompression(scheme):
    """Incrementally appended + merged summaries answer every temporal op
    bit-identically to the port's one reduction over the concatenated
    decompression after every append, at every feasible stage, ± region;
    against the reference's reference within the stated tolerances."""
    eng = BatchedAnalytics()
    store = StreamFieldStore(engine=eng)
    tf = TemporalField(scheme, rel_eb=1e-3, device="cpu")
    jt = jstream.TemporalField(scheme, rel_eb=1e-3)
    store.put_temporal("sim/T", tf)
    for i in range(4):
        store.append("sim/T", _slab(i))
        jt.append(_slab(i))
        for stage in _feasible(scheme):
            for region in (None, REGION):
                ref = tf.reference(TOPS, region=region)
                got = query(["sim/T"], list(TOPS), stage=stage, store=store,
                            engine=eng, region=region)
                for op in TOPS:
                    _same(got.values[0][op], ref[op])
                    assert got.stages[0][op] == stage
    for region in (None, REGION):
        summary = store.temporal_summary("sim/T", region=region)
        _same_summary(summary, joplib.summary_from_q(jt.decompress_q(region)))
        jref = jt.reference(TOPS, region=region)
        got = query(["sim/T"], list(TOPS), store=store, engine=eng,
                    region=region).values[0]
        for op in TOPS:
            _close_op(op, got[op], jref[op], summary, tf.eps)
    assert store.incremental_merges == 2 * 3


@pytest.mark.parametrize("scheme", ALL)
def test_storeless_and_single_op_match_fused(scheme):
    jt, tf, _ = _pair_streams(scheme)
    eng = BatchedAnalytics()
    fused = query([tf], list(TOPS), engine=eng)
    jfused = janalytics.query([jt], list(TOPS), engine=JBatched())
    summary = summary_from_q(tf.decompress_q())
    for op in TOPS:
        single = query([tf], op, engine=eng)
        _same(single.values[0], fused.values[0][op])
        assert single.stages[0] == fused.stages[0][op]
        assert int(fused.stages[0][op]) == int(jfused.stages[0][op])
        _close_op(op, fused.values[0][op], jfused.values[0][op], summary,
                  tf.eps)


def test_summaries_identical_across_stages_and_slabs():
    """The per-slab summary is the same integers at every feasible stage,
    and merging slab summaries equals summarizing the concatenation."""
    _, tf, _ = _pair_streams("hszx_nd", n_slabs=3)
    full = summary_from_q(tf.decompress_q())
    for stage in _feasible("hszx_nd"):
        merged = functools.reduce(
            merge_summaries, [summarize_slab(s, stage) for s in tf.slabs])
        _same_summary(merged, full)


#: |q| past 46341 makes q² pass 2^31: the int32 Σq² must wrap as XLA's does
WRAP_CASES = [(3, 1000), (1, 60000), (3, 60000), (2, 2**31 - 1)]


@pytest.mark.parametrize("k,q_abs", WRAP_CASES,
                         ids=[f"k{k}-q{q}" for k, q in WRAP_CASES])
def test_summary_from_q_matches_reference_modulo_2_32(k, q_abs):
    rng = np.random.default_rng(k + q_abs % 97)
    q = rng.integers(-q_abs, q_abs, (k, 17, 9), dtype=np.int64).astype(
        np.int32)
    q[0, 0, 0] = q_abs  # the extreme is present
    got = summary_from_q(torch.as_tensor(q))
    ref = joplib.summary_from_q(jnp.asarray(q))
    _same_summary(got, ref)
    assert got.sig() == ref.sig()
    if q_abs > 46341:
        exact = (q.astype(np.int64) ** 2).sum(0)
        assert np.any(exact > 2**31 - 1)  # the case really wraps
        np.testing.assert_array_equal(
            got.q_sumsq.numpy(),
            ((exact + 2**31) % 2**32 - 2**31).astype(np.int32))


@pytest.mark.parametrize("order", ["k1-then-k3", "k3-then-k1", "k1-then-k1"])
def test_merge_of_one_and_three_step_slabs(order):
    """``last2`` of a one-step slab is duplicated; a merge whose right side
    has one step takes ``a.last2[1]`` and ``b.last2[1]`` — in both orders,
    as the reference's does, and equal to one reduction over both."""
    ks = {"k1-then-k3": (1, 3), "k3-then-k1": (3, 1),
          "k1-then-k1": (1, 1)}[order]
    rng = np.random.default_rng(len(order))
    qa, qb = (rng.integers(-500, 500, (k, 11, 7), dtype=np.int64)
              .astype(np.int32) for k in ks)
    got = merge_summaries(summary_from_q(torch.as_tensor(qa)),
                          summary_from_q(torch.as_tensor(qb)))
    ref = joplib.merge_summaries(joplib.summary_from_q(jnp.asarray(qa)),
                                 joplib.summary_from_q(jnp.asarray(qb)))
    _same_summary(got, ref)
    _same_summary(got, summary_from_q(torch.as_tensor(
        np.concatenate([qa, qb]))))
    eps = torch.tensor(0.01, dtype=torch.float32)
    out = oplib.temporal_postlude(TOPS, got, eps)
    jout = joplib.temporal_postlude(TOPS, ref, jnp.float32(0.01))
    for op in TOPS:
        _close_op(op, out[op], jout[op], got, eps)


def test_temporal_accuracy_vs_raw_data():
    """Sanity against the uncompressed stream: every op lands within the
    error bound's reach of the raw statistic."""
    _, tf, raw = _pair_streams("hszp_nd", n_slabs=5)
    eps = float(tf.eps)
    v = query([tf], list(TOPS)).values[0]
    assert np.abs(_np(v["tmean"]) - raw.mean(0)).max() <= 2 * eps
    assert np.abs(_np(v["tmin"]) - raw.min(0)).max() <= 2 * eps
    assert np.abs(_np(v["tmax"]) - raw.max(0)).max() <= 2 * eps
    assert np.abs(_np(v["tdelta"]) - (raw[-1] - raw[-2])).max() <= 3 * eps
    assert np.abs(_np(v["tstd"]) - raw.std(0, ddof=1)).max() <= 5e-3


# -- appends: in-place refresh, no collateral invalidation --------------------

def test_appends_never_invalidate_unrelated_materializations(field_2d):
    eng = BatchedAnalytics()
    store = StreamFieldStore(engine=eng)
    c = by_name("hszx_nd").compress(field_2d, rel_eb=1e-3, device="cpu")
    store.put("static/field", c)
    store.ensure("static/field", Stage.Q)
    tf = TemporalField("hszx_nd", rel_eb=1e-3, device="cpu")
    store.put_temporal("sim/T", tf)
    store.append("sim/T", _slab(0))
    query(["sim/T"], "tmean", store=store, engine=eng)   # summary resident
    entries0 = store.cache_entries
    ev0 = store.stats.evictions
    for i in range(1, 4):
        store.append("sim/T", _slab(i))
    assert store.cache_entries == entries0
    assert store.stats.evictions == ev0
    assert store.lookup("static/field", Stage.Q) is not None
    assert store.incremental_merges == 3
    _same(query(["sim/T"], "tmean", store=store, engine=eng).values[0],
          tf.reference(["tmean"])["tmean"])


def test_append_byte_accounting_stays_exact():
    """The port's resident bytes equal the sum of its cells and the
    reference's store's bytes, append by append."""
    store = StreamFieldStore(engine=BatchedAnalytics())
    jstore = jstream.StreamFieldStore(engine=JBatched())
    tf = TemporalField("hszp_nd", rel_eb=1e-3, device="cpu")
    jt = jstream.TemporalField("hszp_nd", rel_eb=1e-3)
    store.put_temporal("s", tf)
    jstore.put_temporal("s", jt)
    store.append("s", _slab(0))
    jstore.append("s", _slab(0))
    for region in (None, REGION):
        store.temporal_summary("s", region=region)
        jstore.temporal_summary("s", region=region)
    for i in range(1, 4):
        store.append("s", _slab(i))
        jstore.append("s", _slab(i))
        assert store.cache_bytes_in_use == sum(
            m.nbytes for m in store._cache.values())
        assert store.cache_bytes_in_use == jstore.cache_bytes_in_use
    assert store.incremental_merges == jstore.incremental_merges == 6


def test_append_survives_cross_cell_eviction_under_budget_pressure():
    """Refreshing one resident summary can evict a sibling cell of the same
    stream under a tight budget; the append skips the evicted cell (the next
    query rebuilds it), every survivor stays exact, and the counters move as
    the reference's do."""
    eng = BatchedAnalytics()
    store = StreamFieldStore(engine=eng)
    jstore = jstream.StreamFieldStore(engine=JBatched())
    tf = TemporalField("hszx_nd", rel_eb=1e-3, device="cpu")
    jt = jstream.TemporalField("hszx_nd", rel_eb=1e-3)
    store.put_temporal("s", tf)
    jstore.put_temporal("s", jt)
    for st in (store, jstore):
        st.append("s", _slab(0))
        st.temporal_summary("s")                   # full-field cell
        st.temporal_summary("s", region=REGION)    # region cell
        assert st.cache_entries == 2
        st.cache_bytes = st.cache_bytes_in_use - 1  # holds ~one cell
    for i in range(1, 4):
        store.append("s", _slab(i))
        jstore.append("s", _slab(i))
        assert store.cache_bytes_in_use <= store.cache_bytes
        assert store.cache_bytes_in_use == sum(
            m.nbytes for m in store._cache.values())
        assert store.cache_entries == jstore.cache_entries
    assert (store.incremental_merges, store.stats.evictions) == (
        jstore.incremental_merges, jstore.stats.evictions)
    for region in (None, REGION):
        got = query(["s"], "tmean", store=store, engine=eng, region=region)
        _same(got.values[0], tf.reference(["tmean"], region=region)["tmean"])


def test_tstd_single_timestep_is_zero_not_nan():
    """Frame-at-a-time streaming: a one-timestep stream has zero spread, not
    NaN (the ddof=1 denominator is clamped until a second frame arrives)."""
    tf = TemporalField("hszx_nd", rel_eb=1e-3, device="cpu")
    jt = jstream.TemporalField("hszx_nd", rel_eb=1e-3)
    tf.append(_slab(0, k=1))
    jt.append(_slab(0, k=1))
    v = query([tf], ["tstd", "tmean", "tdelta"]).values[0]
    assert torch.all(v["tstd"] == 0.0)
    assert torch.all(v["tdelta"] == 0.0)   # duplicated last2 frame
    assert bool(torch.isfinite(v["tmean"]).all())
    jv = janalytics.query([jt], ["tstd", "tmean", "tdelta"]).values[0]
    _same(v["tstd"], jv["tstd"])
    tf.append(_slab(1, k=1))
    raw = np.concatenate([_slab(0, k=1), _slab(1, k=1)], axis=0)
    got = _np(query([tf], "tstd").values[0])
    assert np.isfinite(got).all()
    assert np.abs(got - raw.std(0, ddof=1)).max() <= 2 * float(tf.eps)


def test_per_op_calibrated_plan_collapses_to_one_shared_stage():
    """A calibrated model pricing temporal ops cheapest at different stages
    triggers the per-op fallback; the temporal path collapses it to one
    shared feasible stage, as the reference's does."""
    scheme = Scheme.HSZP                 # 1-D: feasible stages Q, F
    cm = CostModel()
    for op, q_us, f_us in (("tmean", 10.0, 500.0), ("tstd", 500.0, 10.0)):
        cm.record(scheme, op, Stage.Q, q_us)
        cm.record(scheme, op, Stage.F, f_us)
    plan = analytics.plan_stages(scheme, ["tmean", "tstd"], cost_model=cm)
    assert plan.fused is None            # the fallback actually fires
    _, tf, _ = _pair_streams("hszp", n_slabs=2)
    res = query([tf], ["tmean", "tstd"], cost_model=cm)
    ref = tf.reference(["tmean", "tstd"])
    for op in ("tmean", "tstd"):
        _same(res.values[0][op], ref[op])
    assert res.stages[0]["tmean"] == res.stages[0]["tstd"] == Stage.Q


def test_summary_eviction_degrades_to_recompute_not_wrong_answers():
    """A summary the budget rejects is rebuilt from all slabs on the next
    query — bit-identical to the incrementally maintained one."""
    eng = BatchedAnalytics()
    store = StreamFieldStore(cache_bytes=16, engine=eng)  # nothing fits
    tf = TemporalField("hszx_nd", rel_eb=1e-3, device="cpu")
    store.put_temporal("s", tf)
    for i in range(3):
        store.append("s", _slab(i))
    res = query(["s"], ["tmean", "tstd"], store=store, engine=eng)
    assert store.cache_entries == 0 and store.stats.rejected >= 1
    ref = tf.reference(["tmean", "tstd"])
    for op in ("tmean", "tstd"):
        _same(res.values[0][op], ref[op])
    # a budget that holds the cell: built once, then merged into
    hot = StreamFieldStore(engine=eng)
    tf2 = TemporalField("hszx_nd", rel_eb=1e-3, device="cpu")
    hot.put_temporal("s", tf2)
    hot.append("s", _slab(0))
    hot.temporal_summary("s")
    for i in range(1, 3):
        hot.append("s", _slab(i))
    _same_summary(hot.temporal_summary("s"), store.temporal_summary("s"))


# -- steady state: appends are served from the resident summary ---------------

def test_steady_state_appends_and_queries_build_nothing_new():
    """After one warm append+query cycle, further appends + queries serve
    from the resident merged summary, with the reference's dispatch count
    on the same sequence."""
    eng, jeng = BatchedAnalytics(), JBatched()
    store = StreamFieldStore(engine=eng)
    jstore = jstream.StreamFieldStore(engine=jeng)
    tf = TemporalField("hszp_nd", rel_eb=1e-3, bits=12, device="cpu")
    jt = jstream.TemporalField("hszp_nd", rel_eb=1e-3, bits=12)
    store.put_temporal("s", tf)
    jstore.put_temporal("s", jt)
    for i in range(7):
        store.append("s", _slab(i))
        jstore.append("s", _slab(i))
        res = query(["s"], list(TOPS), store=store, engine=eng)
        jres = janalytics.query(["s"], list(TOPS), store=jstore, engine=jeng)
        assert res.n_dispatches == jres.n_dispatches
        if i >= 2:
            assert res.store_hits >= 1 and res.store_misses == 0
    _same(query(["s"], "tmean", store=store, engine=eng).values[0],
          tf.reference(["tmean"])["tmean"])


def test_dispatch_accounting_matches_reference():
    """``n_dispatches`` / ``n_batches`` count as the reference's do."""
    jt1, t1, _ = _pair_streams("hszp_nd", n_slabs=3)
    jt2, t2, _ = _pair_streams("hszx_nd", n_slabs=3)
    for fields, jfields in (([t1, t1], [jt1, jt1]), ([t1, t2], [jt1, jt2])):
        res = query_temporal(fields, "tmean")
        jres = jstream.query_temporal(jfields, "tmean")
        assert (res.n_batches, res.n_dispatches) == (jres.n_batches,
                                                     jres.n_dispatches)


# -- planner / feasibility ----------------------------------------------------

@functools.lru_cache(maxsize=None)
def _encoded_slab(scheme):
    comp = by_name(scheme)
    return comp.encode(comp.compress(_slab(0), rel_eb=1e-3, device="cpu"))


@pytest.mark.parametrize("scheme", ALL)
@pytest.mark.parametrize("op", TOPS)
@pytest.mark.parametrize("stage", list(Stage))
def test_temporal_feasibility_matrix_matches_ops(scheme, op, stage):
    """Every temporal Table-I cell: the port's row is the reference's, and
    feasible <=> the summarizer does not raise."""
    jrow = janalytics.FEASIBILITY[(janalytics.planner.Scheme(scheme), op)]
    row = analytics.FEASIBILITY[(Scheme(scheme), op)]
    assert [int(s) for s in row] == [int(s) for s in jrow]
    e = _encoded_slab(scheme)
    if analytics.is_feasible(Scheme(scheme), op, stage):
        s = summarize_slab(e, stage)
        assert all(x.dtype == torch.int32 for x in s.leaves())
    else:
        with pytest.raises(UnsupportedStageError):
            summarize_slab(e, stage)


def test_explicit_infeasible_stage_rejected_before_any_work():
    _, tf, _ = _pair_streams("hszp")            # 1-D scheme: no stage ②
    with pytest.raises(UnsupportedStageError):
        query([tf], "tmean", stage=Stage.P)
    with pytest.raises(UnsupportedStageError):
        query([tf], "tmean", stage=Stage.M)


def test_mixed_arity_op_sets_rejected():
    with pytest.raises(ValueError, match="different arities"):
        oplib.canonical_ops(["mean", "tmean"])
    with pytest.raises(ValueError, match="different arities"):
        oplib.canonical_ops(["tdelta", "curl"])
    assert oplib.canonical_ops(["tstd", "tdelta", "tmean"]) == (
        joplib.canonical_ops(["tstd", "tdelta", "tmean"]))


def test_plan_refresh_costing():
    cm = CostModel()
    cm.record_reconstruction(Scheme.HSZP_ND, Stage.Q, 80.0)
    plan = analytics.plan_refresh(Scheme.HSZP_ND, Stage.Q, 5, cm)
    assert plan.mode == "incremental"
    assert plan.incremental_us == 80.0 and plan.recompute_us == 400.0
    cold = analytics.plan_refresh(Scheme.HSZP_ND, Stage.Q, 5, cm,
                                  summary_resident=False)
    assert cold.mode == "recompute"
    assert analytics.plan_refresh(Scheme.HSZX, Stage.Q, 3).mode == "incremental"
    with pytest.raises(ValueError):
        analytics.plan_refresh(Scheme.HSZX, Stage.Q, 0)


def test_registry_and_exports_match_reference():
    assert stream.__all__ == jstream.__all__
    assert analytics.TEMPORAL == janalytics.TEMPORAL
    assert tuple(oplib.TEMPORAL_OPS) == tuple(joplib.TEMPORAL_OPS)
    for name, spec in oplib.TEMPORAL_OPS.items():
        ref = joplib.TEMPORAL_OPS[name]
        assert (spec.arity, spec.category) == (ref.arity, ref.category)
        assert oplib.spec_violations(spec) == []
        for scheme in ALL:
            assert [int(s) for s in spec.feasible(Scheme(scheme))] == [
                int(s) for s in ref.feasible(janalytics.planner.Scheme(scheme))]
    bad = oplib.OpSpec("t_without_rule", "temporal", "temporal",
                       lambda s: (Stage.Q,))
    with pytest.raises(ValueError, match="lower_temporal"):
        oplib.register_op(bad)
    assert "t_without_rule" not in oplib._ALL_OPS


# -- guards -------------------------------------------------------------------

def test_eps_pinned_across_slabs():
    tf = TemporalField("hszx_nd", rel_eb=1e-3, device="cpu")
    jt = jstream.TemporalField("hszx_nd", rel_eb=1e-3)
    for t in (tf, jt):
        t.append(_slab(0))
    eps0 = float(tf.eps)
    for t in (tf, jt):
        t.append(10.0 * _slab(1))   # very different range: eps must not move
    assert float(tf.eps) == eps0 == float(jt.eps)
    assert float(tf.slabs[1].eps) == eps0
    _cpu_containers_equal(jt.slabs[1], tf.slabs[1])


def test_slab_wider_than_pinned_width():
    """A slab whose residuals exceed the pinned width is encoded at its own
    exact width (as the reference's), and stays exact."""
    jt = jstream.TemporalField("hszp_nd", rel_eb=1e-3, bits=4)
    tf = TemporalField("hszp_nd", rel_eb=1e-3, bits=4, device="cpu")
    for i in range(2):
        jt.append(_slab(i))
        tf.append(_slab(i))
    wide = np.random.default_rng(5).normal(0, 3, (3,) + SPATIAL).astype(
        np.float32)
    jt.append(wide)
    tf.append(wide)
    assert [s.bits for s in tf.slabs] == [s.bits for s in jt.slabs]
    assert tf.slabs[-1].bits > 4
    for js, ps in zip(jt.slabs, tf.slabs):
        _cpu_containers_equal(js, ps)
    summary = summary_from_q(tf.decompress_q())
    _same_summary(summary, joplib.summary_from_q(jt.decompress_q()))
    got = query([tf], list(TOPS)).values[0]
    for op in TOPS:
        _same(got[op], tf.reference([op])[op])


def test_shape_and_rank_validation():
    tf = TemporalField("hszx_nd", rel_eb=1e-3, device="cpu")
    tf.append(_slab(0))
    with pytest.raises(ValueError, match="spatial shape"):
        tf.append(np.zeros((3, 8, 8), np.float32))
    with pytest.raises(ValueError, match="time slab"):
        TemporalField("hszx_nd", rel_eb=1e-3, device="cpu").append(
            np.zeros((5,), np.float32))
    with pytest.raises(ValueError, match="bits"):
        TemporalField("hszx_nd", rel_eb=1e-3, bits="wide", device="cpu")
    with pytest.raises(ValueError, match="no slab"):
        TemporalField("hszx_nd", rel_eb=1e-3, device="cpu").decompress_q()


def test_temporal_ops_reject_spatial_fields_and_vice_versa(field_2d):
    c = by_name("hszx_nd").compress(field_2d, rel_eb=1e-3, device="cpu")
    with pytest.raises(TypeError, match="TemporalField"):
        query([c], "tmean")
    _, tf, _ = _pair_streams("hszx_nd", n_slabs=1)
    with pytest.raises(TypeError, match="temporal ops"):
        query([tf], "mean")
    with pytest.raises(ValueError, match="temporal op set"):
        oplib.compute(c, "tmean", Stage.Q)


def test_empty_stream_and_missing_store_rejected():
    tf = TemporalField("hszx_nd", rel_eb=1e-3, device="cpu")
    with pytest.raises(ValueError, match="no appended slabs"):
        query_temporal([tf], "tmean")
    with pytest.raises(ValueError, match="no store"):
        query_temporal(["some/id"], "tmean")
    with pytest.raises(TypeError, match="put_temporal"):
        StreamFieldStore().put("x", tf)
    store = FieldStore()
    tf.append(_slab(0))
    store._fields["s"] = tf  # a plain store holding a stream by hand
    with pytest.raises(TypeError, match="StreamFieldStore"):
        query_temporal(["s"], "tmean", store=store)


def test_temporal_field_registry_semantics():
    store = StreamFieldStore()
    tf = TemporalField("hszx_nd", rel_eb=1e-3, device="cpu")
    store.put_temporal("s", tf)
    assert store.is_temporal("s") and "s" in store
    with pytest.raises(ValueError, match="already registered"):
        store.put_temporal("s", tf)
    tf.append(_slab(0))
    store.temporal_summary("s")
    assert store.cache_entries == 1 and store.summary_rebuilds == 1
    tf2 = TemporalField("hszx_nd", rel_eb=1e-3, device="cpu")
    store.put_temporal("s", tf2, replace=True)
    assert store.cache_entries == 0          # stale summary invalidated
    store.remove("s")
    assert "s" not in store
    with pytest.raises(TypeError, match="TemporalField"):
        StreamFieldStore().put_temporal("x", np.zeros(3))
    plain = StreamFieldStore()
    plain.put("f", by_name("hszx").compress(_slab(0)[0], rel_eb=1e-3,
                                            device="cpu"))
    with pytest.raises(TypeError, match="not a temporal field"):
        plain.append("f", _slab(0))


# -- capacity -----------------------------------------------------------------

def test_summary_capacity_matches_reference():
    grid = (0, 1, 2, 255, 500, 4095, 4096, 46340, 46341, 2**15, 2**20,
            2**31 - 1)
    for q_abs in grid:
        assert summary_capacity(q_abs) == jtemporal.summary_capacity(q_abs)
    assert summary_capacity(4095) == 128
    for bad in (summary_capacity, jtemporal.summary_capacity):
        with pytest.raises(ValueError):
            bad(-1)


def test_capacity_guard_raises_before_mutation():
    """A tiny eps drives |q| to ~2^15, so capacity is a few timesteps: both
    packages refuse the same append, before the stream changes."""
    data = np.linspace(0.5, 1.0, 256, dtype=np.float32).reshape(1, 256)
    tf = TemporalField("hszx", eps=2**-16, device="cpu")
    jt = jstream.TemporalField("hszx", eps=2**-16)
    for t in (tf, jt):
        t.append(data)
    assert tf._q_abs_max == jt._q_abs_max
    cap = summary_capacity(tf._q_abs_max)
    assert 1 <= cap <= 8, f"fixture drifted: capacity {cap}"
    while tf.n_steps < cap:
        tf.append(data)
        jt.append(data)
    before = (tf.n_steps, tf.n_slabs, tf._q_abs_max, tf._bits, float(tf.eps))
    with pytest.raises(SummaryCapacityError, match="capacity"):
        tf.append(data)
    with pytest.raises(jtemporal.SummaryCapacityError, match="capacity"):
        jt.append(data)
    assert (tf.n_steps, tf.n_slabs, tf._q_abs_max, tf._bits,
            float(tf.eps)) == before
    # a stream whose very first slab is over capacity pins nothing
    fresh = TemporalField("hszx", eps=2**-16, device="cpu")
    with pytest.raises(SummaryCapacityError):
        fresh.append(np.repeat(data, cap + 1, axis=0))
    assert fresh.n_slabs == 0 and fresh._spatial_shape is None
    assert fresh._bits == "auto"


def test_growing_q_tightens_capacity():
    small = np.full((1, 256), 0.25, dtype=np.float32)
    big = np.linspace(0.5, 4.0, 256, dtype=np.float32).reshape(1, 256)
    tf = TemporalField("hszx", eps=2**-16, device="cpu")
    jt = jstream.TemporalField("hszx", eps=2**-16)
    for t in (tf, jt):
        t.append(small)
    cap_small = summary_capacity(tf._q_abs_max)
    q_big = int(np.max(np.abs(np.round(big / 2**-15))))
    if tf.n_steps + 1 > summary_capacity(q_big):
        with pytest.raises(SummaryCapacityError):
            tf.append(big)
        with pytest.raises(jtemporal.SummaryCapacityError):
            jt.append(big)
        assert tf._q_abs_max == jt._q_abs_max < q_big  # not mutated
    else:
        for t in (tf, jt):
            t.append(big)
        assert tf._q_abs_max == jt._q_abs_max == q_big
        assert summary_capacity(tf._q_abs_max) <= cap_small


# -- crossing between the packages --------------------------------------------

@pytest.mark.parametrize("scheme", ALL)
def test_temporal_from_arrays_carries_reference_stream(scheme):
    """The reference's stream carried across answers like it, and appends
    to both continue identically."""
    jt, _, _ = _pair_streams(scheme, n_slabs=2)
    tf = _carry(jt)
    assert (tf.n_slabs, tf.n_steps, tf.shape, tf._bits, tf._q_abs_max) == (
        jt.n_slabs, jt.n_steps, jt.shape, jt._bits, jt._q_abs_max)
    assert float(tf.eps) == float(jt.eps)
    for region in (None, REGION):
        summary = summary_from_q(tf.decompress_q(region))
        _same_summary(summary, joplib.summary_from_q(jt.decompress_q(region)))
        got = query([tf], list(TOPS), region=region).values[0]
        ref = jt.reference(TOPS, region=region)
        for op in TOPS:
            _close_op(op, got[op], ref[op], summary, tf.eps)
    jt.append(_slab(2))
    tf.append(_slab(2))
    _cpu_containers_equal(jt.slabs[-1], tf.slabs[-1])
    _same_summary(summary_from_q(tf.decompress_q()),
                  joplib.summary_from_q(jt.decompress_q()))


def test_summary_from_arrays_round_trip():
    jt, tf, _ = _pair_streams("hszp_nd", n_slabs=2)
    js = joplib.summary_from_q(jt.decompress_q())
    s = convert.summary_from_arrays(
        {n: np.asarray(getattr(js, n)) for n in LEAF_NAMES}, device="cpu")
    _same_summary(s, js)
    out = oplib.temporal_postlude(TOPS, s, tf.eps)
    for op in TOPS:
        _same(out[op], tf.reference([op])[op])


# -- on the card ----------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


#: one Ocean time slab: 8 timesteps of 2400 x 3600 — 69,120,000 values,
#: 8x the largest unpack launch of the spatial paths
SLAB_VALUES = 8 * 2400 * 3600


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [9, 17, 31])
def test_unpack_residuals_at_slab_size_on_card(bits):
    """The decode's unpack kernel on one Ocean slab's payload, bitwise its
    plain version (widths below and above 16, and 31, whose bit offsets
    come within 0.3% of 2^31)."""
    dev = _card()
    rng = np.random.default_rng(bits)
    u = torch.as_tensor(rng.integers(0, 1 << bits, SLAB_VALUES,
                                     dtype=np.int64).astype(np.int32),
                        device=dev)
    words = encode.pack_uniform(u, bits)
    before = ops.LAUNCHES["unpack.residuals"]
    got = bitpack.unpack_residuals(words, SLAB_VALUES, bits)
    assert ops.LAUNCHES["unpack.residuals"] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, encode.unzigzag(u))


@pytest.mark.gpu
@pytest.mark.parametrize("scheme", ["hszp_nd", "hszx_nd"])
def test_stream_on_card_matches_cpu(scheme):
    """A stream on the card: summaries bitwise the CPU port's, served ==
    reference bitwise, one unpack per Encoded slab summarized."""
    dev = _card()
    store = StreamFieldStore(engine=BatchedAnalytics())
    tf = TemporalField(scheme, rel_eb=1e-3, device=dev)
    cpu = TemporalField(scheme, rel_eb=1e-3, device="cpu")
    store.put_temporal("s", tf)
    for i in range(3):
        store.append("s", _slab(i, k=8))
        cpu.append(_slab(i, k=8))
        if i == 0:
            store.temporal_summary("s")
    before = ops.LAUNCHES["unpack.residuals"]
    store.append("s", _slab(3, k=8))
    cpu.append(_slab(3, k=8))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["unpack.residuals"] == before + 1
    summary = store.temporal_summary("s")
    want = summary_from_q(cpu.decompress_q())
    for name in LEAF_NAMES:
        assert torch.equal(getattr(summary, name).cpu(), getattr(want, name))
    ref = tf.reference(TOPS)
    got = query(["s"], list(TOPS), store=store).values[0]
    for op in TOPS:
        assert torch.equal(got[op], ref[op])
