"""The port's ``FieldStore`` and store-backed queries against the JAX
reference (``repro.store``, ``repro.analytics``).

The same numpy fields are compressed by the reference and carried into the
port with ``convert.from_arrays``.  What is held, with its tolerance:

* inside the port, **bitwise**: store-backed (seeded) query results equal
  storeless ones for every (scheme, op set, stage, ± region) cell, field
  and vector arity, ``Compressed`` and ``Encoded``; a seeded engine call
  answers as its cold twin on the same engine;
* against the reference, **exactly**: cache-aware plans (uncalibrated and
  calibrated), store hit / miss / eviction / rejection counts, resident
  byte counts and LRU order replayed step by step, ``cached_stages`` rows,
  ``CostModel`` JSON in both directions (each package loads the other's
  ``save``), and ``n_dispatches`` after the same sequence.

The serve-side tests of ``tests/test_store.py`` are mirrored in
``tests/test_torch_serve.py``.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import analytics as janalytics
from repro.core import Scheme as JScheme
from repro.core import Stage as JStage
from repro.core import by_name as jax_by_name
from repro.core import oplib as joplib
from repro.store import FieldStore as JFieldStore
from repro_torch import analytics, convert
from repro_torch.analytics import BatchedAnalytics, CostModel, query
from repro_torch.core import Scheme, Stage, by_name, oplib
from repro_torch.core import homomorphic as H
from repro_torch.core.stages import LEAVES
from repro_torch.store import (MATERIALIZABLE, FieldStore, materialize,
                               materialized_nbytes)

ALL = ["hszp", "hszx", "hszp_nd", "hszx_nd"]
REGION = ((30, 75), (10, 52))  # unaligned window of the 181 x 97 field_2d
VREGION = ((20, 60), (40, 90))
FUSED_SETS = [("mean",), ("mean", "std"), ("mean", "std", "laplacian"),
              ("std", "derivative"), ("mean", "gradient")]

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


def to_port(jc):
    """The reference container ``jc`` as the port's, on the CPU."""
    kind = type(jc).__name__
    arrays = {n: np.asarray(getattr(jc, n)) for n in LEAVES[kind]}
    meta = {"scheme": jc.scheme.value, "shape": jc.shape,
            "padded_shape": jc.padded_shape, "block": jc.block,
            "orig_dtype": np.dtype(jc.orig_dtype).name}
    if kind == "Encoded":
        meta["bits"] = jc.bits
    return convert.from_arrays(kind, arrays, meta, device="cpu")


def _pair(scheme, data, rel_eb=1e-3):
    jc = jax_by_name(scheme).compress(jnp.asarray(data), rel_eb=rel_eb)
    return jc, to_port(jc)


def _c(scheme, data, rel_eb=1e-3):
    return _pair(scheme, data, rel_eb)[1]


def _encode(c):
    return by_name(c.scheme.value, c.block).encode(c)


def _compress_many(scheme, n, shape=(64, 48), rel_eb=1e-3, seed=0):
    rng = np.random.default_rng(seed)
    comp = jax_by_name(scheme)
    js = [comp.compress(jnp.asarray(rng.normal(0, 1, shape).astype(np.float32)),
                        rel_eb=rel_eb) for _ in range(n)]
    return js, [to_port(c) for c in js]


def _shared_stages(scheme, ops):
    return [s for s in Stage if s != Stage.M
            if all(s in analytics.feasible_stages(scheme, op) for op in ops)]


def _assert_same(got, ref):
    if isinstance(ref, tuple):
        assert isinstance(got, tuple) and len(got) == len(ref)
        for g, r in zip(got, ref):
            _assert_same(g, r)
    else:
        assert (got.shape, got.dtype) == (ref.shape, ref.dtype)
        assert got.numpy().tobytes() == ref.numpy().tobytes()



def _ints(stages):
    return sorted(int(s) for s in stages)


# -- store-backed queries: bit-identical to storeless --------------------------

@pytest.mark.parametrize("scheme", ALL)
@pytest.mark.parametrize("ops", FUSED_SETS, ids="+".join)
def test_store_backed_bit_identical(scheme, ops, field_2d):
    c = _c(scheme, field_2d)
    e = _encode(c)
    for field in (c, e):
        store = FieldStore()
        store.put("f", field)
        eng = BatchedAnalytics()
        for stage in _shared_stages(c.scheme, ops):
            for region in (None, REGION):
                ref = query([field], list(ops), stage=stage, engine=eng,
                            region=region)
                got = query(["f"], list(ops), stage=stage, engine=eng,
                            region=region, store=store)
                hot = query(["f"], list(ops), stage=stage, engine=eng,
                            region=region, store=store)
                # first call misses (unless stage ④ reuses the ③ entry),
                # second is always served resident
                assert got.store_misses + got.store_hits >= 1
                assert hot.store_misses == 0 and hot.store_hits >= 1
                for op in ops:
                    _assert_same(got.values[0][op], ref.values[0][op])
                    _assert_same(hot.values[0][op], ref.values[0][op])


@pytest.mark.parametrize("scheme", ["hszp_nd", "hszx_nd"])
@pytest.mark.parametrize("ops", [("divergence",), ("divergence", "curl")],
                         ids="+".join)
def test_store_backed_vector_bit_identical(scheme, ops, vector_field_2d):
    u, v = vector_field_2d
    cu, cv = _c(scheme, u), _c(scheme, v)
    store = FieldStore()
    store.put("u", cu)
    store.put("v", cv)
    eng = BatchedAnalytics()
    for stage in _shared_stages(cu.scheme, ops):
        for r in (None, VREGION):
            ref = query([(cu, cv)], list(ops), stage=stage, engine=eng,
                        region=r)
            for _ in range(2):  # miss pass, then hit pass
                got = query([("u", "v")], list(ops), stage=stage, engine=eng,
                            region=r, store=store)
                for op in ops:
                    _assert_same(got.values[0][op], ref.values[0][op])
            assert got.store_hits >= 2  # both components served hot


def test_store_backed_batch_and_mixed_inputs():
    """Ids and raw containers mix in one query; ids group separately (only
    they can seed) but every value matches the storeless result, and the
    counts are the reference's."""
    js, cs = _compress_many("hszp_nd", 4)
    store, jstore = FieldStore(), JFieldStore()
    for i in range(2):
        store.put(f"f{i}", cs[i])
        jstore.put(f"f{i}", js[i])
    eng = BatchedAnalytics()
    ref = query(cs, ["mean", "std"], stage=Stage.P, engine=eng)
    got = query(["f0", "f1", cs[2], cs[3]], ["mean", "std"], stage=Stage.P,
                engine=eng, store=store)
    jgot = janalytics.query(["f0", "f1", js[2], js[3]], ["mean", "std"],
                            stage=JStage.P, store=jstore)
    assert got.n_batches == jgot.n_batches == 2  # store-backed vs raw split
    assert (got.n_dispatches, got.store_hits, got.store_misses) == (
        jgot.n_dispatches, jgot.store_hits, jgot.store_misses)
    for i in range(4):
        for op in ("mean", "std"):
            _assert_same(got.values[i][op], ref.values[i][op])


def test_seeded_engine_program_is_separate_and_equal():
    js, cs = _compress_many("hszp_nd", 3)
    eng, jeng = BatchedAnalytics(), janalytics.BatchedAnalytics()
    store, jstore = FieldStore(), JFieldStore()
    ids = [store.put(f"f{i}", c) for i, c in enumerate(cs)]
    for i, c in enumerate(js):
        jstore.put(f"f{i}", c)
    cold = query(cs, "std", stage=Stage.Q, engine=eng)
    jcold = janalytics.query(js, "std", stage=JStage.Q, engine=jeng)
    assert cold.n_dispatches == jcold.n_dispatches == 1
    hot = query(ids, "std", stage=Stage.Q, engine=eng, store=store)
    jhot = janalytics.query(ids, "std", stage=JStage.Q, engine=jeng,
                            store=jstore)
    assert hot.n_dispatches == jhot.n_dispatches == 1
    for a, b in zip(cold.values, hot.values):
        _assert_same(b, a)
    again = query(ids, "std", stage=Stage.Q, engine=eng, store=store)
    assert again.store_misses == 0 and again.store_hits >= 1  # hit path
    for a, b in zip(cold.values, again.values):
        _assert_same(b, a)


def test_engine_rejects_mismatched_seeds():
    _, cs = _compress_many("hszp_nd", 2)
    eng = BatchedAnalytics()
    q = [materialize(c, Stage.Q) for c in cs]
    with pytest.raises(ValueError, match="cannot seed a stage-P plan"):
        eng.run(cs, "std", Stage.P, seeds=q)
    with pytest.raises(ValueError, match="1 seeds for 2 fields"):
        eng.run(cs, "std", Stage.Q, seeds=q[:1])
    p = materialize(cs[1], Stage.P)
    with pytest.raises(ValueError, match="one layout signature"):
        eng.run(cs, "std", Stage.Q, seeds=[q[0], p])


def test_vector_op_bare_string_id_rejected(field_2d):
    store = FieldStore()
    store.put("uv", _c("hszp_nd", field_2d))
    with pytest.raises(TypeError, match="per component"):
        query(["uv"], "curl", stage=Stage.Q, store=store)


def test_query_rejects_duplicate_vector_ids_but_allows_raw_duplicates(field_2d):
    store = FieldStore()
    store.put("u", _c("hszp_nd", field_2d))
    with pytest.raises(ValueError, match="duplicate field ids"):
        query([("u", "u")], "curl", stage=Stage.Q, store=store)
    c = _c("hszp_nd", field_2d)
    res = query([(c, c)], "curl", stage=Stage.Q)
    assert bool(torch.isfinite(res.values[0]).all())


# -- cache-aware auto planning ------------------------------------------------

def test_auto_flips_to_cached_stage_uncalibrated(field_2d):
    """Residency alone flips the plan: Lorenzo {mean, std} auto-plans ②
    cold, but a resident stage-③ materialization beats any reconstruction
    — in both packages."""
    jc, c = _pair("hszp_nd", field_2d)
    store, jstore = FieldStore(), JFieldStore()
    store.put("f", c)
    jstore.put("f", jc)
    eng = BatchedAnalytics()
    cold = query([c], ["mean", "std"], engine=eng)
    assert cold.stages[0] == {"mean": Stage.P, "std": Stage.P}
    store.ensure("f", Stage.Q)
    jstore.ensure("f", JStage.Q)
    hot = query(["f"], ["mean", "std"], engine=eng, store=store)
    jhot = janalytics.query(["f"], ["mean", "std"], store=jstore)
    assert hot.stages[0] == {"mean": Stage.Q, "std": Stage.Q}
    assert {k: int(v) for k, v in jhot.stages[0].items()} == {
        k: int(v) for k, v in hot.stages[0].items()}
    assert (hot.store_hits, hot.store_misses) == (jhot.store_hits,
                                                  jhot.store_misses)
    assert hot.store_hits >= 1
    ref = query([c], ["mean", "std"], stage=Stage.Q, engine=eng)
    for op in ("mean", "std"):
        _assert_same(hot.values[0][op], ref.values[0][op])


def test_auto_flip_calibrated_reconstruction_term():
    """A cached stage is priced at cost minus the reconstruction term, which
    flips the choice exactly as in the reference."""
    for pkg, scheme, st in ((analytics, Scheme.HSZP_ND, Stage),
                            (janalytics, JScheme.HSZP_ND, JStage)):
        cm = pkg.CostModel()
        for op in ("mean", "std"):
            cm.record(scheme, op, st.P, 100.0)
            cm.record(scheme, op, st.Q, 120.0)
            cm.record(scheme, op, st.F, 500.0)
        cm.record_reconstruction(scheme, st.Q, 110.0)
        assert pkg.plan_stages(scheme, ["mean", "std"],
                               cost_model=cm).fused == st.P
        plan = pkg.plan_stages(scheme, ["mean", "std"], cost_model=cm,
                               cached=frozenset({st.Q}))
        assert plan.fused == st.Q
        cm.record_reconstruction(scheme, st.P, 500.0)
        assert cm.cost(scheme, "mean", st.P, cached=True) == 0.0


def test_unmeasured_reconstruction_discount_is_conservative():
    scheme = Scheme.HSZP_ND
    cm = CostModel()
    for op, p, q, f in (("mean", 90.0, 130.0, 700.0),
                        ("std", 95.0, 140.0, 700.0)):
        cm.record(scheme, op, Stage.P, p)
        cm.record(scheme, op, Stage.Q, q)
        cm.record(scheme, op, Stage.F, f)
    cm.record_reconstruction(scheme, Stage.Q, 80.0)
    plan = analytics.plan_stages(scheme, ["mean", "std"], cost_model=cm,
                                 cached=frozenset({Stage.Q, Stage.F}))
    assert plan.fused == Stage.Q
    assert cm.cost(scheme, "mean", Stage.F, cached=True) == 620.0
    cm2 = CostModel()
    cm2.record(scheme, "mean", Stage.P, 90.0)
    cm2.record(scheme, "mean", Stage.Q, 130.0)
    assert cm2.cost(scheme, "mean", Stage.Q, cached=True) == 130.0


def test_plan_stage_cached_preference_keeps_metadata_fast_path():
    assert analytics.plan_stage(Scheme.HSZX_ND, "mean",
                                cached=frozenset({Stage.Q})) == Stage.M
    assert analytics.plan_stage(Scheme.HSZP_ND, "mean",
                                cached=frozenset({Stage.Q})) == Stage.Q


def test_cached_stages_requires_matching_region_and_closure(field_2d):
    jc, c = _pair("hszp_nd", field_2d)
    store, jstore = FieldStore(), JFieldStore()
    store.put("f", c)
    jstore.put("f", jc)

    def same(ops, **kw):
        got = store.cached_stages("f", ops, **kw)
        assert _ints(got) == _ints(jstore.cached_stages("f", ops, **kw))
        return got

    store.ensure("f", Stage.Q)
    jstore.ensure("f", JStage.Q)
    assert same(["mean", "std"]) == {Stage.Q, Stage.F}
    assert same(["mean", "std"], region=REGION) == frozenset()
    cl = oplib.set_closure(["mean", "std"], c.scheme, Stage.Q)
    assert cl == joplib.set_closure(["mean", "std"], jc.scheme, JStage.Q)
    store.ensure("f", Stage.Q, region=REGION, closure=cl)
    jstore.ensure("f", JStage.Q, region=REGION, closure=cl)
    assert same(["mean", "std"], region=REGION) == {Stage.Q, Stage.F}
    band = oplib.set_closure("derivative", c.scheme, Stage.P, axis=0)
    hull = oplib.set_closure(["mean", "std"], c.scheme, Stage.P)
    assert band != hull
    store.ensure("f", Stage.P, region=REGION, closure=band)
    jstore.ensure("f", JStage.P, region=REGION, closure=band)
    assert Stage.P not in same(["mean", "std"], region=REGION)
    assert Stage.P in same("derivative", region=REGION)
    assert MATERIALIZABLE == (Stage.P, Stage.Q, Stage.F)


@pytest.mark.parametrize("scheme", ALL)
def test_plan_stages_cached_outside_feasible_intersection(scheme, field_2d):
    """A resident stage-② materialization under a gradient-bearing op set:
    for 1-D schemes the cached stage is outside the set's feasible
    intersection — planning falls back to the cold choice (as the
    reference's), and store-backed queries still answer bit-identically."""
    s, js = Scheme(scheme), JScheme(scheme)
    cold = analytics.plan_stages(s, ["mean", "gradient"])
    plan = analytics.plan_stages(s, ["mean", "gradient"],
                                 cached=frozenset({Stage.P}))
    jplan = janalytics.plan_stages(js, ["mean", "gradient"],
                                   cached=frozenset({JStage.P}))
    assert int(plan.fused) == int(jplan.fused)
    if Stage.P in analytics.feasible_stages(s, "gradient"):
        assert plan.fused == Stage.P
    else:
        assert plan.fused == cold.fused
    cm, jcm = CostModel(), janalytics.CostModel()
    for op in ("mean", "gradient"):
        for st in analytics.feasible_stages(s, op):
            cm.record(s, op, st, 100.0 * int(st))
            jcm.record(js, op, JStage(int(st)), 100.0 * int(st))
        cm.record_reconstruction(s, Stage.Q, 50.0)
        jcm.record_reconstruction(js, JStage.Q, 50.0)
    plan_cal = analytics.plan_stages(s, ["mean", "gradient"], cost_model=cm,
                                     cached=frozenset({Stage.P}))
    jplan_cal = janalytics.plan_stages(js, ["mean", "gradient"],
                                       cost_model=jcm,
                                       cached=frozenset({JStage.P}))
    assert [(o, int(x)) for o, x in plan_cal.stages] == [
        (o, int(x)) for o, x in jplan_cal.stages]
    for op, st in plan_cal.stages:
        assert st in analytics.feasible_stages(s, op)
    c = _c(scheme, field_2d)
    store = FieldStore()
    store.put("f", c)
    store.ensure("f", Stage.P)
    eng = BatchedAnalytics()
    got = query(["f"], ["mean", "gradient"], store=store, engine=eng)
    st = got.stages[0]
    ref = query([c], ["mean", "gradient"],
                stage=st if st["mean"] != st["gradient"] else st["mean"],
                engine=eng)
    _assert_same(got.values[0]["mean"], ref.values[0]["mean"])
    _assert_same(got.values[0]["gradient"], ref.values[0]["gradient"])


# -- FieldStore semantics -----------------------------------------------------

def test_field_registry_semantics(field_2d):
    c = _c("hszx_nd", field_2d)
    store = FieldStore()
    store.put("a", c)
    assert "a" in store and store.get("a") is c and store.ids() == ("a",)
    assert len(store) == 1
    with pytest.raises(ValueError, match="already registered"):
        store.put("a", c)
    with pytest.raises(KeyError, match="unknown field id"):
        store.get("missing")
    with pytest.raises(KeyError, match="unknown field id"):
        store.remove("missing")
    with pytest.raises(TypeError):
        store.put("b", np.zeros(4))
    with pytest.raises(ValueError):
        store.put("", c)
    with pytest.raises(ValueError):
        FieldStore(cache_bytes=-1)


def test_replace_and_remove_invalidate_materializations(field_2d):
    c1 = _c("hszx_nd", field_2d)
    c2 = _c("hszx_nd", field_2d * 2.0)
    store = FieldStore()
    store.put("a", c1)
    store.ensure("a", Stage.Q)
    assert store.cache_entries == 1
    store.put("a", c2, replace=True)
    assert store.cache_entries == 0  # stale intermediate dropped
    assert store.stats.evictions == 1  # invalidation counts as churn
    m = store.ensure("a", Stage.Q)
    _assert_same(m.q_spatial, materialize(c2, Stage.Q).q_spatial)
    store.remove("a")
    assert "a" not in store and store.cache_entries == 0
    assert store.cache_bytes_in_use == 0


def test_lru_eviction_under_byte_budget(field_2d):
    c = _c("hszx_nd", field_2d)
    one = materialize(c, Stage.Q).nbytes
    store = FieldStore(cache_bytes=int(2.5 * one))
    for i in range(3):
        store.put(f"f{i}", c)
    store.ensure("f0", Stage.Q)
    store.ensure("f1", Stage.Q)
    assert store.cache_entries == 2
    store.lookup("f0", Stage.Q)          # refresh f0 -> f1 becomes LRU
    store.ensure("f2", Stage.Q)          # budget forces one eviction
    assert store.cache_entries == 2
    assert store.stats.evictions == 1
    assert store.cache_bytes_in_use <= store.cache_bytes
    assert store.lookup("f0", Stage.Q) is not None   # survivor
    assert store.lookup("f1", Stage.Q) is None       # evicted (miss)
    assert (store.stats.hits, store.stats.misses) == (2, 4)


def test_oversized_entry_not_retained(field_2d):
    c = _c("hszx_nd", field_2d)
    store = FieldStore(cache_bytes=16)   # smaller than any materialization
    store.put("a", c)
    m = store.ensure("a", Stage.Q)       # still computed and returned ...
    assert m.q_spatial is not None
    assert store.cache_entries == 0      # ... but never resident
    assert store.stats.rejected == 1 and store.stats.evictions == 0
    assert store.seed("a", Stage.Q) is None
    assert store.stats.rejected == 2
    misses0 = store.stats.misses
    res = query(["a"], ["mean", "std"], stage=Stage.Q, store=store)
    ref = query([c], ["mean", "std"], stage=Stage.Q)
    for op in ("mean", "std"):
        _assert_same(res.values[0][op], ref.values[0][op])
    assert store.stats.misses == misses0  # never touched the cache again


@pytest.mark.parametrize("scheme", ALL)
def test_materialized_nbytes_predicts_exactly(scheme, field_2d):
    """The static size predictor equals the realized nbytes and the
    reference's — it is the retention decision."""
    from repro.store import materialized_nbytes as jax_nbytes
    jc, c = _pair(scheme, field_2d)
    comp = jax_by_name(scheme)
    je = comp.encode(jc)
    e = to_port(je)
    for stage in (Stage.P, Stage.Q, Stage.F):
        for region, cl in ((None, "cover"),
                           (REGION, oplib.set_closure(["mean", "std"],
                                                      e.scheme, stage))):
            predicted = materialized_nbytes(e, stage, region=region,
                                            closure=cl)
            actual = materialize(e, stage, region=region, closure=cl).nbytes
            assert predicted == actual == jax_nbytes(
                je, JStage(int(stage)), region=region, closure=cl)


# -- byte accounting replayed against the reference ---------------------------

def _state(store):
    keys = [(k[0], int(k[1]), k[2], k[3]) for k in store._cache]
    s = store.stats
    return (keys, store.cache_bytes_in_use, store.cache_entries,
            (s.hits, s.misses, s.evictions, s.rejected))


def _bytes_consistent(store):
    assert store.cache_bytes_in_use == sum(
        m.nbytes for m in store._cache.values())
    assert store.cache_bytes_in_use <= max(store.cache_bytes, 0) or (
        store.cache_entries == 1)


def test_store_replay_against_reference(field_2d):
    """One sequence of puts, replacements, ensures, lookups, seeds, residency
    peeks, removals and budget evictions on both packages' stores: after
    every step the resident keys in LRU order, the bytes, the entry count
    and every counter are the reference's, byte for byte."""
    pairs = [_pair("hszp_nd", field_2d), _pair("hszp_nd", field_2d * 2.0),
             _pair("hszx_nd", field_2d)]
    budget = int(2.6 * materialize(pairs[0][1], Stage.Q).nbytes)
    store, jstore = FieldStore(cache_bytes=budget), JFieldStore(
        cache_bytes=budget)
    hull = oplib.set_closure(["mean", "std"], Scheme.HSZP_ND, Stage.Q)
    band = oplib.set_closure("derivative", Scheme.HSZP_ND, Stage.P, axis=1)
    steps = [
        ("put", "a", 0, {}), ("put", "b", 1, {}), ("put", "c", 2, {}),
        ("ensure", "a", Stage.Q, {}),
        ("ensure", "a", Stage.F, {}),              # ④ is the ③ entry
        ("ensure", "b", Stage.P, {"region": REGION, "closure": hull}),
        ("ensure", "b", Stage.P, {"region": REGION, "closure": band}),
        ("lookup", "a", Stage.Q, {}),
        ("ensure", "c", Stage.Q, {}),
        ("seed", "b", Stage.Q, {}),                # evicts from the LRU end
        ("is_resident", "a", Stage.Q, {}),
        ("lookup", "c", Stage.P, {}),
        ("seed", "c", Stage.P, {"region": REGION, "closure": "cover"}),
        ("put", "a", 1, {"replace": True}),        # invalidation churn
        ("ensure", "a", Stage.Q, {}),
        ("remove", "b", None, {}),
        ("ensure", "c", Stage.Q, {"region": REGION, "closure": "cover"}),
    ]
    for name, fid, arg, kw in steps:
        if name == "put":
            store.put(fid, pairs[arg][1], **kw)
            jstore.put(fid, pairs[arg][0], **kw)
        elif name == "remove":
            store.remove(fid)
            jstore.remove(fid)
        else:
            t = getattr(store, name)(fid, arg, **kw)
            j = getattr(jstore, name)(fid, JStage(int(arg)), **kw)
            if name == "is_resident":
                assert t == j
            else:
                assert (t is None) == (j is None), (name, fid, arg)
                if t is not None:
                    assert t.nbytes == j.nbytes
        assert _state(store) == _state(jstore), (name, fid, arg)
        _bytes_consistent(store)


def test_oversized_store_replay_against_reference(field_2d):
    jc, c = _pair("hszx_nd", field_2d)
    store, jstore = FieldStore(cache_bytes=16), JFieldStore(cache_bytes=16)
    store.put("a", c)
    jstore.put("a", jc)
    for name in ("ensure", "seed", "lookup", "seed"):
        getattr(store, name)("a", Stage.Q)
        getattr(jstore, name)("a", JStage.Q)
        assert _state(store) == _state(jstore), name


def test_byte_accounting_replay_put_replace_evict(field_2d):
    """After every step the byte counter equals the sum of resident nbytes
    (no double-subtraction on the replace-with-eviction path, no
    self-eviction of the fresh entry)."""
    c1 = _c("hszx_nd", field_2d)
    c2 = _c("hszx_nd", field_2d * 2.0)
    one = materialize(c1, Stage.Q).nbytes
    store = FieldStore(cache_bytes=int(2.2 * one))
    for i in range(3):
        store.put(f"f{i}", c1)
    store.ensure("f0", Stage.Q)
    _bytes_consistent(store)
    store.ensure("f1", Stage.Q)
    _bytes_consistent(store)
    store.ensure("f2", Stage.Q)  # evicts f0
    _bytes_consistent(store)
    assert store.stats.evictions == 1
    store.put("f1", c2, replace=True)
    _bytes_consistent(store)
    store.ensure("f1", Stage.Q)
    _bytes_consistent(store)
    m = materialize(c2, Stage.Q)
    key = next(iter(store._cache))
    store._insert(key, m)
    _bytes_consistent(store)
    assert store._cache[key] is m                     # replaced in place
    small = FieldStore(cache_bytes=one)
    small._insert(("a",), materialize(c1, Stage.Q))
    _bytes_consistent(small)
    small._insert(("b",), materialize(c2, Stage.Q))
    _bytes_consistent(small)
    assert list(k[0] for k in small._cache) == ["b"]  # a evicted, b resident


def test_oversized_replacement_drops_stale_entry(field_2d):
    c = _c("hszx_nd", field_2d)
    m_small = materialize(c, Stage.Q)
    store = FieldStore(cache_bytes=2 * m_small.nbytes)
    key = ("x", Stage.Q, None, "cover")
    store._insert(key, m_small)
    assert key in store._cache

    class Oversized:
        nbytes = 10 * m_small.nbytes

    store._insert(key, Oversized())
    assert key not in store._cache        # stale entry gone, nothing resident
    assert store.cache_bytes_in_use == 0
    assert store.stats.rejected == 1 and store.stats.evictions == 1
    _bytes_consistent(store)


# -- CostModel persistence, across packages -----------------------------------

def _recorded(pkg, scheme, stage):
    cm = pkg.CostModel()
    cm.record(scheme.HSZP_ND, "mean", stage.P, 100.0)
    cm.record(scheme.HSZP_ND, "mean", stage.P, 200.0)   # running mean: 150
    cm.record(scheme.HSZX, "std", stage.Q, 42.0)
    cm.record_reconstruction(scheme.HSZP_ND, stage.Q, 80.0)
    return cm


def _plain(cm):
    return ({(k[0].value, k[1], int(k[2])): v for k, v in cm.table.items()},
            {(k[0].value, int(k[1])): v for k, v in cm.recon.items()},
            {(k[0].value, k[1], int(k[2])): v for k, v in cm._counts.items()})


@pytest.mark.parametrize("direction", ["port-to-reference",
                                       "reference-to-port"])
def test_cost_model_save_load_roundtrip_across_packages(direction, tmp_path):
    """Each package loads the other's JSON to the same calibration state
    (counts included, so later observations continue the same means), and
    the files are byte for byte the same."""
    cm = _recorded(analytics, Scheme, Stage)
    jcm = _recorded(janalytics, JScheme, JStage)
    cm.save(tmp_path / "port.json")
    jcm.save(tmp_path / "ref.json")
    assert (tmp_path / "port.json").read_bytes() == (
        tmp_path / "ref.json").read_bytes()
    if direction == "port-to-reference":
        loaded = janalytics.CostModel.load(tmp_path / "port.json")
        assert _plain(loaded) == _plain(cm)
        loaded.record(JScheme.HSZP_ND, "mean", JStage.P, 300.0)
        cm.record(Scheme.HSZP_ND, "mean", Stage.P, 300.0)
        assert _plain(loaded) == _plain(cm)
    else:
        loaded = CostModel.load(tmp_path / "ref.json")
        assert _plain(loaded) == _plain(jcm)
        loaded.record(Scheme.HSZP_ND, "mean", Stage.P, 300.0)
        jcm.record(JScheme.HSZP_ND, "mean", JStage.P, 300.0)
        assert _plain(loaded) == _plain(jcm)
        assert analytics.plan_stages(
            Scheme.HSZP_ND, ["mean"], cost_model=loaded).fused == Stage.P


def test_cost_model_load_rejects_foreign_json(tmp_path):
    path = tmp_path / "bogus.json"
    path.write_text('{"format": "something-else", "cells": []}')
    with pytest.raises(ValueError, match="not a hsz-cost-model"):
        CostModel.load(path)
    path.write_text('{"format": "hsz-cost-model", "version": 2}')
    with pytest.raises(ValueError, match="unsupported version"):
        CostModel.load(path)


def test_cost_model_calibrates_reconstruction_from_fig34_rows():
    csv = "\n".join([
        "name,us_per_call,derived",
        "fig34/Ocean/hszp_nd-q,80.0,GBps=1.0",
        "fig34/NYX/hszp_nd-q,120.0,GBps=1.0",
        "fig34/Ocean/hszp_nd-f,500.0,GBps=1.0",
        "fig58/Ocean/mean/hszp_nd-q,130.0,GBps=1.0",
        "fig58/Ocean/mean/hszp_nd-p,90.0,GBps=1.0",
        "fig58/Ocean/mean/hszp_nd-f,700.0,GBps=1.0",
    ])
    cm = CostModel.from_benchmark_csv(csv)
    assert _plain(cm)[:2] == _plain(
        janalytics.CostModel.from_benchmark_csv(csv))[:2]
    assert cm.reconstruction(Scheme.HSZP_ND, Stage.Q) == 100.0  # mean of 2
    assert cm.reconstruction(Scheme.HSZP_ND, Stage.M) == 0.0
    assert cm.cost(Scheme.HSZP_ND, "mean", Stage.Q) == 130.0
    assert cm.cost(Scheme.HSZP_ND, "mean", Stage.Q, cached=True) == 30.0
    stages = (Stage.P, Stage.Q, Stage.F)
    assert cm.cheapest(Scheme.HSZP_ND, "mean", stages) == Stage.P
    assert cm.cheapest(Scheme.HSZP_ND, "mean", stages,
                       cached={Stage.Q}) == Stage.Q


@pytest.mark.parametrize("loader", ["port", "reference"])
def test_cost_model_load_tolerates_stripped_payload(loader, tmp_path):
    """An older or hand-stripped file loads in both packages to the same
    degraded state, with the same warning."""
    cm = CostModel()
    cm.record(Scheme.HSZP_ND, "mean", Stage.P, 100.0)
    cm.record(Scheme.HSZX, "std", Stage.Q, 42.0)
    cm.record_reconstruction(Scheme.HSZP_ND, Stage.Q, 80.0)
    path = tmp_path / "cost.json"
    cm.save(path)
    data = json.loads(path.read_text())
    del data["recon"]                       # older version: no recon table
    for cell in data["cells"]:
        cell.pop("count", None)             # no observation counts
    data["cells"].append({"scheme": "hszp_nd", "op": "std"})  # stripped cell
    path.write_text(json.dumps(data))
    pkg, scheme, stage = ((analytics, Scheme, Stage) if loader == "port"
                          else (janalytics, JScheme, JStage))
    with pytest.warns(UserWarning, match="skipped 1 malformed"):
        loaded = pkg.CostModel.load(path)
    assert loaded.table[(scheme.HSZP_ND, "mean", stage.P)] == 100.0
    assert loaded.table[(scheme.HSZX, "std", stage.Q)] == 42.0
    assert loaded.recon == {}
    assert loaded.cost(scheme.HSZP_ND, "std", stage.Q) is None
    assert loaded.reconstruction(scheme.HSZP_ND, stage.Q) is None
    loaded.record(scheme.HSZP_ND, "mean", stage.P, 300.0)
    assert loaded.table[(scheme.HSZP_ND, "mean", stage.P)] == 200.0
    assert pkg.plan_stages(scheme.HSZP_ND, ["mean", "std"],
                           cost_model=loaded).fused == stage.P


def test_stage_f_std_accurate_for_mean_dominated_fields():
    """The stage-④ std is mean-subtracted: 1000 ± 0.1 keeps its spread."""
    rng = np.random.default_rng(3)
    d = (1000.0 + rng.normal(0, 0.1, (128, 128))).astype(np.float32)
    c = _c("hszx_nd", d, rel_eb=1e-4)
    got = float(H.std(c, Stage.F))
    assert abs(got - d.std(ddof=1)) < 1e-3, (got, d.std(ddof=1))


def _count_kernel_calls(monkeypatch) -> list:
    """Wrap the kernel wrappers a stencil can reach so that each call (on
    the CPU, its plain version) appends its name to the returned list."""
    from repro_torch.kernels import bitpack, stencil_dq
    from repro_torch.kernels import fused as fk

    calls = []
    for mod, name in ((fk, "lorenzo2d"), (fk, "lorenzo_enc2d"),
                      (fk, "blockmean2d"), (fk, "blockmean_enc2d"),
                      (bitpack, "unpack_residuals"),
                      (stencil_dq, "grad2d_int"),
                      (stencil_dq, "laplacian2d_int")):
        real = getattr(mod, name)

        def counting(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(mod, name, counting)
    return calls


def test_stage_q_seed_reads_its_integers_not_the_payload(monkeypatch,
                                                          field_2d):
    """A context seeded with stage-③ integers takes the stage-③ difference
    kernel on them for its gradient (the Lorenzo ③④ laplacian has no fused
    cell; the reference's fused rules would decode the field again for its
    residuals); a stage-② seed feeds the residual-plane kernels.  Neither
    decodes, and both equal the unseeded fused results bitwise."""
    from repro_torch.core import fused as fused_mod

    e = _encode(_c("hszp_nd", field_2d))
    calls = _count_kernel_calls(monkeypatch)
    ops_ = ["gradient", "laplacian"]
    for stage, seed_stage, want_calls in (
            (Stage.Q, Stage.Q, ["grad2d_int"]),
            (Stage.F, Stage.Q, ["grad2d_int"]),
            (Stage.P, Stage.P, ["lorenzo2d", "lorenzo2d"])):
        seed = materialize(e, seed_stage)
        ctx = oplib.StageContext(e, stage, None, "cover", seed=seed)
        assert fused_mod._covers_2d(ctx)
        assert fused_mod._q_seeded(ctx) == (seed_stage == Stage.Q)
        cold = H.compute(e, ops_, stage)
        calls.clear()
        hot = H.compute(e, ops_, stage, seed=seed)
        assert calls == want_calls, (stage, calls)
        for op in ops_:
            _assert_same(hot[op], cold[op])


#: stencil op -> kernel calls per field on a stage-③ seed and on a stage-②
#: seed, for each scheme: the stage-③ difference kernel (the block-mean
#: kernel's lap_q for a laplacian; the Lorenzo ③④ laplacian has no fused
#: cell), and the family's residual-plane kernel
SEEDED_CALLS = {
    "derivative": {"hszp_nd": (["grad2d_int"], ["lorenzo2d"]),
                   "hszx_nd": (["grad2d_int"], ["blockmean2d"])},
    "gradient": {"hszp_nd": (["grad2d_int"], ["lorenzo2d"]),
                 "hszx_nd": (["grad2d_int"], ["blockmean2d"])},
    "laplacian": {"hszp_nd": ([], ["lorenzo2d"]),
                  "hszx_nd": (["blockmean2d"], ["blockmean2d"])},
    "divergence": {"hszp_nd": (["grad2d_int"] * 2, ["lorenzo2d"] * 2),
                   "hszx_nd": (["grad2d_int"] * 2, ["blockmean2d"] * 2)},
    "curl": {"hszp_nd": (["grad2d_int"] * 2, ["lorenzo2d"] * 2),
             "hszx_nd": (["grad2d_int"] * 2, ["blockmean2d"] * 2)},
}


@pytest.mark.parametrize("scheme", ["hszp_nd", "hszx_nd"])
@pytest.mark.parametrize("op", list(SEEDED_CALLS))
@pytest.mark.parametrize("region", [None, REGION], ids=["full", "region"])
def test_seeded_stencils_take_the_kernels_on_resident_planes(
        monkeypatch, scheme, op, region, field_2d):
    """Every seeded stencil, full field and windowed, equals its unseeded
    result bitwise and launches only kernels that read the seed: on a ③
    seed's integers the stage-③ difference kernel, or the block-mean
    kernel's f32 laplacian; on a ② seed's residuals the residual-plane band
    kernel; never a decode or a payload kernel."""
    e = _encode(_c(scheme, field_2d))
    vector = op in ("divergence", "curl")
    comps = [e, _encode(_c(scheme, field_2d[::-1].copy()))] if vector else [e]
    calls = _count_kernel_calls(monkeypatch)
    for stage, seed_stage in ((Stage.Q, Stage.Q), (Stage.F, Stage.Q),
                              (Stage.P, Stage.P)):
        closures = oplib.component_closures([op], [c.scheme for c in comps],
                                            stage) if vector else [
            oplib.set_closure([op], e.scheme, stage)]
        seeds = [materialize(c, seed_stage, region=region, closure=cl)
                 for c, cl in zip(comps, closures)]
        target = comps if vector else e
        cold = H.compute(target, [op], stage, region=region)[op]
        calls.clear()
        hot = H.compute(target, [op], stage, region=region,
                        seed=seeds if vector else seeds[0])[op]
        want = SEEDED_CALLS[op][scheme][seed_stage == Stage.P]
        assert calls == want, (stage, calls)
        _assert_same(hot, cold)
