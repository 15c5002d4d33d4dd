"""The port's sharded field store (``repro_torch.shard``,
``repro_torch.launch.mesh``) against the JAX reference (``repro.shard``).

The same numpy fields are compressed by the reference and carried into the
port with ``convert.from_arrays``.  What is held, with its tolerance:

* against the reference, **exactly**: ``BlockPlacement`` (word owners,
  stripes, participants, homes, payload bytes, closure fractions),
  ``gather_routing`` and ``spatial_bands`` over all four schemes, 1–8
  shards and ragged layouts; ``_max_shard_fraction`` and placement-priced
  ``plan_stages``; the integer intermediates (materialized stages, temporal
  summary leaves) **bitwise**;
* inside the port, **bitwise**: back-to-back ``ShardPrograms`` calls that
  differ in one input equal a fresh instance's (the port keeps no program
  cache);
* inside the port, **bitwise**: 8 shards on ``["cpu"] * 8`` against the
  port's single-device path for every cell of the reference's shard matrix
  (``tests/test_shard.py``: 128 × 96, ``REGION``) — ``region_compute``,
  ``materialize``, store against store, per-shard eviction and recompute,
  banded temporal summaries with an owning-shard-only refresh, the router;
* the port's single-device results against the reference's single-device
  results with the slice tolerances (stencils bitwise, divergence / curl
  rtol 1e-6, statistics rtol 1e-5 or half the bias bound, or no farther
  from the exact float64 window statistic than the reference).  The
  reference's own tests hold its sharded results bitwise to those.

The ``gpu`` tests run 8 shards on one card and skip without one.
"""
import functools
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import analytics as janalytics
from repro.analytics import planner as jplanner
from repro.core import Scheme as JScheme
from repro.core import Stage as JStage
from repro.core import by_name as jax_by_name
from repro.core import oplib as joplib
from repro.core import region as jregion
from repro.shard import BlockPlacement as JPlacement
from repro.shard import exec as jexec
from repro.shard import spatial_bands as jspatial_bands
from repro.store import materialize as jmaterialize
from repro.stream import StreamFieldStore as JStreamStore
from repro.stream import TemporalField as JTemporal
from repro_torch import analytics, convert
from repro_torch.analytics import planner
from repro_torch.analytics import query
from repro_torch.core import Scheme, Stage, by_name, error_analysis, oplib
from repro_torch.core import region as region_mod
from repro_torch.core.stages import LEAVES
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.mesh import SHARD_AXIS, make_analytics_mesh
from repro_torch.serve import (AnalyticsFrontend, AnalyticsRequest,
                               AppendRequest, StoreRouter)
from repro_torch.shard import (BlockPlacement, ShardPrograms,
                               ShardedFieldStore, spatial_bands)
from repro_torch.shard.exec import gather_routing
from repro_torch.store import FieldStore, materialize, materialized_nbytes
from repro_torch.stream import StreamFieldStore, TemporalField, query_temporal

SCHEMES = ("hszp", "hszx", "hszp_nd", "hszx_nd")
REGION = ((16, 80), (8, 72))          # the reference matrix's window
SHAPE = (128, 96)                     # the reference matrix's field
LEAF_NAMES = ("count", "q_sum", "q_sumsq", "q_min", "q_max", "last2")

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


def _data(shape=SHAPE, seed=0):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.normal(size=shape), axis=0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _pair(scheme, shape=SHAPE, seed=0, rel_eb=1e-2):
    """(reference Encoded, port Encoded on the CPU) of the same numpy data."""
    comp = jax_by_name(scheme)
    je = comp.encode(comp.compress(jnp.asarray(_data(shape, seed)),
                                   rel_eb=rel_eb))
    return je, to_port(je)


def _cpu_mesh(n=8):
    return make_analytics_mesh(devices=["cpu"] * n)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tup(x):
    return x if isinstance(x, tuple) else (x,)


def _bitwise(want, got, what=""):
    """Leaf for leaf, bitwise: tensors, tuples, op dicts, ``Compressed``."""
    if isinstance(want, dict):
        assert sorted(want) == sorted(got), what
        for k in want:
            _bitwise(want[k], got[k], f"{what} {k}")
        return
    if hasattr(want, "residuals"):
        for n in LEAVES["Compressed"]:
            _bitwise(getattr(want, n), getattr(got, n), f"{what} {n}")
        return
    assert len(_tup(want)) == len(_tup(got)), what
    for w, g in zip(_tup(want), _tup(got)):
        w, g = _np(w), _np(g)
        assert (w.shape, w.dtype) == (g.shape, g.dtype), what
        assert w.tobytes() == g.tobytes(), what


def _exact_stats(pe, region):
    """The window's (or field's) mean and std (ddof 1) in float64 over the
    port's stage-③ integers (bitwise the reference's), times 2·eps."""
    q = by_name(pe.scheme.value).decompress(pe, Stage.Q).numpy()
    if region is not None:
        q = q[tuple(slice(s, e) for s, e in region)]
    w = q.astype(np.float64)
    two_eps = 2.0 * float(pe.eps.item())
    return {"mean": w.mean() * two_eps, "std": w.std(ddof=1) * two_eps}


def _match_reference(want: dict, got: dict, pe, stage, region, what):
    """The slice tolerances, op by op (``want`` the reference's dict)."""
    assert sorted(want) == sorted(got), what
    exact = _exact_stats(pe, region)
    for name in want:
        w, g = want[name], got[name]
        if name in ("mean", "std"):
            w, g = float(_np(w)), float(_np(g))
            if abs(g - exact[name]) <= abs(w - exact[name]):
                continue
            eps = float(pe.eps.item())
            if (name, Stage(stage), pe.scheme.value) == ("mean", Stage.P,
                                                          "hszp"):
                tol = 1e-2 * eps  # ROADMAP queue 3: 1-D Lorenzo ② mean
            else:
                bound = (error_analysis.mean_bias_bound if name == "mean"
                         else error_analysis.std_bias_bound)(pe, Stage(stage))
                tol = max(1e-5 * abs(w), (1e-3 if bound >= eps else 0.5)
                          * bound)
            assert abs(g - w) <= tol, (what, name, abs(g - w), tol)
        elif name in ("divergence", "curl"):
            for a, b in zip(_tup(w), _tup(g), strict=True):
                a, b = _np(a), _np(b)
                np.testing.assert_allclose(b, a, rtol=1e-6,
                                           atol=1e-6 * float(np.abs(a).max()),
                                           err_msg=what)
        else:
            _bitwise(w, g, f"{what} {name}")


def _as_dict(value, ops_):
    return value if isinstance(value, dict) else {ops_: value}


# ===========================================================================
# the mesh
# ===========================================================================

def _cards(monkeypatch, n):
    monkeypatch.setattr(mesh_mod.torch.cuda, "is_available", lambda: n > 0)
    monkeypatch.setattr(mesh_mod.torch.cuda, "device_count", lambda: n)


def test_make_analytics_mesh_defaults_to_all_cards(monkeypatch):
    _cards(monkeypatch, 2)
    mesh = make_analytics_mesh()
    assert mesh.axis_names == (SHARD_AXIS,)
    assert mesh.size == 2
    assert mesh.devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert make_analytics_mesh(1).devices == (torch.device("cuda", 0),)


def test_make_analytics_mesh_validates_count(monkeypatch):
    _cards(monkeypatch, 2)
    with pytest.raises(ValueError, match="devices"):
        make_analytics_mesh(3)
    with pytest.raises(ValueError):
        make_analytics_mesh(0)


def test_make_analytics_mesh_never_falls_back_to_the_cpu(monkeypatch):
    _cards(monkeypatch, 0)
    for n in (None, 1, 8):
        with pytest.raises(ValueError, match="devices"):
            make_analytics_mesh(n)


def test_make_analytics_mesh_takes_an_explicit_device_list():
    mesh = _cpu_mesh(8)
    assert mesh.size == 8 and mesh.axis_names == (SHARD_AXIS,)
    assert mesh.devices == (torch.device("cpu"),) * 8
    assert make_analytics_mesh(8, devices=["cpu"] * 8) == mesh
    with pytest.raises(ValueError, match="devices"):
        make_analytics_mesh(4, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="device"):
        make_analytics_mesh(devices=[])


# ===========================================================================
# placement, routing and bands: equal to the reference's, array for array
# ===========================================================================

#: (shape, shard axis) of the layouts held: the reference tests' (256, 192),
#: ragged 2-D layouts, and 3-D slab layouts striped along axis 1
LAYOUTS = [((256, 192), 0), ((181, 97), 0), ((37, 53), 0), ((128, 96), 0),
           ((3, 96, 64), 1), ((4, 70, 61), 1)]
PLACEMENT_BITS = (1, 7, 13, 31)


@functools.lru_cache(maxsize=None)
def _layout_pair(scheme, shape):
    """Reference and port ``Compressed`` of one layout (same numpy data)."""
    comp = jax_by_name(scheme)
    jc = comp.compress(jnp.asarray(_data(shape)), rel_eb=1e-2)
    return jc, to_port(jc)


def _regions(shape):
    """Windows over a layout's spatial (axis-0/1) extent: interior, edge,
    one row."""
    r0, r1 = shape[-2], shape[-1]
    lead = tuple((0, s) for s in shape[:-2])
    return [lead + ((r0 // 5, r0 - r0 // 4), (r1 // 7, r1 - 3)),
            lead + ((0, 1 + r0 // 3), (r1 // 2, r1)),
            lead + ((r0 // 2, r0 // 2 + 1), (0, r1))]


def _closures(scheme):
    if Scheme(scheme).is_nd:
        return ["cover", "hull", ("band", 0), ("band", 1)]
    return ["cover", "hull"]


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: "x".join(map(str, l[0])))
def test_placement_matches_reference(scheme, layout):
    shape, axis = layout
    jc, pc = _layout_pair(scheme, shape)
    for n in (1, 2, 3, 5, 8):
        jp = JPlacement.of(jc, n, axis=axis)
        pp = BlockPlacement.of(pc, n, axis=axis)
        assert (pp.axis, pp.n_units, pp.grid) == (jp.axis, jp.n_units, jp.grid)
        assert pp.sig()[1:] == jp.sig()[1:] and pp.sig()[0].value == \
            jp.sig()[0].value
        blocks = np.arange(int(np.prod(pp.grid)))
        np.testing.assert_array_equal(pp.owner_of_blocks(blocks),
                                      jp.owner_of_blocks(blocks))
        for s in range(n):
            np.testing.assert_array_equal(pp.units_of(s), jp.units_of(s))
        assert pp.max_fraction(None) == jp.max_fraction(None)
        for bits in PLACEMENT_BITS:
            np.testing.assert_array_equal(pp.word_owner(bits),
                                          jp.word_owner(bits))
            for a, b in zip(pp.shard_word_index(bits),
                            jp.shard_word_index(bits), strict=True):
                np.testing.assert_array_equal(a, b)
        for region in _regions(shape):
            for cl in _closures(scheme):
                jplan = jregion.plan_region(jc, region, cl)
                pplan = region_mod.plan_region(pc, region, cl)
                assert pp.participants(pplan) == jp.participants(jplan)
                assert pp.home(pplan) == jp.home(jplan)
                np.testing.assert_array_equal(pp.closure_fractions(pplan),
                                              jp.closure_fractions(jplan))
                assert pp.max_fraction(pplan) == jp.max_fraction(jplan)
                for bits in PLACEMENT_BITS:
                    assert pp.payload_bytes(pplan, bits) == \
                        jp.payload_bytes(jplan, bits)
        assert pp.home(None) == jp.home(None) == 0


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("n", [1, 2, 3, 5, 8])
def test_gather_routing_matches_reference(scheme, n):
    for shape in ((128, 96), (181, 97), (37, 53)):
        jc, pc = _layout_pair(scheme, shape)
        jp, pp = JPlacement.of(jc, n), BlockPlacement.of(pc, n)
        for bits in PLACEMENT_BITS:
            sets = [np.arange(-(-int(np.prod(pc.padded_shape)) * bits // 32))]
            for region in _regions(shape):
                for cl in _closures(scheme):
                    plan = region_mod.plan_region(pc, region, cl)
                    sets.append(np.asarray(plan.payload_gather(bits).word_idx))
            for word_idx in sets:
                got = gather_routing(n, pp, bits, word_idx)
                want = jexec.gather_routing(n, jp, bits, word_idx)
                for g, w in zip(got, want, strict=True):
                    assert g.dtype == w.dtype
                    np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_spatial_bands_match_reference(scheme):
    for shape in ((3, 96, 64), (4, 70, 61)):
        jc, pc = _layout_pair(scheme, shape)
        spatial = shape[1:]
        regions = [None, ((8, 52), (10, 60)), ((0, 1), (0, spatial[1])),
                   ((spatial[0] // 3, spatial[0]), (3, 7))]
        for n in range(1, 9):
            jp = JPlacement.of(jc, n, axis=1) if Scheme(scheme).is_nd \
                else JPlacement.of(jc, n)
            pp = BlockPlacement.of(pc, n, axis=jp.axis)
            for region in regions:
                if region is not None and region[0][1] > spatial[0]:
                    continue
                assert spatial_bands(pc, pp, region) == \
                    jspatial_bands(jc, jp, region)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_word_partition_is_exact(scheme):
    """Every payload word has exactly one owner; the per-shard word index
    lists are a disjoint, ascending partition of all words."""
    _, e = _pair(scheme, (256, 192))
    p = BlockPlacement.of(e, 8)
    owners = p.word_owner(e.bits)
    n_words = int(e.payload.numel())
    assert owners.shape == (n_words,)
    assert owners.min() >= 0 and owners.max() < 8
    stripes = p.shard_word_index(e.bits)
    seen = np.concatenate(stripes)
    assert sorted(seen.tolist()) == list(range(n_words))
    for s, idx in enumerate(stripes):
        assert (owners[idx] == s).all()
        if len(idx) > 1:
            assert (np.diff(idx) > 0).all()


def test_striping_cycles_over_shards():
    _, e = _pair("hszx_nd", (256, 192))   # block (16, 16): 16 stripe units
    p = BlockPlacement.of(e, 8)
    assert p.n_units == 16
    for s in range(8):
        assert (p.units_of(s) % 8 == s).all()
        assert len(p.units_of(s)) == 2
    cols = p.grid[1]
    block_ids = np.arange(p.n_units * cols)
    assert (p.owner_of_blocks(block_ids) == (block_ids // cols) % 8).all()


@pytest.mark.parametrize("scheme", SCHEMES)
def test_payload_bytes_partition_and_locality(scheme):
    _, e = _pair(scheme, (256, 192))
    region = ((64, 128), (0, 192))
    cl = oplib.set_closure(("mean",), e.scheme, Stage.Q, 0)
    plan = region_mod.plan_region(
        e, region_mod.normalize_region(region, e.shape), cl)
    acct = BlockPlacement.of(e, 8).payload_bytes(plan, e.bits)
    assert sum(acct["per_shard_bytes"]) == acct["single_bytes"]
    assert acct["max_shard_bytes"] == max(acct["per_shard_bytes"])
    assert set(acct["participants"]) <= set(range(8))
    assert acct["max_shard_bytes"] < 0.5 * acct["single_bytes"], acct


@pytest.mark.parametrize("scheme", SCHEMES)
def test_max_fraction_full_field(scheme):
    _, e = _pair(scheme, (256, 192))
    p = BlockPlacement.of(e, 8)
    assert 1 / 8 <= p.max_fraction(None) <= 1 / 8 + 8 / max(p.n_units, 1)


def test_placement_rejects_bad_arguments():
    _, e = _pair("hszx_nd", (64, 48))
    with pytest.raises(ValueError, match="n_shards"):
        BlockPlacement.of(e, 0)
    with pytest.raises(ValueError, match="axis"):
        BlockPlacement.of(e, 2, axis=2)
    with pytest.raises(ValueError, match="out of range"):
        BlockPlacement.of(e, 2).units_of(2)


# ===========================================================================
# the planner's max-over-shards rule: the reference's fractions and plans
# ===========================================================================

PLAN_OPS = [("mean",), ("mean", "std"), ("derivative",), ("gradient",),
            ("laplacian",), ("std", "laplacian"), ("divergence",),
            ("curl",)]


def _calibrated(pkg, scheme):
    """A cost model with every (op, stage) cell of ``scheme`` measured, so
    the placement fraction decides the plan."""
    cm = pkg.CostModel()
    for op in analytics.OPS:
        for s in analytics.feasible_stages(Scheme(scheme), op):
            cm.record(pkg_scheme(pkg, scheme), op, pkg_stage(pkg, s),
                      10.0 * int(s) ** 2 + len(op))
    return cm


def pkg_scheme(pkg, scheme):
    return JScheme(scheme) if pkg is janalytics else Scheme(scheme)


def pkg_stage(pkg, s):
    return JStage(int(s)) if pkg is janalytics else Stage(int(s))


@pytest.mark.parametrize("scheme", SCHEMES)
def test_max_shard_fraction_matches_reference(scheme):
    jc, pc = _layout_pair(scheme, (256, 192))
    for n in (1, 3, 8):
        jp, pp = JPlacement.of(jc, n), BlockPlacement.of(pc, n)
        for region in [None] + _regions((256, 192)):
            jnorm = (jregion.normalize_region(region, jc.shape)
                     if region is not None else None)
            for op in analytics.OPS:
                if op in ("divergence", "curl") and not Scheme(scheme).is_nd:
                    continue
                for s in analytics.feasible_stages(Scheme(scheme), op):
                    for axis in (0, 1):
                        got = planner._max_shard_fraction(
                            pc, op, s, jnorm, axis, pp)
                        want = jplanner._max_shard_fraction(
                            jc, op, JStage(int(s)), jnorm, axis, jp)
                        assert got == want, (op, s, region, axis)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_plan_stages_with_placement_matches_reference(scheme):
    jc, pc = _layout_pair(scheme, (256, 192))
    jcm, pcm = _calibrated(janalytics, scheme), _calibrated(analytics, scheme)
    for n in (1, 8):
        jp, pp = JPlacement.of(jc, n), BlockPlacement.of(pc, n)
        for region in [None] + _regions((256, 192)):
            for names in PLAN_OPS:
                if (any(o in ("divergence", "curl") for o in names)
                        and not Scheme(scheme).is_nd):
                    continue
                for cm_pair in ((None, None), (jcm, pcm)):
                    want = janalytics.plan_stages(
                        JScheme(scheme), names, "auto", cm_pair[0],
                        region=region, field=jc, placement=jp)
                    got = analytics.plan_stages(
                        Scheme(scheme), names, "auto", cm_pair[1],
                        region=region, field=pc, placement=pp)
                    assert got.ops == want.ops
                    assert [(o, int(s)) for o, s in got.stages] == \
                        [(o, int(s)) for o, s in want.stages]
                    assert (got.fused is None) == (want.fused is None)


def test_planner_max_shard_fraction_bounds():
    _, e = _pair("hszx_nd", (256, 192))
    p = BlockPlacement.of(e, 8)
    region = region_mod.normalize_region(((64, 128), (0, 192)), e.shape)
    single = region_mod.closure_fraction(e, "mean", Stage.Q, region, axis=0)
    sharded = planner._max_shard_fraction(e, "mean", Stage.Q, region, 0, p)
    assert 0 < sharded <= single
    assert planner._max_shard_fraction(e, "mean", Stage.Q, None, 0, p) < 0.2
    m = planner._max_shard_fraction(e, "mean", Stage.M, region, 0, p)
    assert m == region_mod.closure_fraction(e, "mean", Stage.M, region,
                                            axis=0)


def test_query_prices_a_sharded_id_by_its_placement(monkeypatch):
    """``query`` hands ``store.placement_of``'s placement to the planner
    (a single-device store has none)."""
    _, e = _pair("hszx_nd", (64, 48))
    query_mod = importlib.import_module("repro_torch.analytics.query")
    seen = []
    real = query_mod.plan_stages

    def spy(*args, **kw):
        seen.append(kw.get("placement"))
        return real(*args, **kw)

    monkeypatch.setattr(query_mod, "plan_stages", spy)
    sh = ShardedFieldStore(_cpu_mesh(2))
    sh.put("f", e)
    local = StreamFieldStore()
    local.put("f", e)
    query(["f"], "mean", store=sh)
    query(["f"], "mean", store=local)
    assert seen[0] is sh.placement_of("f") and seen[1] is None


# ===========================================================================
# sharded store semantics
# ===========================================================================

def test_sharded_store_requires_encoded():
    c = by_name("hszx_nd").compress(np.ones((32, 32), np.float32),
                                    rel_eb=1e-2, device="cpu")
    store = ShardedFieldStore(_cpu_mesh(1))
    with pytest.raises(TypeError, match="encode"):
        store.put("f", c)
    with pytest.raises(ValueError, match="non-empty"):
        store.put("", c)


def test_router_membership_and_rejection():
    sh = ShardedFieldStore(_cpu_mesh(1))
    local = FieldStore()
    _, e = _pair("hszx_nd", (64, 48))
    sh.put("big", e)
    local.put("small", e)
    r = StoreRouter(sh, local)
    assert "big" in r and "small" in r and "nope" not in r
    assert r.get("big") is sh.get("big")
    assert r.get("small") is local.get("small")
    assert set(r.ids()) == {"big", "small"}
    with pytest.raises(KeyError, match="big.*small|small.*big"):
        r.get("nope")
    with pytest.raises(ValueError, match="already registered"):
        r.put("big", e)
    assert r.placement_of("big") is not None
    assert r.placement_of("small") is None
    with pytest.raises(TypeError, match="streaming"):
        r.append("small", np.ones((1, 64, 48), np.float32))
    with pytest.raises(TypeError, match="temporal support"):
        r.temporal_summary("small")
    assert not r.is_temporal("small")
    with pytest.raises(ValueError, match="one store"):
        r.cached_stages(("big", "small"), "curl")


def test_router_without_local_store():
    sh = ShardedFieldStore(_cpu_mesh(1))
    _, e = _pair("hszp", (64, 48))
    sh.put("only", e)
    r = StoreRouter(sh)
    assert "only" in r and r.get("only") is sh.get("only")
    with pytest.raises(ValueError, match="no local store"):
        r.put("x", e)
    tf = TemporalField("hszx_nd", rel_eb=1e-2, device="cpu")
    r.put_temporal("t", tf)             # no local store: the mesh takes it
    assert sh.is_temporal("t") and r.is_temporal("t")


def test_sharded_registry_semantics():
    sh = ShardedFieldStore(_cpu_mesh(4))
    _, e = _pair("hszx_nd", (64, 48))
    sh.put("f", e)
    assert "f" in sh and len(sh) == 1 and sh.ids() == ("f",)
    with pytest.raises(ValueError, match="already registered"):
        sh.put("f", e)
    sh.ensure("f", Stage.Q)
    assert sh.cache_entries == 1
    sh.put("f", e, replace=True)        # invalidates the old cells
    assert sh.cache_entries == 0 and sh.stats.evictions == 1
    with pytest.raises(KeyError, match="unknown field id"):
        sh.get("ghost")
    with pytest.raises(TypeError, match="not a temporal field"):
        sh.append("f", np.ones((1, 64, 48), np.float32))
    sh.remove("f")
    assert "f" not in sh and sh.placement_of("f") is None


# ===========================================================================
# the 8-shard matrix, in process on ["cpu"] * 8
# ===========================================================================

@pytest.fixture(scope="module")
def progs():
    return ShardPrograms(_cpu_mesh(8))


def _exec_cells(scheme):
    cells = [(("mean", "std"), Stage.Q), (("mean",), Stage.P),
             (("mean",), Stage.F), (("gradient", "laplacian"), Stage.P),
             (("derivative",), Stage.Q)]
    if Scheme(scheme).is_blockmean:
        cells.append((("mean",), Stage.M))
    return cells


@pytest.mark.parametrize("scheme", SCHEMES)
def test_exec_bit_identity_matrix(scheme, progs):
    """Sharded op sets == the port's single-device ``compute``, bitwise,
    for every (op set, stage, ± region) cell; the port's single-device
    values match the reference's within the slice tolerances; a cell the
    single-device path refuses is refused sharded too."""
    je, pe = _pair(scheme)
    for ops_, st in _exec_cells(scheme):
        for region in (None, REGION):
            what = f"{scheme} {ops_} {st.name} {region}"
            try:
                want = jax.jit(lambda enc, _o=ops_, _s=st, _r=region:
                               joplib.compute(enc, _o, JStage(int(_s)),
                                              region=_r))(je)
            except Exception as ex:
                for fn in (oplib.compute, progs.region_compute):
                    with pytest.raises(Exception) as got:
                        fn(pe, ops_, st, region=region)
                    assert type(got.value).__name__ == type(ex).__name__
                continue
            single = oplib.compute(pe, ops_, st, region=region)
            got = progs.region_compute(pe, ops_, st, region=region)
            _bitwise(single, got, what)
            _match_reference(want, single, pe, st, region, what)


@pytest.mark.parametrize("scheme", ["hszp_nd", "hszx_nd"])
def test_exec_vector_op_sets(scheme, progs):
    """Divergence / curl over two sharded components."""
    (ju, pu), (jv, pv) = _pair(scheme, seed=1), _pair(scheme, seed=2)
    for st in (Stage.P, Stage.Q):
        for region in (None, REGION):
            single = oplib.compute((pu, pv), ("divergence", "curl"), st,
                                   region=region)
            got = progs.region_compute((pu, pv), ("divergence", "curl"), st,
                                       region=region)
            _bitwise(single, got, f"{scheme} {st} {region}")
            want = joplib.compute((ju, jv), ("divergence", "curl"),
                                  JStage(int(st)), region=region)
            _match_reference(want, single, pu, st, region, scheme)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_materialize_bit_identity(scheme, progs):
    """The merged integer intermediates equal the port's single-device
    ``materialize`` and the reference's, bitwise."""
    je, pe = _pair(scheme)
    for st in (Stage.P, Stage.Q):
        for region in (None, REGION):
            what = f"{scheme} {st.name} {region}"
            ref = materialize(pe, st, region=region)
            got = progs.materialize(pe, st, region=region)
            leaf = ref.sub if st == Stage.P else ref.q_spatial
            _bitwise(leaf, got, what)
            jref = jmaterialize(je, JStage(int(st)), region=region)
            if st == Stage.P:
                for n in LEAVES["Compressed"]:
                    _bitwise(getattr(jref.sub, n), getattr(got, n), what)
            else:
                _bitwise(jref.q_spatial, got, what)
                assert got.is_contiguous()


@pytest.mark.parametrize("scheme", SCHEMES)
def test_store_query_bit_identity(scheme):
    """Store against store: a ``ShardedFieldStore`` answers as the
    single-device ``StreamFieldStore`` does, bitwise, cold and hot; the
    single-device answers match the reference store's."""
    je, pe = _pair(scheme)
    jref = JStreamStore()
    jref.put("f", je)
    ref, sh = StreamFieldStore(), ShardedFieldStore(_cpu_mesh(8))
    ref.put("f", pe)
    sh.put("f", pe)
    for region in (None, REGION):
        for ops_, st in ((["mean", "std"], Stage.Q), ("mean", "auto"),
                         ("laplacian", Stage.F)):
            r1 = query(["f"], ops_, st, region=region, store=ref)
            r2 = query(["f"], ops_, st, region=region, store=sh)
            r3 = query(["f"], ops_, st, region=region, store=sh)
            what = f"{scheme} {ops_} {region}"
            _bitwise(r1.values[0], r2.values[0], what)
            _bitwise(r2.values[0], r3.values[0], what)
            assert r1.stages == r2.stages == r3.stages
            jr = janalytics.query(["f"], ops_, st if st == "auto"
                                  else JStage(int(st)), region=region,
                                  store=jref)
            key = ops_ if isinstance(ops_, str) else None
            stage = r1.stages[0] if key else r1.stages[0]["mean"]
            _match_reference(_as_dict(jr.values[0], key),
                             _as_dict(r1.values[0], key), pe, stage, region,
                             what)
    assert sh.stats.hits > ref.stats.hits > 0
    assert sh.stats.misses == ref.stats.misses   # each cell built once


@pytest.mark.parametrize("scheme", ["hszp_nd", "hszx_nd"])
def test_store_vector_and_expression_queries(scheme):
    """Vector ids and an expression over sharded ids answer as over a
    single-device store, bitwise."""
    from repro_torch.core import expr

    (_, pu), (_, pv) = _pair(scheme, seed=1), _pair(scheme, seed=2)
    ref, sh = StreamFieldStore(), ShardedFieldStore(_cpu_mesh(8))
    for s in (ref, sh):
        s.put("u", pu)
        s.put("v", pv)
    for region in (None, REGION):
        for st in (Stage.P, Stage.Q):
            a = query([("u", "v")], ["divergence", "curl"], st,
                      region=region, store=ref)
            b = query([("u", "v")], ["divergence", "curl"], st,
                      region=region, store=sh)
            _bitwise(a.values[0], b.values[0], f"{scheme} {st} {region}")
        ex = [expr.laplacian("u") - expr.laplacian("v"),
              expr.mean("u") - expr.mean("v")]
        a = query(exprs=ex, region=region, store=ref)
        b = query(exprs=ex, region=region, store=sh)
        assert a.stages == b.stages
        for x, y in zip(a.values, b.values):
            _bitwise(x, y, f"{scheme} exprs {region}")


def test_eviction_is_per_shard():
    """Evicting on one shard leaves the sibling materialization on another
    shard resident, and the evicted cell recomputes bit-identically."""
    _, e = _pair("hszx_nd", (256, 96), seed=3)
    rA = ((0, 16), (0, 96))      # block-row 0 -> home shard 0
    rB = ((16, 32), (0, 96))     # block-row 1 -> home shard 1
    rC = ((128, 144), (0, 96))   # another row homed on shard 0 (unit 8)
    budget = materialized_nbytes(e, Stage.Q, region=rA) + 64
    sv = ShardedFieldStore(_cpu_mesh(8), cache_bytes_per_shard=budget)
    sv.put("f", e)
    hA = sv.shard_of("f", Stage.Q, region=rA)
    hB = sv.shard_of("f", Stage.Q, region=rB)
    hC = sv.shard_of("f", Stage.Q, region=rC)
    assert hA != hB and hA == hC
    sv.ensure("f", Stage.Q, region=rA)
    sv.ensure("f", Stage.Q, region=rB)
    assert sv.is_resident("f", Stage.Q, region=rA)
    assert sv.is_resident("f", Stage.Q, region=rB)
    sv.ensure("f", Stage.Q, region=rC)   # overflows shard hA's budget only
    assert not sv.is_resident("f", Stage.Q, region=rA)
    assert sv.is_resident("f", Stage.Q, region=rB)
    assert sv.is_resident("f", Stage.Q, region=rC)
    assert sv.stats.evictions == 1
    assert sv.shard_stats[hA].evictions == 1
    assert sv.shard_stats[hB].evictions == 0
    got = query(["f"], "mean", Stage.Q, region=rA, store=sv).values[0]
    ref = StreamFieldStore()
    ref.put("f", e)
    _bitwise(query(["f"], "mean", Stage.Q, region=rA, store=ref).values[0],
             got)


def test_capacity_mode_serves_oversized_cells_without_a_payload():
    """``retain_payload=False``: the registered container keeps no payload;
    a cell over its shard's whole budget is computed from the stripes,
    returned, and not retained (a rejection on its home shard)."""
    _, e = _pair("hszp_nd")
    sv = ShardedFieldStore(_cpu_mesh(8), cache_bytes_per_shard=1024,
                           retain_payload=False)
    sv.put("f", e)
    assert sv.get("f").payload.numel() == 0
    m = sv.seed("f", Stage.Q)
    assert m is not None and sv.cache_entries == 0
    assert sv.stats.rejected == 1
    _bitwise(materialize(e, Stage.Q).q_spatial, m.q_spatial)
    kept = ShardedFieldStore(_cpu_mesh(8), cache_bytes_per_shard=1024)
    kept.put("f", e)
    assert kept.seed("f", Stage.Q) is None   # the payload answers instead


def test_payload_accounting_and_cached_stages():
    _, e = _pair("hszx_nd", (256, 192))
    sh = ShardedFieldStore(_cpu_mesh(8))
    sh.put("f", e)
    acct = sh.payload_accounting("f", "mean", Stage.Q,
                                 region=((64, 128), (0, 192)))
    assert sum(acct["per_shard_bytes"]) == acct["single_bytes"]
    ref = StreamFieldStore()
    ref.put("f", e)
    for s in (sh, ref):
        assert s.cached_stages("f", ["mean", "std"]) == frozenset()
        s.ensure("f", Stage.Q, region=REGION)
        assert s.cached_stages("f", ["mean", "std"], region=REGION) == \
            frozenset({Stage.Q, Stage.F})
        assert s.lookup("f", Stage.F, region=REGION) is not None
    assert sh.stats.hits == ref.stats.hits


# -- temporal: banded summaries, owning-shard-only refresh --------------------

def _slabs(shape=(4, 70, 64), n=3, seed=5):
    rng = np.random.default_rng(seed)
    return [np.cumsum(rng.normal(size=shape), axis=1).astype(np.float32)
            for _ in range(n)]


@pytest.mark.parametrize("scheme", ["hszp", "hszx_nd", "hszp_nd"])
def test_temporal_append_refreshes_owning_shard_only(scheme):
    slabs = _slabs()
    ref, sh = StreamFieldStore(), ShardedFieldStore(_cpu_mesh(8))
    jref = JStreamStore()
    ref.put_temporal("t", TemporalField(scheme, rel_eb=1e-2, device="cpu"))
    sh.put_temporal("t", TemporalField(scheme, rel_eb=1e-2, device="cpu"))
    jref.put_temporal("t", JTemporal(jax_by_name(scheme), rel_eb=1e-2))
    for s in slabs[:2]:
        for store in (ref, sh, jref):
            store.append("t", s)
    regions = (None, ((8, 52), (10, 60)))
    for region in regions:
        a = query_temporal(["t"], ["tmean", "tstd"], region=region,
                           store=ref).values[0]
        b = query_temporal(["t"], ["tmean", "tstd"], region=region,
                           store=sh).values[0]
        _bitwise(a, b, f"{scheme} {region}")
        want = jref.temporal_summary("t", region=region)
        got = sh.temporal_summary("t", region=region)
        for n in LEAF_NAMES:
            _bitwise(getattr(want, n), getattr(got, n), f"{scheme} {n}")
    keys = [k for ch in sh._shards for k in ch._cache if k[0] == "t"]
    assert len(keys) == 2 and len(set(keys)) == 2
    owners = {k: [i for i, ch in enumerate(sh._shards) if k in ch._cache]
              for k in keys}
    assert all(len(v) == 1 for v in owners.values())
    before = {i: dict(ch._cache) for i, ch in enumerate(sh._shards)}
    merges0 = sh.incremental_merges
    for store in (ref, sh, jref):
        store.append("t", slabs[2])
    assert sh.incremental_merges == merges0 + 2
    for i, ch in enumerate(sh._shards):
        owned = [k for k in before[i] if k[0] == "t"]
        assert all(k in ch._cache for k in before[i])
        assert {k for k in ch._cache if k[0] == "t"} == set(owned)
    for region in regions:
        a = query_temporal(["t"], ["tmean", "tstd", "tdelta"], region=region,
                           store=ref).values[0]
        b = query_temporal(["t"], ["tmean", "tstd", "tdelta"], region=region,
                           store=sh).values[0]
        _bitwise(a, b, f"{scheme} post-append {region}")
        want = jref.temporal_summary("t", region=region)
        got = sh.temporal_summary("t", region=region)
        for n in LEAF_NAMES:
            _bitwise(getattr(want, n), getattr(got, n), f"{scheme} {n}")


def test_merge_band_summaries_equals_one_window_summary():
    """Disjoint bands scattered over neutral buffers and merged over the
    shard axis equal the summary of the whole window, leaf for leaf —
    also with full-range int32 values whose sums wrap."""
    rng = np.random.default_rng(9)
    q = torch.as_tensor(rng.integers(-2**31, 2**31 - 1, (5, 23, 7),
                                     dtype=np.int64).astype(np.int32))
    whole = oplib.summary_from_q(q)
    progs = ShardPrograms(_cpu_mesh(3))
    cuts = [0, 4, 5, 11, 19, 23]
    bands = [(i % 3, a, oplib.summary_from_q(q[:, a:b]))
             for i, (a, b) in enumerate(zip(cuts, cuts[1:]))]
    got = progs.merge_band_summaries(bands, 23, (7,))
    for n in LEAF_NAMES:
        _bitwise(getattr(whole, n), getattr(got, n), n)


# -- serve routing -------------------------------------------------------------

def test_serve_routing_rejects_per_request():
    sh, local = ShardedFieldStore(_cpu_mesh(8)), StreamFieldStore()
    _, e = _pair("hszx_nd")
    sh.put("big", e)
    local.put("small", e)
    local.put_temporal("t", TemporalField("hszx_nd", rel_eb=1e-2,
                                          device="cpu"))
    fe = AnalyticsFrontend(store=StoreRouter(sh, local))
    fe.add_request(AnalyticsRequest(uid=1, fields="big", op="mean",
                                    region=REGION))
    fe.add_request(AnalyticsRequest(uid=2, fields="small", op="mean"))
    fe.add_request(AnalyticsRequest(uid=3, fields="nope", op="mean"))
    fe.add_request(AppendRequest(uid=4, field_id="t", data=_slabs()[0]))
    fe.add_request(AnalyticsRequest(uid=5, fields="t", op="tmean"))
    done = {r.uid: r for r in fe.run_until_drained()}
    assert done[1].error is None and done[2].error is None
    assert done[3].error is not None and "unknown field id" in done[3].error
    assert done[3].error.startswith("KeyError: ")
    assert done[4].error is None and done[4].slab_index == 0
    assert done[5].error is None
    ref = query(["big"], "mean", region=REGION, store=sh).values[0]
    _bitwise(ref, done[1].result)
    single = StreamFieldStore()
    single.put("big", e)
    _bitwise(query(["big"], "mean", region=REGION, store=single).values[0],
             done[1].result)


# -- no program cache: back-to-back calls equal a fresh ShardPrograms ----------

def _shard_calls(case):
    """``ShardPrograms`` calls that differ from one another in one input."""
    _, pe = _pair("hszp_nd")
    if case == "region":
        return [lambda p, r=r: p.region_compute(pe, ("mean", "std"), Stage.Q,
                                                region=r)
                for r in (REGION, None)]
    if case == "materialize":
        return [lambda p, st=st: p.materialize(pe, st, region=REGION)
                for st in (Stage.P, Stage.Q)]
    assert case == "kernel_mode"

    def under(mode):
        def call(p):
            with ops.override_mode(mode):
                return p.region_compute(pe, ("mean", "laplacian"), Stage.P)
        return call
    return [under("off"), under("on")]


@pytest.mark.parametrize("case", ["region", "materialize", "kernel_mode"])
def test_back_to_back_calls_equal_fresh_shard_programs(case):
    """One ``ShardPrograms`` takes calls that differ in one input; each
    equals the same call on a fresh one bitwise."""
    calls = _shard_calls(case)
    progs = ShardPrograms(_cpu_mesh(8))
    got = [call(progs) for call in calls]
    for i, (call, g) in enumerate(zip(calls, got)):
        _bitwise(call(ShardPrograms(_cpu_mesh(8))), g, f"{case} {i}")


# ===========================================================================
# on the card
# ===========================================================================

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("scheme", ["hszp_nd", "hszx_nd"])
def test_eight_shards_on_one_card_match_the_single_device_store(scheme):
    """8 shards on ``cuda:0``: every cell of the matrix through the store,
    bitwise the single-device store's on the card, launching the same
    kernels query for query."""
    dev = _card()
    comp = by_name(scheme)
    e = comp.encode(comp.compress(_data((480, 720)), rel_eb=1e-3,
                                  device=dev))
    sh = ShardedFieldStore(make_analytics_mesh(devices=[dev] * 8))
    ref = StreamFieldStore()
    sh.put("f", e)
    ref.put("f", e)
    for region in (None, ((100, 341), (50, 517))):
        for ops_, st in ((["mean", "std"], Stage.Q), ("gradient", Stage.P),
                         ("laplacian", Stage.P), ("gradient", Stage.Q),
                         ("laplacian", Stage.F), ("mean", "auto")):
            for _ in range(2):     # a miss, then a hit
                ops.reset_launches()
                a = query(["f"], ops_, st, region=region, store=ref)
                torch.cuda.synchronize()
                want = dict(ops.LAUNCHES)
                ops.reset_launches()
                b = query(["f"], ops_, st, region=region, store=sh)
                torch.cuda.synchronize()
                assert dict(ops.LAUNCHES) == want, (ops_, st, region)
                _bitwise(_cpu(a.values[0]), _cpu(b.values[0]))


@pytest.mark.gpu
def test_eight_shards_on_one_card_temporal_and_words():
    dev = _card()
    progs = ShardPrograms(make_analytics_mesh(devices=[dev] * 8))
    comp = by_name("hszp_nd")
    e = comp.encode(comp.compress(_data((480, 720)), rel_eb=1e-3,
                                  device=dev))
    for region in (None, ((100, 341), (50, 517))):
        _bitwise(_cpu(oplib.compute(e, ("mean", "gradient"), Stage.P,
                                    region=region)),
                 _cpu(progs.region_compute(e, ("mean", "gradient"), Stage.P,
                                           region=region)))
    sh, ref = ShardedFieldStore(progs.mesh), StreamFieldStore()
    sh.put_temporal("t", TemporalField("hszx_nd", rel_eb=1e-3, device=dev))
    ref.put_temporal("t", TemporalField("hszx_nd", rel_eb=1e-3, device=dev))
    for s in _slabs((8, 96, 80), n=2):
        sh.append("t", s)
        ref.append("t", s)
    a = query_temporal(["t"], ["tmean", "tdelta"], store=ref).values[0]
    b = query_temporal(["t"], ["tmean", "tdelta"], store=sh).values[0]
    _bitwise(_cpu(a), _cpu(b))


def _cpu(x):
    if isinstance(x, dict):
        return {k: _cpu(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_cpu(v) for v in x)
    return x.cpu()
