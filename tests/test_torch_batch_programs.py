"""Region, store-seeded and temporal batches as one program in the port,
against the per-field port and the JAX reference.

``BatchedAnalytics.run(..., region=, seeds=)`` stacks the fields (and
their seeds) once and calls ``oplib.compute`` once; ``summarize`` stacks
the slabs once and calls ``oplib.summarize_slab`` once.  What is held,
with its tolerance:

* region batches of 1 and 3 fields of different ``eps`` (an interior
  window, an odd-width three-row transect, a corner window) for both n-D
  schemes and both 1-D ones, ``Compressed`` and ``Encoded``, every
  feasible stage, mean / std / derivative / gradient / laplacian /
  divergence / curl: **bitwise** the port's per-field ``compute`` calls;
  at three fields, for each (scheme, container) one of the windows in
  turn, at stages ① to ③ (④ is ③'s integers times eps in both packages;
  the derivative alone at ②, where its closure is a band), the
  reference's batched run (its fused rules off) within the
  tolerances of ``tests/test_torch_analytics.py`` and
  ``tests/test_torch_region.py``: stencils bitwise, divergence / curl
  ``rtol=1e-6``, mean / std ``rtol 1e-5`` or half the paper's bias bound
  (1e-3 of it where it is eps; 1e-2 eps for the 1-D Lorenzo mean@②);
* seeded batches (② and ③ seeds from ``store.materialize``, scalar and
  vector sets, full field and a window, one and three fields):
  **bitwise** the unseeded batch and the per-field seeded calls;
* slab summaries of batches of 3 slabs of 4 timesteps at every feasible
  stage, ± a window, and of one slab of one timestep (``last2``
  duplicates it): every leaf **bitwise** the reference's ``summarize``
  and the per-slab ``summarize_slab``;
* the batched ``grad2d_int_plain`` (what the batched ``grad2d`` kernel is
  held to on the card): **bitwise** the per-field calls and the
  reference's ``jax.vmap`` of its Pallas ``grad2d`` in interpret mode, the
  integer planes and the ``× eps`` tail of each field's own eps;
* a region or seeded run builds one stage context per component, and on
  the CPU launches no kernel; a batch of one is a view of its field.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import analytics as janalytics
from repro.core import Stage as JStage
from repro.core import by_name as jax_by_name
from repro.kernels import ops as jops
from repro.kernels import stencil_dq as jstencil
from repro_torch import analytics, convert
from repro_torch.core import Stage, batch_stack, error_analysis, oplib
from repro_torch.core import region as R
from repro_torch.core.stages import LEAVES
from repro_torch.kernels import ops, stencil_dq
from repro_torch.store import materialize
from repro_torch.store.materialized import stack_seeds

ND = ["hszp_nd", "hszx_nd"]
SCHEMES = ND + ["hszp", "hszx"]
KINDS = ["Compressed", "Encoded"]
FIELD_SHAPE = (24, 40)
WINDOWS = {"interior": ((3, 17), (5, 31)),
           "transect": ((10, 13), (1, 40)),
           "corner": ((19, 24), (33, 40))}
SET = ["mean", "std", "gradient", "laplacian"]
STATS = ["mean", "std"]
VECTOR_SET = ["divergence", "curl"]
LEAF_NAMES = ("count", "q_sum", "q_sumsq", "q_min", "q_max", "last2")


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


def _compress(scheme, kind, data, eps):
    """Reference containers of ``data`` (one ``eps`` each, or one for
    all) and their port twins; ``Encoded`` ones packed at the widest of
    their widths, so they share one layout."""
    comp = jax_by_name(scheme)
    eps = eps if isinstance(eps, list) else [eps] * len(data)
    js = [comp.compress(jnp.asarray(d), abs_eb=e) for d, e in zip(data, eps)]
    if kind == "Encoded":
        bits = max(comp.max_bits(c) for c in js)
        js = [comp.encode(c, bits=bits) for c in js]
    return js, [to_port(c) for c in js]


def _fields(scheme, kind, n, seed=0):
    """``n`` same-layout fields of different ``eps``."""
    rng = np.random.default_rng(seed)
    data = [np.cumsum(rng.normal(0, 1, FIELD_SHAPE), axis=0).astype(np.float32)
            for _ in range(n)]
    return _compress(scheme, kind, data, [1e-2 * (1 + i) for i in range(n)])


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tup(x):
    return x if isinstance(x, tuple) else (x,)


def _bitwise(want, got, what=""):
    want, got = _tup(want), _tup(got)
    assert len(want) == len(got), what
    for w, g in zip(want, got):
        w, g = _np(w), _np(g)
        assert (w.shape, w.dtype) == (g.shape, g.dtype), what
        assert w.tobytes() == g.tobytes(), what


def _item(batched, i):
    return (tuple(x[i] for x in batched) if isinstance(batched, tuple)
            else batched[i])


def _close(op, want, got, field, stage, what):
    """The slice tolerances (``tests/test_torch_region.py``)."""
    if op in ("mean", "std"):
        w, g = float(_np(want)), float(_np(got))
        eps = float(field.eps.item())
        if (op, stage, field.scheme.value) == ("mean", Stage.P, "hszp"):
            tol = 1e-2 * eps
        else:
            bound = (error_analysis.mean_bias_bound if op == "mean"
                     else error_analysis.std_bias_bound)(field, stage)
            tol = max(1e-5 * abs(w), (1e-3 if bound >= eps else 0.5) * bound)
        assert abs(g - w) <= tol, (what, abs(g - w), tol)
    elif op in ("divergence", "curl"):
        for w, g in zip(_tup(want), _tup(got), strict=True):
            w, g = _np(w), _np(g)
            assert w.shape == g.shape, what
            np.testing.assert_allclose(g, w, rtol=1e-6,
                                       atol=1e-6 * float(np.abs(w).max()),
                                       err_msg=what)
    else:
        _bitwise(want, got, what)


def _region_runs(scheme, tf, reg):
    """(op set, stage, axis, vector) of every feasible run over ``reg``."""
    nd = scheme.endswith("_nd")
    out = []
    for stage in (Stage.P, Stage.Q, Stage.F):
        stencils = nd or stage != Stage.P
        out.append((SET if stencils else STATS, stage, 0, False))
        if stencils:
            out.append((["derivative"], stage, 1, False))
            out.append((VECTOR_SET, stage, 0, True))
    if scheme.startswith("hszx") and R.region_aligned(tf, reg):
        out.append((["mean"], Stage.M, 0, False))
    return out


REGION_CASES = [(s, k, w) for s in SCHEMES for k in KINDS for w in WINDOWS]


def _checks_reference(scheme, kind, window) -> bool:
    """Each (scheme, container) is held to the reference on one window, the
    windows taken in turn."""
    i = SCHEMES.index(scheme) + KINDS.index(kind)
    return list(WINDOWS)[i % len(WINDOWS)] == window


@pytest.mark.parametrize("scheme,kind,window", REGION_CASES,
                         ids=[f"{s}-{k}-{w}" for s, k, w in REGION_CASES])
def test_region_batches_match_fields_and_reference(scheme, kind, window):
    reg = WINDOWS[window]
    js, ts = _fields(scheme, kind, 6, seed=SCHEMES.index(scheme))
    eng, jeng = analytics.BatchedAnalytics(), janalytics.BatchedAnalytics()
    reference = _checks_reference(scheme, kind, window)
    for batch in (1, 3):
        items = {False: ts[:batch], True: list(zip(ts[0::2], ts[1::2]))[:batch]}
        jitems = {False: js[:batch],
                  True: list(zip(js[0::2], js[1::2]))[:batch]}
        for names, stage, axis, vector in _region_runs(scheme, ts[0], reg):
            res = eng.run(items[vector], names, stage, axis=axis, region=reg)
            jres = None
            # the derivative's own closure differs from its set's at ② only
            if (reference and batch == 3 and stage != Stage.F
                    and (names != ["derivative"] or stage == Stage.P)):
                with jops.override_mode("off"):
                    jres = jeng.run(jitems[vector], names,
                                    JStage(int(stage)), axis=axis, region=reg)
            for i, item in enumerate(items[vector]):
                one = oplib.compute(list(item) if vector else item, names,
                                    stage, axis=axis, region=reg)
                field = item[0] if vector else item
                for op in oplib.canonical_ops(names):
                    what = (f"{scheme} {kind} {window} {op}@{stage.name} "
                            f"batch {batch} field {i}")
                    got = _item(res[op], i)
                    _bitwise(one[op], got, what)
                    if jres is not None:
                        _close(op, _item(jres[op], i), got, field, stage, what)


# ===========================================================================
# store-seeded batches
# ===========================================================================

def _seeds(items, names, stage, reg, vector):
    """One materialization per field (per component for vector sets) of
    the cell the op set's prelude reads."""
    if vector:
        closures = oplib.component_closures(
            names, [c.scheme for c in items[0]], stage)
        return [tuple(materialize(c, stage, region=reg, closure=cl)
                      for c, cl in zip(item, closures)) for item in items]
    cl = oplib.set_closure(names, items[0].scheme, stage)
    return [materialize(c, stage, region=reg, closure=cl) for c in items]


SEED_CASES = [(s, k, r) for s in ND for k in KINDS
              for r in ("full", "interior", "transect")]


@pytest.mark.parametrize("scheme,kind,where", SEED_CASES,
                         ids=[f"{s}-{k}-{r}" for s, k, r in SEED_CASES])
def test_seeded_batches_match_unseeded_and_fields(scheme, kind, where):
    reg = None if where == "full" else WINDOWS[where]
    _, ts = _fields(scheme, kind, 6, seed=3)
    eng = analytics.BatchedAnalytics()
    for batch in (1, 3):
        for vector, names in ((False, SET), (True, VECTOR_SET)):
            items = (list(zip(ts[0::2], ts[1::2])) if vector else ts)[:batch]
            for seed_stage, stages in ((Stage.P, (Stage.P,)),
                                       (Stage.Q, (Stage.Q, Stage.F))):
                seeds = _seeds(items, names, seed_stage, reg, vector)
                for stage in stages:
                    cold = eng.run(items, names, stage, region=reg)
                    hot = eng.run(items, names, stage, region=reg,
                                  seeds=seeds)
                    for i, (item, seed) in enumerate(zip(items, seeds)):
                        one = oplib.compute(list(item) if vector else item,
                                            names, stage, region=reg,
                                            seed=list(seed) if vector
                                            else seed)
                        for op in names:
                            what = (f"{scheme} {kind} {where} {op}@"
                                    f"{stage.name} seeded at "
                                    f"{seed_stage.name} batch {batch} "
                                    f"field {i}")
                            _bitwise(_item(cold[op], i), _item(hot[op], i),
                                     what)
                            _bitwise(one[op], _item(hot[op], i), what)


def test_stack_seeds_of_one_is_a_view():
    _, ts = _fields("hszp_nd", "Compressed", 2)
    for stage in (Stage.P, Stage.Q):
        seeds = [materialize(c, stage, region=WINDOWS["interior"],
                             closure="hull") for c in ts]
        one, both = stack_seeds(seeds[:1]), stack_seeds(seeds)
        if stage == Stage.P:
            assert (one.sub.residuals.data_ptr()
                    == seeds[0].sub.residuals.data_ptr())
            assert tuple(both.sub.residuals.shape[:1]) == (2,)
        else:
            assert one.q_spatial.data_ptr() == seeds[0].q_spatial.data_ptr()
            assert tuple(both.q_spatial.shape) == (
                (2,) + tuple(seeds[0].q_spatial.shape))
        assert (one.stage, one.closure, one.region) == (
            seeds[0].stage, seeds[0].closure, seeds[0].region)
    view = batch_stack(ts[:1])
    for name in LEAVES["Compressed"]:
        assert (getattr(view, name).data_ptr()
                == getattr(ts[0], name).data_ptr()), name


# ===========================================================================
# slab summaries
# ===========================================================================

def _slabs(scheme, kind, n, k, seed=0):
    """``n`` same-layout slabs of ``k`` timesteps on one eps (one stream's
    quantization grid)."""
    rng = np.random.default_rng(seed)
    base = np.cumsum(rng.normal(0, 1, FIELD_SHAPE), axis=0).astype(np.float32)
    data = [(base[None] + 0.1 * (i * k + np.arange(k))[:, None, None]
             + rng.normal(0, 0.05, (k,) + FIELD_SHAPE)).astype(np.float32)
            for i in range(n)]
    return _compress(scheme, kind, data, 1e-2)


SUMMARY_CASES = [(s, k) for s in SCHEMES for k in KINDS]


@pytest.mark.parametrize("scheme,kind", SUMMARY_CASES,
                         ids=[f"{s}-{k}" for s, k in SUMMARY_CASES])
def test_batched_summaries_match_reference(scheme, kind):
    stages = analytics.feasible_stages(oplib.Scheme(scheme), "tmean")
    eng, jeng = analytics.BatchedAnalytics(), janalytics.BatchedAnalytics()
    # every stage, the full field and a window in turn; a batch of one
    # slab of one timestep (last2 duplicates it)
    cases = [(3, 4, stage, (None, WINDOWS["interior"])[i % 2])
             for i, stage in enumerate(stages)]
    cases.append((1, 1, stages[-1], WINDOWS["corner"]))
    for n, k, stage, reg in cases:
        jslabs, tslabs = _slabs(scheme, kind, n, k, seed=n + k)
        got = eng.summarize(tslabs, stage, region=reg)
        want = jeng.summarize(jslabs, JStage(int(stage)), region=reg)
        for name in LEAF_NAMES:
            _bitwise(getattr(want, name), getattr(got, name),
                     f"{scheme} {kind} {n} x {k} {stage.name} {reg} {name}")
        for i, slab in enumerate(tslabs):
            one = oplib.summarize_slab(slab, stage, region=reg)
            for name in LEAF_NAMES:
                _bitwise(getattr(one, name), getattr(got, name)[i],
                         f"slab {i} {name}")


# ===========================================================================
# the batched grad2d plain version
# ===========================================================================

@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("shape", [(7, 9), (24, 40), (3, 130)])
def test_batched_grad2d_matches_fields_and_vmap(shape, batch):
    rng = np.random.default_rng(batch + shape[1])
    q = rng.integers(-2 ** 31, 2 ** 31, (batch,) + shape,
                     dtype=np.int64).astype(np.int32)
    eps = (1e-3 * (1 + np.arange(batch))).astype(np.float32)
    tq = torch.as_tensor(q)
    d0, d1 = stencil_dq.grad2d_int_plain(tq)
    teps = torch.as_tensor(eps).reshape(batch, 1, 1)
    f0, f1 = d0.to(torch.float32) * teps, d1.to(torch.float32) * teps
    for b in range(batch):
        _bitwise(stencil_dq.grad2d_int_plain(tq[b]), (d0[b], d1[b]),
                 f"field {b}")
        _bitwise(stencil_dq.grad2d(tq[b], float(eps[b])), (f0[b], f1[b]),
                 f"field {b} x eps")
    ref = jax.vmap(functools.partial(jstencil.grad2d, interpret=True))(
        jnp.asarray(q), jnp.asarray(eps))
    _bitwise(ref, (f0, f1), "vmap grad2d")
    ops.reset_launches()
    stencil_dq.grad2d_int(tq)
    assert set(ops.LAUNCHES.values()) == {0}


# ===========================================================================
# one stage context per component
# ===========================================================================

def test_region_and_seeded_runs_build_one_context_per_component(monkeypatch):
    built = []
    real = oplib.StageContext.__init__

    def counting(self, c, *args, **kw):
        built.append(type(c).__name__)
        real(self, c, *args, **kw)

    _, ts = _fields("hszx_nd", "Encoded", 6)
    pairs = list(zip(ts[0::2], ts[1::2]))
    reg = WINDOWS["interior"]
    seeds = _seeds(ts, SET, Stage.Q, reg, False)
    vseeds = _seeds(pairs, VECTOR_SET, Stage.P, None, True)
    jslabs, slabs = _slabs("hszx_nd", "Encoded", 3, 2)
    monkeypatch.setattr(oplib.StageContext, "__init__", counting)
    eng = analytics.BatchedAnalytics()
    ops.reset_launches()
    for run, want in (
            (lambda: eng.run(ts, SET, Stage.P, region=reg), 1),
            (lambda: eng.run(pairs, VECTOR_SET, Stage.Q, region=reg), 2),
            (lambda: eng.run(ts, SET, Stage.Q, region=reg, seeds=seeds), 1),
            (lambda: eng.run(pairs, VECTOR_SET, Stage.P, seeds=vseeds), 2),
            (lambda: eng.summarize(slabs, Stage.P, region=reg), 1)):
        built.clear()
        run()
        assert len(built) == want
    assert set(ops.LAUNCHES.values()) == {0}
