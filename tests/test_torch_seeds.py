"""Materialized seeds and pre-gathered payload words: the port against the
JAX reference.

The same numpy fields go through the reference (``repro``, CPU, Pallas in
interpret mode) and the port (``repro_torch``, ``device="cpu"``):

* ``materialize`` at stages ②③④ (④ stores ③), with and without a region,
  equal to the reference's leaf for leaf, bitwise, and with the same key;
  ``materialized_nbytes`` exactly the realized ``nbytes`` and the
  reference's prediction;
* a reference seed carried into the port by ``convert.seed_from_arrays``
  seeds ``compute`` to the port's unseeded answers bitwise (the reference's
  answers within the tolerances of ``tests/test_torch_slice.py``, which
  ``tests/test_torch_region.py`` holds);
* seeded == unseeded bitwise in the port for every op set and stage, field
  and vector arity; a seed whose key does not match raises ``ValueError``
  in both packages;
* ``payload_words=`` (the region plan's gathered words) equals the plain
  region path bitwise, one word set per component for vector ops.

It mirrors the ``MaterializedStage`` tests of ``tests/test_store.py``.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Stage as JStage
from repro.core import by_name as jax_by_name
from repro.core import homomorphic as JH
from repro.core import oplib as joplib
from repro.core import region as JR
from repro.store import materialize as jax_materialize
from repro.store import materialized_nbytes as jax_materialized_nbytes
from repro_torch import convert
from repro_torch.core import Stage, by_name, layout_key, oplib
from repro_torch.core import homomorphic as H
from repro_torch.core import region as R
from repro_torch.store import (MaterializedStage, materialize,
                               materialized_nbytes, serves, storage_stage)

ALL = ["hszp", "hszx", "hszp_nd", "hszx_nd"]
ND = ["hszp_nd", "hszx_nd"]
REGION = ((30, 75), (10, 52))    # unaligned window of the 181 x 97 field
VREGION = ((20, 60), (40, 90))   # window of the 128 x 128 vector field
SETS = [("mean", "std"), ("mean", "std", "laplacian"), ("std", "derivative"),
        ("mean", "gradient")]

_INPUTS: dict[str, tuple[np.ndarray, ...]] = {}


@pytest.fixture(scope="module", autouse=True)
def _register(field_2d, vector_field_2d):
    _INPUTS["scalar"] = (np.ascontiguousarray(field_2d),)
    _INPUTS["vector"] = tuple(np.ascontiguousarray(a) for a in vector_field_2d)


@functools.lru_cache(maxsize=None)
def _pairs(scheme: str, container: str, key: str = "scalar"):
    jcomp, tcomp = jax_by_name(scheme), by_name(scheme)
    arrays = _INPUTS[key]
    jc = [jcomp.compress(jnp.asarray(a), rel_eb=1e-3) for a in arrays]
    tc = [tcomp.compress(a, rel_eb=1e-3, device="cpu") for a in arrays]
    if container == "encoded":
        return [jcomp.encode(c) for c in jc], [tcomp.encode(c) for c in tc]
    return jc, tc


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bitwise(want, got, what):
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(want) == len(got), what
    for w, g in zip(want, got):
        w, g = _np(w), _np(g)
        assert (w.shape, w.dtype) == (g.shape, g.dtype), what
        assert w.tobytes() == g.tobytes(), what


def _same_sets(want: dict, got: dict, what):
    assert list(want) == list(got), what
    for name in want:
        _bitwise(want[name], got[name], f"{what} {name}")


def _stages(scheme, ops_):
    out = []
    for s in (Stage.P, Stage.Q, Stage.F):
        if s == Stage.P and not scheme.endswith("_nd") and any(
                o not in ("mean", "std") for o in ops_):
            continue
        out.append(s)
    return out


_LEAVES = ("residuals", "metadata", "bitwidths", "eps", "valid_counts")


def _ref_seed_arrays(m) -> dict:
    """A reference ``MaterializedStage`` as ``convert.seed_from_arrays``'s
    keyword arguments (numpy data, the key as it is)."""
    out = {"stage": int(m.stage), "closure": m.closure, "region": m.region}
    if m.sub is not None:
        c = m.sub
        meta = {"scheme": c.scheme.value, "shape": c.shape,
                "padded_shape": c.padded_shape, "block": c.block,
                "orig_dtype": np.dtype(c.orig_dtype).name}
        out["sub"] = ("Compressed",
                      {n: np.asarray(getattr(c, n)) for n in _LEAVES}, meta)
    else:
        out["q_spatial"] = np.asarray(m.q_spatial)
    return out


# ===========================================================================
# materialize: leaf for leaf the reference's
# ===========================================================================

MAT_CELLS = [(s, c) for s in ALL for c in ("compressed", "encoded")]


@pytest.mark.parametrize("scheme,container", MAT_CELLS,
                         ids=[f"{s}-{c}" for s, c in MAT_CELLS])
def test_materialize_matches_reference(scheme, container):
    (jf,), (tf,) = _pairs(scheme, container)
    for stage in (Stage.P, Stage.Q, Stage.F):
        for region, ops_ in ((None, ("mean",)), (REGION, ("mean", "std")),
                             (REGION, ("gradient",))):
            if stage == Stage.P and ops_ == ("gradient",) and \
                    not scheme.endswith("_nd"):
                continue
            js = JStage(int(stage))
            jcl = joplib.set_closure(ops_, jf.scheme, js)
            tcl = oplib.set_closure(ops_, tf.scheme, stage)
            assert jcl == tcl
            jm = jax_materialize(jf, js, region=region, closure=jcl)
            tm = materialize(tf, stage, region=region, closure=tcl)
            what = f"{scheme} {container} {stage.name} {region} {ops_}"
            assert (int(jm.stage), jm.closure, jm.region) == (
                int(tm.stage), tm.closure, tm.region), what
            assert (jm.sub is None) == (tm.sub is None), what
            if tm.sub is not None:
                for leaf in _LEAVES:
                    _bitwise(getattr(jm.sub, leaf), getattr(tm.sub, leaf),
                             f"{what} {leaf}")
                assert (jm.sub.shape, jm.sub.padded_shape) == (
                    tm.sub.shape, tm.sub.padded_shape), what
                assert tm.q_spatial is None
            else:
                _bitwise(jm.q_spatial, tm.q_spatial, f"{what} q_spatial")
                assert tm.q_spatial.is_contiguous()
            assert jm.nbytes == tm.nbytes, what
            assert materialized_nbytes(tf, stage, region=region,
                                       closure=tcl) == tm.nbytes, what
            assert jax_materialized_nbytes(jf, js, region=region,
                                           closure=jcl) == tm.nbytes, what


@pytest.mark.parametrize("scheme", ALL)
def test_materialized_stage_leaves_and_sig(scheme):
    """The port's counterpart of the reference's pytree test: a frozen
    dataclass of tensors whose ``nbytes`` is the sum of its leaves, whose
    ``sig`` survives a copy, and whose key is the reference's."""
    (_, (te,)) = _pairs(scheme, "encoded")
    m = materialize(te, Stage.Q)
    assert m.nbytes == m.q_spatial.numel() * m.q_spatial.element_size()
    m2 = dataclasses.replace(m, q_spatial=m.q_spatial.clone())
    assert isinstance(m2, MaterializedStage) and m2.sig() == m.sig()
    with pytest.raises(dataclasses.FrozenInstanceError):
        m.stage = Stage.P
    p = materialize(te, Stage.P)
    leaves = [getattr(p.sub, n) for n in _LEAVES]
    assert p.nbytes == sum(t.numel() * t.element_size() for t in leaves)
    assert p.sig()[3] == layout_key(p.sub)
    assert layout_key(p.sub) == ("Compressed", te.scheme, te.shape,
                                 te.padded_shape, te.block, "float32")
    assert layout_key(te)[-1] == te.bits


def test_layout_key_matches_reference():
    from repro.core import layout_key as jax_layout_key
    for scheme in ALL:
        for container in ("compressed", "encoded"):
            (jf,), (tf,) = _pairs(scheme, container)
            jk, tk = jax_layout_key(jf), layout_key(tf)
            assert jk[:5] == tk[:5] and str(jk[5]) == tk[5] and jk[6:] == tk[6:]


def test_serves_and_storage_stage():
    assert storage_stage(Stage.F) == Stage.Q
    assert storage_stage(Stage.P) == Stage.P
    assert serves(Stage.Q, Stage.F) and serves(Stage.P, Stage.P)
    assert not serves(Stage.F, Stage.Q) and not serves(Stage.P, Stage.Q)


def test_materialize_rejects_stage_m():
    (_, (te,)) = _pairs("hszx_nd", "encoded")
    with pytest.raises(ValueError, match="already resident"):
        materialize(te, Stage.M)
    with pytest.raises(ValueError, match="never materialized"):
        materialized_nbytes(te, Stage.M)


def test_mismatched_seed_rejected():
    """Same conditions, same exception type as the reference's."""
    (je,), (te,) = _pairs("hszp_nd", "encoded")
    jq, tq = jax_materialize(je, JStage.Q), materialize(te, Stage.Q)
    with pytest.raises(ValueError, match="does not match"):
        JH.compute(je, "mean", JStage.P, seed=jq)
    with pytest.raises(ValueError, match="does not match"):
        H.compute(te, "mean", Stage.P, seed=tq)
    jr = jax_materialize(je, JStage.Q, region=REGION, closure="hull")
    tr = materialize(te, Stage.Q, region=REGION, closure="hull")
    with pytest.raises(ValueError, match="does not match"):
        JH.compute(je, "mean", JStage.Q, seed=jr)
    with pytest.raises(ValueError, match="does not match"):
        H.compute(te, "mean", Stage.Q, seed=tr)
    # a band closure seeds the single derivative, not the set's hull
    band = materialize(te, Stage.P, region=REGION, closure=("band", 0))
    got = H.compute(te, "derivative", Stage.P, region=REGION, seed=band)
    _bitwise(H.derivative(te, Stage.P, 0, region=REGION), got["derivative"],
             "band seed")
    with pytest.raises(ValueError, match="does not match"):
        H.compute(te, ["derivative", "mean"], Stage.P, region=REGION, seed=band)


def test_seed_on_another_device_rejected():
    (_, (te,)) = _pairs("hszp_nd", "encoded")
    m = materialize(te, Stage.Q)
    away = dataclasses.replace(m, q_spatial=m.q_spatial.to("meta"))
    with pytest.raises(ValueError, match="lies on meta"):
        H.compute(te, "mean", Stage.Q, seed=away)


# ===========================================================================
# seeded == unseeded, bitwise; reference seeds carried into the port
# ===========================================================================

SEED_CELLS = [(s, c, o) for s in ALL for c in ("compressed", "encoded")
              for o in SETS]


@pytest.mark.parametrize("scheme,container,ops_", SEED_CELLS,
                         ids=[f"{s}-{c}-{'+'.join(o)}" for s, c, o in SEED_CELLS])
def test_seeded_equals_unseeded(scheme, container, ops_):
    (_, (tf,)) = _pairs(scheme, container)
    for stage in _stages(scheme, ops_):
        for region in (None, REGION):
            closure = oplib.set_closure(ops_, tf.scheme, stage, 1)
            seed = materialize(tf, stage, region=region, closure=closure)
            want = H.compute(tf, ops_, stage, axis=1, region=region)
            got = H.compute(tf, ops_, stage, axis=1, region=region, seed=seed)
            _same_sets(want, got, f"{scheme} {container} {stage.name} {region}")


@pytest.mark.parametrize("scheme", ND)
def test_seeded_vector_equals_unseeded(scheme):
    (_, tv) = _pairs(scheme, "encoded", "vector")
    ops_ = ("divergence", "curl")
    for stage in (Stage.P, Stage.Q, Stage.F):
        for region in (None, VREGION):
            closures = oplib.component_closures(
                ops_, [c.scheme for c in tv], stage)
            seeds = [materialize(c, stage, region=region, closure=cl)
                     for c, cl in zip(tv, closures)]
            _same_sets(H.compute(tv, ops_, stage, region=region),
                       H.compute(tv, ops_, stage, region=region, seed=seeds),
                       f"{scheme} vector {stage.name} {region}")


@pytest.mark.parametrize("scheme", ALL)
def test_reference_seed_carried_into_port(scheme):
    """A seed the reference materialized, carried over by ``convert``,
    carries the port's key and seeds the port to its own unseeded answers
    bitwise."""
    for container in ("compressed", "encoded"):
        (jf,), (tf,) = _pairs(scheme, container)
        for ops_ in (("mean", "std"), ("mean", "gradient")):
            for stage in _stages(scheme, ops_):
                for region in (None, REGION):
                    js = JStage(int(stage))
                    cl = joplib.set_closure(ops_, jf.scheme, js)
                    jm = jax_materialize(jf, js, region=region, closure=cl)
                    tm = convert.seed_from_arrays(**_ref_seed_arrays(jm),
                                                  device="cpu")
                    assert tm.sig() == materialize(
                        tf, stage, region=region,
                        closure=oplib.set_closure(ops_, tf.scheme, stage)).sig()
                    what = f"{scheme} {container} {stage.name} {region} {ops_}"
                    _same_sets(H.compute(tf, ops_, stage, region=region),
                               H.compute(tf, ops_, stage, region=region,
                                         seed=tm), what)
    with pytest.raises(ValueError, match="exactly one"):
        convert.seed_from_arrays(Stage.Q, "cover", None, device="cpu")


@pytest.mark.parametrize("scheme", ND)
def test_reference_seed_gives_reference_answers(scheme):
    """The seeded port against the seeded reference: stencils bitwise."""
    (je,), (te,) = _pairs(scheme, "encoded")
    ops_ = ("gradient", "laplacian")
    for stage in (Stage.P, Stage.Q, Stage.F):
        js = JStage(int(stage))
        cl = joplib.set_closure(ops_, je.scheme, js)
        jm = jax_materialize(je, js, region=REGION, closure=cl)
        tm = convert.seed_from_arrays(**_ref_seed_arrays(jm), device="cpu")
        _same_sets(JH.compute(je, ops_, js, region=REGION, seed=jm),
                   H.compute(te, ops_, stage, region=REGION, seed=tm),
                   f"{scheme} {stage.name}")


# ===========================================================================
# pre-gathered payload words
# ===========================================================================

def _words(e, plan):
    gi = plan.device_gather(e.bits, e.payload.device)
    return e.payload.index_select(0, gi.word_idx.to(torch.int64))


@pytest.mark.parametrize("scheme", ALL)
def test_payload_words_equal_plain_region_path(scheme):
    (je,), (te,) = _pairs(scheme, "encoded")
    for ops_ in SETS:
        for stage in _stages(scheme, ops_):
            closure = oplib.set_closure(ops_, te.scheme, stage, 1)
            plan = R.plan_region(te, REGION, closure)
            got = H.compute(te, ops_, stage, axis=1, region=REGION,
                            payload_words=_words(te, plan))
            _same_sets(H.compute(te, ops_, stage, axis=1, region=REGION), got,
                       f"{scheme} {stage.name} {ops_}")
            if ops_ == ("mean", "gradient") and scheme.endswith("_nd"):
                # the reference's words path: its gradient bitwise
                gi = JR.plan_region(je, REGION, closure).payload_gather(je.bits)
                want = JH.compute(je, "gradient", JStage(int(stage)),
                                  region=REGION,
                                  payload_words=je.payload[gi.word_idx])
                _bitwise(want["gradient"], got["gradient"],
                         f"{scheme} {stage.name} vs reference")


@pytest.mark.parametrize("scheme", ND)
def test_payload_words_vector_ops(scheme):
    (_, tv) = _pairs(scheme, "encoded", "vector")
    ops_ = ("divergence", "curl")
    for stage in (Stage.P, Stage.Q, Stage.F):
        closures = oplib.component_closures(ops_, [c.scheme for c in tv], stage)
        words = [_words(c, R.plan_region(c, VREGION, cl))
                 for c, cl in zip(tv, closures)]
        _same_sets(H.compute(tv, ops_, stage, region=VREGION),
                   H.compute(tv, ops_, stage, region=VREGION,
                             payload_words=words),
                   f"{scheme} vector words {stage.name}")
        with pytest.raises(ValueError, match="payload word sets"):
            H.compute(tv, ops_, stage, region=VREGION, payload_words=words[:1])


def test_payload_words_with_a_seed_take_the_seed():
    """A stage-② seed holds the decoded sub-field, so words are not read."""
    (_, (te,)) = _pairs("hszp_nd", "encoded")
    closure = oplib.set_closure(("mean", "std"), te.scheme, Stage.P)
    seed = materialize(te, Stage.P, region=REGION, closure=closure)
    plan = R.plan_region(te, REGION, closure)
    _same_sets(H.compute(te, ("mean", "std"), Stage.P, region=REGION),
               H.compute(te, ("mean", "std"), Stage.P, region=REGION,
                         seed=seed, payload_words=_words(te, plan)), "seed+words")
