"""Region queries of the port against the JAX reference.

The same numpy fields (the conftest's ``field_2d`` 181 x 97,
``vector_field_2d`` 128 x 128 and ``field_3d`` 24 x 40 x 33) go through the
reference (``repro``, CPU, its Pallas kernels in interpret mode as its own
tests run them) and the port (``repro_torch``, ``device="cpu"``, where every
kernel wrapper takes its plain version), with ``region=``.  What is held:

* plan geometry — block ids, sub shapes, window, overlap, alignment, the
  payload-gather arrays (host and device copies), Lorenzo weights and
  closure fractions — **exactly** equal, for all four schemes;
* region results, with the tolerances of ``tests/test_torch_slice.py``:
  derivative / gradient / laplacian **bitwise**; divergence / curl
  ``rtol=1e-6``, ``atol=1e-6·max|ref|``; mean / std ``rtol=1e-5`` or half
  of the paper's bias bound (1e-3 of it where the bound is eps).  The 1-D
  Lorenzo stage-② mean is looser, 1e-2·eps, as on the full field (one f32
  dot of every gathered residual with weights up to the window size).  On
  a small window the single-pass moments form of std cancels so much that
  both packages land ~1e-3·eps from the exact value in different
  directions; a statistic also passes when the port lies no farther from
  the exact window statistic (float64 over the stage-③ integers) than the
  reference does;
* the same exception types for the same conditions.

Then the reference's own region tests (``test_region.py`` less its
analytics/serve tests, the region halves of ``test_fused.py`` and
``test_fused_kernels.py``, ``test_oracle_fields.py``) run on the port.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Stage as JStage
from repro.core import UnsupportedStageError as JUnsupported
from repro.core import by_name as jax_by_name
from repro.core import encode as jax_encode
from repro.core import homomorphic as JH
from repro.core import region as JR
from repro_torch.core import (Scheme, Stage, UnsupportedStageError, by_name,
                              encode, error_analysis, oplib)
from repro_torch.core import fused as fused_mod
from repro_torch.core import homomorphic as H
from repro_torch.core import region as R
from repro_torch.kernels import ops

ALL = ["hszp", "hszx", "hszp_nd", "hszx_nd"]
ND = ["hszp_nd", "hszx_nd"]
CONTAINERS = ["compressed", "encoded"]

#: windows of the 181 x 97 field: unaligned interior, touching the far
#: corner (the partial padded blocks), touching the origin, the whole field
REGIONS_2D = {"interior": ((30, 75), (10, 52)),
              "far-edge": ((170, 181), (80, 97)),
              "origin": ((0, 9), (0, 40)),
              "full": ((0, 181), (0, 97))}
#: windows of the 128 x 128 vector field
REGIONS_VEC = {"interior": ((20, 60), (40, 90)),
               "far-edge": ((100, 128), (3, 50)),
               "full": ((0, 128), (0, 128))}
#: windows of the 24 x 40 x 33 field
REGIONS_3D = {"interior": ((4, 20), (10, 36), (5, 29)),
              "far-edge": ((17, 24), (30, 40), (20, 33))}

_INPUTS: dict[str, tuple[np.ndarray, ...]] = {}


@pytest.fixture(scope="module", autouse=True)
def _register(field_2d, vector_field_2d, field_3d):
    _INPUTS["scalar"] = (np.ascontiguousarray(field_2d),)
    _INPUTS["vector"] = tuple(np.ascontiguousarray(a) for a in vector_field_2d)
    _INPUTS["scalar3d"] = (np.ascontiguousarray(field_3d),)
    f3 = field_3d
    _INPUTS["vector3d"] = tuple(np.ascontiguousarray(a, np.float32) for a in (
        f3, np.roll(f3, 3, axis=0) * 0.5, np.flip(f3, axis=2) + 1.0))


@functools.lru_cache(maxsize=None)
def _pairs(scheme: str, container: str, key: str):
    """(reference containers, port containers) of the registered inputs."""
    jcomp, tcomp = jax_by_name(scheme), by_name(scheme)
    arrays = _INPUTS[key]
    jc = [jcomp.compress(jnp.asarray(a), abs_eb=1e-3) for a in arrays]
    tc = [tcomp.compress(a, abs_eb=1e-3, device="cpu") for a in arrays]
    if container == "encoded":
        return [jcomp.encode(c) for c in jc], [tcomp.encode(c) for c in tc]
    return jc, tc


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tup(x):
    return x if isinstance(x, tuple) else (x,)


def _bitwise(want, got, what):
    assert len(_tup(want)) == len(_tup(got)), what
    for w, g in zip(_tup(want), _tup(got)):
        w, g = _np(w), _np(g)
        assert (w.shape, w.dtype) == (g.shape, g.dtype), what
        assert w.tobytes() == g.tobytes(), what


def _close_vector(want, got, what):
    for w, g in zip(_tup(want), _tup(got), strict=True):
        w, g = _np(w), _np(g)
        assert w.shape == g.shape, what
        np.testing.assert_allclose(g, w, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(w).max()),
                                   err_msg=what)


def _close_stat(want, got, field, stage, op, what, exact=None):
    w, g = float(_np(want)), float(_np(got))
    eps = float(field.eps.item())
    if exact is not None and abs(g - exact) <= abs(w - exact):
        return
    if (op, stage, field.scheme.value) == ("mean", Stage.P, "hszp"):
        tol = 1e-2 * eps
    else:
        bound = (error_analysis.mean_bias_bound if op == "mean"
                 else error_analysis.std_bias_bound)(field, stage)
        tol = max(1e-5 * abs(w), (1e-3 if bound >= eps else 0.5) * bound)
    assert abs(g - w) <= tol, (what, abs(g - w), tol)


def _exact_stats(field, region) -> dict[str, float]:
    """The window's mean and std (ddof 1) in float64 over the port's
    stage-③ integers (bitwise the reference's), times 2·eps."""
    q = by_name(field.scheme.value).decompress(field, Stage.Q).numpy()
    w = q[tuple(slice(s, e) for s, e in region)].astype(np.float64)
    two_eps = 2.0 * float(field.eps.item())
    return {"mean": w.mean() * two_eps, "std": w.std(ddof=1) * two_eps}


def _compare(want: dict, got: dict, field, stage, what, exact=None):
    assert list(want) == list(got), what
    for name in want:
        if name in ("mean", "std"):
            _close_stat(want[name], got[name], field, stage, name,
                        f"{what} {name}", exact and exact[name])
        elif name in ("divergence", "curl"):
            _close_vector(want[name], got[name], f"{what} {name}")
        else:
            _bitwise(want[name], got[name], f"{what} {name}")


def _stages(scheme: str, ops_: tuple) -> list[Stage]:
    nd = scheme.endswith("_nd")
    stages = [Stage.Q, Stage.F] + ([Stage.P] if nd else [])
    if all(o in ("mean", "std") for o in ops_):
        stages = [Stage.P, Stage.Q, Stage.F]
    return stages


# ===========================================================================
# plan geometry: exactly the reference's
# ===========================================================================

CLOSURES = ["cover", "hull", ("band", 0), ("band", 1)]


def _same_plan(jp, tp, what):
    for name in ("grid", "sub_shape", "sub_padded_shape", "win_shape",
                 "n_window", "n_sub_blocks", "gathered_elems", "aligned",
                 "grid_ranges", "closure", "region"):
        assert getattr(jp, name) == getattr(tp, name), (what, name)
    assert jp.window == tp.window, what
    for name in ("block_ids", "overlap", "win_pos"):
        j, t = getattr(jp, name), getattr(tp, name)
        assert (j is None) == (t is None), (what, name)
        if j is not None:
            assert j.dtype == t.dtype and np.array_equal(j, t), (what, name)
    for jw, tw in zip(jp.lorenzo_mean_weights(), tp.lorenzo_mean_weights(),
                      strict=True):
        assert jw.dtype == tw.dtype and np.array_equal(jw, tw), what


@pytest.mark.parametrize("scheme", ALL)
@pytest.mark.parametrize("region", list(REGIONS_2D), ids=str)
def test_plan_geometry_matches_reference(scheme, region):
    (je,), (te,) = _pairs(scheme, "encoded", "scalar")
    reg = REGIONS_2D[region]
    for closure in CLOSURES:
        jp = JR.plan_region(je, reg, closure)
        tp = R.plan_region(te, reg, closure)
        what = f"{scheme} {region} {closure}"
        _same_plan(jp, tp, what)
        for bits in sorted({0, 1, te.bits, 17, 32}):
            jg, tg = jp.payload_gather(bits), tp.payload_gather(bits)
            dg = tp.device_gather(bits, torch.device("cpu"))
            assert jg.n_values == tg.n_values == dg.n_values, what
            for name in ("word_idx", "pos0", "pos1", "shift"):
                j, t = getattr(jg, name), getattr(tg, name)
                d = getattr(dg, name)
                assert j.dtype == t.dtype and np.array_equal(j, t), (what, name)
                assert d.dtype == torch.int32, (what, name)
                assert np.array_equal(d.numpy(), j.astype(np.int64)), (what, name)
    assert JR.region_aligned(je, reg) == R.region_aligned(te, reg)
    for op in ("mean", "derivative", "gradient", "laplacian", "divergence"):
        for stage in (Stage.M, Stage.P, Stage.Q, Stage.F):
            for axis in (0, 1):
                assert JR.closure_fraction(je, op, JStage(int(stage)), reg,
                                           axis=axis) == R.closure_fraction(
                    te, op, stage, reg, axis=axis), (scheme, op, stage, axis)


@pytest.mark.parametrize("scheme", ND)
def test_plan_geometry_3d_matches_reference(scheme):
    (jc,), (tc,) = _pairs(scheme, "compressed", "scalar3d")
    for name, reg in REGIONS_3D.items():
        for closure in CLOSURES + [("band", 2)]:
            jp, tp = JR.plan_region(jc, reg, closure), R.plan_region(tc, reg, closure)
            _same_plan(jp, tp, f"{scheme} 3-D {name} {closure}")
            jg, tg = jp.payload_gather(9), tp.payload_gather(9)
            for a in ("word_idx", "pos0", "pos1", "shift"):
                assert np.array_equal(getattr(jg, a), getattr(tg, a))


@pytest.mark.parametrize("scheme", ALL)
def test_canonical_and_op_closures_match_reference(scheme):
    for closure in CLOSURES:
        for region in (None, REGIONS_2D["interior"]):
            assert JR.canonical_closure(scheme, closure, region) == \
                R.canonical_closure(scheme, closure, region)
    for op in ("mean", "std", "derivative", "gradient", "laplacian"):
        for stage in (Stage.M, Stage.P, Stage.Q, Stage.F):
            for axis in (0, 1):
                assert JR.op_closure(scheme, op, JStage(int(stage)), axis) == \
                    R.op_closure(scheme, op, stage, axis)


def test_normalize_region_matches_reference():
    shape = (181, 97)
    for spec in (((30, 75), (10, 52)), (slice(30, 75), None),
                 ((-20, -1), slice(None, 40)), (None, (np.int64(3), 9))):
        assert JR.normalize_region(spec, shape) == R.normalize_region(spec, shape)
    for bad in (((0, 300), (0, 10)), ((0, 10),), (slice(0, 10, 2), None),
                ((5, 5), None)):
        with pytest.raises(ValueError):
            JR.normalize_region(bad, shape)
        with pytest.raises(ValueError):
            R.normalize_region(bad, shape)


def test_closure_lattice_matches_reference():
    from repro.core import oplib as joplib
    for ops_ in (("mean",), ("derivative",), ("mean", "derivative"),
                 ("gradient", "std"), ("laplacian",)):
        for scheme in ALL:
            for stage in (Stage.P, Stage.Q, Stage.F):
                for axis in (0, 1):
                    assert joplib.set_closure(ops_, scheme, JStage(int(stage)),
                                              axis) == oplib.set_closure(
                        ops_, scheme, stage, axis), (ops_, scheme, stage)
    for ops_ in (("divergence",), ("curl",), ("divergence", "curl")):
        for schemes in (("hszp_nd", "hszp_nd"), ("hszx_nd", "hszp_nd"),
                        ("hszp_nd",) * 3):
            for stage in (Stage.P, Stage.Q):
                assert joplib.component_closures(
                    ops_, schemes, JStage(int(stage))) == \
                    oplib.component_closures(ops_, schemes, stage)
    for bad in (("hull", "cover"), ()):
        with pytest.raises(ValueError):
            joplib.join_closures(bad)
        with pytest.raises(ValueError):
            oplib.join_closures(bad)
    assert oplib.join_closures([("band", 0), ("band", 1)]) == "hull"
    with pytest.raises(ValueError):
        oplib.set_closure(("curl",), "hszp_nd", Stage.Q)
    with pytest.raises(ValueError):
        oplib.component_closures(("mean",), ("hszp_nd",), Stage.Q)


# ===========================================================================
# the registry: closures, validation, user-registered ops
# ===========================================================================

def test_op_specs_match_reference():
    """Every built-in op: same arity, axis need, closures and vector
    component axes as the reference's, and no structural violation."""
    from repro.core import oplib as joplib
    assert list(oplib.OPS) == [n for n, sp in joplib.OPS.items()
                               if sp.arity in ("field", "vector")]
    for name, spec in oplib.OPS.items():
        ref = joplib.OPS[name]
        assert (spec.arity, spec.category, spec.needs_axis) == (
            ref.arity, ref.category, ref.needs_axis), name
        assert oplib.spec_violations(spec) == [], name
        if spec.arity == "vector":
            for nc in (2, 3):
                assert spec.component_axes(nc) == ref.component_axes(nc)
            continue
        for scheme in ALL:
            for stage in spec.feasible(Scheme(scheme)):
                for axis in (0, 1):
                    assert spec.closure(scheme, stage, axis) == ref.closure(
                        scheme, JStage(int(stage)), axis), (name, scheme, stage)
                assert len(oplib.resolve_rules(spec, scheme, stage)) == 1


def _spec(name, **kw):
    fields = dict(arity="field", category="statistic",
                  feasible=lambda s: (Stage.F,),
                  closure=lambda s, st, a: "cover" if s in ("hszx", "hszx_nd")
                  else "hull")
    fields.update(kw)
    return oplib.OpSpec(name, **fields)


def test_register_op_rejects_malformed_specs():
    rule = lambda ctx, axis: None  # noqa: E731
    cases = [(_spec("bad_cells", lower={}), r"\(stage F, lorenzo\)"),
             (_spec("bad_closure", lower={(Stage.F, "any"): rule},
                    closure=None), "closure"),
             (_spec("bad_arity", arity="temporal"), "arity"),
             (_spec("bad_twice", lower={(Stage.F, "any"): rule,
                                        (Stage.F, "lorenzo"): rule}),
              "shadows"),
             (_spec("mean", lower={(Stage.F, "any"): rule}), "collision"),
             (oplib.OpSpec("bad_vector", "vector", "multivariate",
                           lambda s: (Stage.F,)), "lower_vector")]
    for spec, match in cases:
        with pytest.raises(ValueError, match=match):
            oplib.register_op(spec)
        if spec.name != "mean":
            assert spec.name not in oplib.OPS
    unreachable = _spec("dead_rule", lower={(Stage.F, "any"): rule,
                                            (Stage.M, "lorenzo"): rule})
    assert [inv for inv, _ in oplib.spec_violations(unreachable)] == [
        "unreachable-lowering-rule"]


def test_registered_op_runs_on_regions(field_2d):
    """A user op registered with a closure plans and runs like a built-in,
    on the full field and on a region window."""
    def fmax(ctx, axis):
        return ctx.f_spatial.max()

    spec = _spec("fmax_region", lower={(Stage.F, "any"): fmax})
    try:
        oplib.register_op(spec)
        assert oplib.canonical_ops(["fmax_region", "mean"]) == (
            "mean", "fmax_region")
        for scheme in ALL:
            c = _c(scheme, field_2d)
            f = by_name(scheme).decompress(c, Stage.F)
            got = H.compute(c, ["mean", "fmax_region"], Stage.F, region=REGION)
            assert torch.equal(got["fmax_region"], f[WIN].max())
            assert torch.equal(H.compute(c, "fmax_region", Stage.F)[
                "fmax_region"], f.max())
    finally:
        oplib.OPS.pop("fmax_region", None)
        oplib._ALL_OPS.pop("fmax_region", None)
        oplib._ORDER.pop("fmax_region", None)


# ===========================================================================
# the region path itself: gather-unpack, decode_region, extract
# ===========================================================================

@pytest.mark.parametrize("bits", [0, 1, 2, 5, 7, 13, 16, 17, 25, 31, 32])
def test_unpack_gather_matches_reference(bits):
    """The gather-unpack on a random payload, through a plan's gather
    arrays, against the reference's ``unpack_gather``: bitwise at every
    width, the ``bits == 0`` (no words) and ``bits == 32`` paths included."""
    (je,), (te,) = _pairs("hszx_nd", "encoded", "scalar")
    tp = R.plan_region(te, REGIONS_2D["far-edge"], "cover")
    gi = tp.payload_gather(bits)
    n_words = encode.words_for(int(np.prod(te.padded_shape)), bits)
    rng = np.random.default_rng(bits)
    words = rng.integers(0, 2 ** 32, n_words, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jax_encode.unpack_gather(
        jnp.asarray(words), word_idx=gi.word_idx, pos0=gi.pos0, pos1=gi.pos1,
        shift=gi.shift, bits=bits))
    dg = tp.device_gather(bits, torch.device("cpu"))
    got = encode.unpack_gather(torch.as_tensor(words.view(np.int32)),
                               word_idx=dg.word_idx, pos0=dg.pos0,
                               pos1=dg.pos1, shift=dg.shift, bits=bits)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32), want)
    # the pre-gathered word set (word_idx=None) gives the same values
    pre = torch.as_tensor(words[gi.word_idx].view(np.int32))
    again = encode.unpack_gather(pre, pos0=gi.pos0, pos1=gi.pos1,
                                 shift=gi.shift, bits=bits)
    assert torch.equal(again, got)


@pytest.mark.parametrize("scheme", ALL)
@pytest.mark.parametrize("region", list(REGIONS_2D), ids=str)
def test_extract_matches_reference(scheme, region):
    """The gathered sub-field of both containers, leaf for leaf."""
    reg = REGIONS_2D[region]
    for container in CONTAINERS:
        (jf,), (tf,) = _pairs(scheme, container, "scalar")
        for closure in ("cover", "hull", ("band", 1)):
            js = JR.extract(jf, JR.plan_region(jf, reg, closure))
            ts = R.extract(tf, R.plan_region(tf, reg, closure))
            what = f"{scheme} {container} {region} {closure}"
            for leaf in ("residuals", "metadata", "bitwidths", "eps",
                         "valid_counts"):
                _bitwise(getattr(js, leaf), getattr(ts, leaf), f"{what} {leaf}")
                assert getattr(ts, leaf).is_contiguous(), (what, leaf)
            assert (js.shape, js.padded_shape, js.block) == (
                ts.shape, ts.padded_shape, ts.block), what


# ===========================================================================
# region results: every feasible (op, stage) cell against the reference
# ===========================================================================

FIELD_SETS = {"stats+stencils": ("mean", "std", "gradient", "laplacian"),
              "stats": ("mean", "std")}
REGION_CELLS = [(s, c, r) for s in ALL for c in CONTAINERS for r in REGIONS_2D]


@pytest.mark.parametrize("scheme,container,region", REGION_CELLS,
                         ids=[f"{s}-{c}-{r}" for s, c, r in REGION_CELLS])
def test_region_cells_match_reference(scheme, container, region):
    """One op set per stage (one reference prelude serves mean, std,
    gradient and laplacian) plus each axis' derivative on its own (its
    stage-② closure is a band, not the set's hull), and the stage-① mean
    of an aligned-or-not window, raising alike where unaligned."""
    (jf,), (tf,) = _pairs(scheme, container, "scalar")
    reg = REGIONS_2D[region]
    nd = scheme.endswith("_nd")
    exact = _exact_stats(tf, reg)
    for stage in (Stage.P, Stage.Q, Stage.F):
        js = JStage(int(stage))
        names = FIELD_SETS["stats+stencils" if nd or stage != Stage.P
                           else "stats"]
        what = f"{scheme} {container} {region} {stage.name}"
        _compare(JH.compute(jf, names, js, region=reg),
                 H.compute(tf, names, stage, region=reg), tf, stage, what,
                 exact)
        if nd or stage != Stage.P:
            for axis in (0, 1):
                _bitwise(JH.derivative(jf, js, axis, region=reg),
                         H.derivative(tf, stage, axis, region=reg),
                         f"{what} derivative{axis}")
        else:
            with pytest.raises(JUnsupported):
                JH.derivative(jf, js, 0, region=reg)
            with pytest.raises(UnsupportedStageError):
                H.derivative(tf, stage, 0, region=reg)
    if scheme.startswith("hszx"):
        aligned = R.region_aligned(tf, reg)
        if aligned:
            _close_stat(JH.mean(jf, JStage.M, region=reg),
                        H.mean(tf, Stage.M, region=reg), tf, Stage.M, "mean",
                        f"{scheme} {region} mean M", exact["mean"])
        else:
            with pytest.raises(JUnsupported):
                JH.mean(jf, JStage.M, region=reg)
            with pytest.raises(UnsupportedStageError, match="block-aligned"):
                H.mean(tf, Stage.M, region=reg)
    else:
        with pytest.raises(UnsupportedStageError):
            H.mean(tf, Stage.M, region=reg)


VECTOR_CELLS = [(s, c, r) for s in ND for c in CONTAINERS for r in REGIONS_VEC]


@pytest.mark.parametrize("scheme,container,region", VECTOR_CELLS,
                         ids=[f"{s}-{c}-{r}" for s, c, r in VECTOR_CELLS])
def test_region_vector_cells_match_reference(scheme, container, region):
    jv, tv = _pairs(scheme, container, "vector")
    reg = REGIONS_VEC[region]
    for stage in (Stage.P, Stage.Q, Stage.F):
        _compare(JH.compute(jv, ("divergence", "curl"), JStage(int(stage)),
                            region=reg),
                 H.compute(tv, ("divergence", "curl"), stage, region=reg),
                 tv[0], stage, f"{scheme} {container} {region} {stage.name}")


@pytest.mark.parametrize("scheme", ["hszp", "hszx"])
def test_region_1d_vector_cells_match_reference(scheme):
    jv, tv = _pairs(scheme, "encoded", "vector")
    reg = REGIONS_VEC["interior"]
    for stage in (Stage.Q, Stage.F):
        _compare(JH.compute(jv, ("divergence", "curl"), JStage(int(stage)),
                            region=reg),
                 H.compute(tv, ("divergence", "curl"), stage, region=reg),
                 tv[0], stage, f"{scheme} {stage.name}")
    with pytest.raises(UnsupportedStageError):
        H.divergence(tv, Stage.P, region=reg)


@pytest.mark.parametrize("scheme", ND)
@pytest.mark.parametrize("container", CONTAINERS)
def test_region_3d_matches_reference(scheme, container):
    (jc,), (tc,) = _pairs(scheme, container, "scalar3d")
    jv, tv = _pairs(scheme, container, "vector3d")
    names = ("mean", "std", "gradient", "laplacian")
    for region, reg in REGIONS_3D.items():
        exact = _exact_stats(tc, reg)
        for stage in (Stage.P, Stage.Q, Stage.F):
            js = JStage(int(stage))
            what = f"3-D {scheme} {container} {region} {stage.name}"
            _compare(JH.compute(jc, names, js, region=reg),
                     H.compute(tc, names, stage, region=reg), tc, stage, what,
                     exact)
            _bitwise(JH.derivative(jc, js, 1, region=reg),
                     H.derivative(tc, stage, 1, region=reg), f"{what} d1")
        _compare(JH.compute(jv, ("divergence", "curl"), JStage.Q, region=reg),
                 H.compute(tv, ("divergence", "curl"), Stage.Q, region=reg),
                 tv[0], Stage.Q, f"3-D {scheme} {container} {region} vector")


def test_region_errors_raise_like_reference():
    """The same exception types for the same conditions: a region of the
    wrong rank or out of bounds, ``payload_words`` without a region or on a
    ``Compressed`` field, word-set counts that differ from the components,
    a vector op with a field target's word set; and a word set on another
    device than its field (the port only: nothing moves on its own)."""
    (jc,), (tc,) = _pairs("hszp_nd", "compressed", "scalar")
    (je,), (te,) = _pairs("hszp_nd", "encoded", "scalar")
    jv, tv = _pairs("hszp_nd", "encoded", "vector")
    reg = REGIONS_2D["interior"]
    jwords = je.payload[:4]
    twords = te.payload[:4]
    cases = [
        (lambda: JH.mean(jc, JStage.P, region=((0, 10),)),
         lambda: H.mean(tc, Stage.P, region=((0, 10),)), ValueError),
        (lambda: JH.mean(jc, JStage.P, region=((0, 300), (0, 5))),
         lambda: H.mean(tc, Stage.P, region=((0, 300), (0, 5))), ValueError),
        (lambda: JH.compute(je, "mean", JStage.P, payload_words=jwords),
         lambda: H.compute(te, "mean", Stage.P, payload_words=twords),
         ValueError),
        (lambda: JH.compute(jc, "mean", JStage.P, region=reg,
                            payload_words=jwords),
         lambda: H.compute(tc, "mean", Stage.P, region=reg,
                           payload_words=twords), ValueError),
        (lambda: JH.compute(jv, "curl", JStage.Q, region=reg,
                            payload_words=[jwords]),
         lambda: H.compute(tv, "curl", Stage.Q, region=reg,
                           payload_words=[twords]), ValueError),
        (lambda: JH.compute(jv, "curl", JStage.Q, region=reg, seed=[None]),
         lambda: H.compute(tv, "curl", Stage.Q, region=reg, seed=[None]),
         ValueError),
        (lambda: JH.compute(jv, ["mean", "curl"], JStage.Q, region=reg),
         lambda: H.compute(tv, ["mean", "curl"], Stage.Q, region=reg),
         ValueError),
    ]
    for ref_call, port_call, exc in cases:
        with pytest.raises(exc):
            ref_call()
        with pytest.raises(exc):
            port_call()
    elsewhere = torch.empty((4,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="lies on meta"):
        H.compute(te, "mean", Stage.P, region=reg, payload_words=elsewhere)


# ===========================================================================
# the reference's region tests, on the port
# ===========================================================================

REGION = REGIONS_2D["interior"]
WIN = tuple(slice(s, e) for s, e in REGION)


def _c(scheme, data, rel_eb=1e-3):
    return by_name(scheme).compress(data, rel_eb=rel_eb, device="cpu")


def _window_ref(scheme, c):
    return by_name(scheme).decompress(c, Stage.F).numpy()[WIN]


def test_region_decodes_only_covering_blocks():
    rng = np.random.default_rng(7)
    d = rng.normal(0, 1, (160, 160)).astype(np.float32)
    c = _c("hszx_nd", d)
    e = by_name("hszx_nd").encode(c)
    plan = R.plan_region(e, ((32, 80), (48, 96)), "cover")
    assert plan.n_sub_blocks == 9
    gi = plan.payload_gather(e.bits)
    assert gi.n_words < 0.15 * e.payload.numel()
    sub = encode.decode_region(e, plan)
    assert torch.equal(sub.residuals, c.residuals[32:80, 48:96])


def test_region_word_count_scales_with_window():
    rng = np.random.default_rng(8)
    e = by_name("hszx_nd").encode(_c("hszx_nd", rng.normal(
        0, 1, (160, 160)).astype(np.float32)))
    small = R.plan_region(e, ((0, 16), (0, 16)), "cover").payload_gather(e.bits)
    large = R.plan_region(e, ((0, 96), (0, 96)), "cover").payload_gather(e.bits)
    assert small.n_words < large.n_words < e.payload.numel()


def test_lorenzo_closure_is_prefix_hull():
    rng = np.random.default_rng(9)
    c = _c("hszp_nd", rng.normal(0, 1, (160, 160)).astype(np.float32))
    hull = R.plan_region(c, ((128, 160), (128, 160)), "hull")
    assert hull.grid_ranges == ((0, 10), (0, 10))
    band0 = R.plan_region(c, ((128, 160), (128, 160)), ("band", 0))
    assert band0.grid_ranges == ((8, 10), (0, 10))
    assert band0.gathered_elems < hull.gathered_elems


@pytest.mark.parametrize("scheme", ALL)
def test_region_statistics_match_cropped_decompression(scheme, field_2d):
    c = _c(scheme, field_2d)
    e = by_name(scheme).encode(c)
    win = _window_ref(scheme, c)
    for fld in (c, e):
        for stage in (Stage.P, Stage.Q, Stage.F):
            mu = float(H.mean(fld, stage, region=REGION))
            assert abs(mu - win.mean()) <= 2e-4, (stage, mu, win.mean())
            sd = float(H.std(fld, stage, region=REGION))
            assert abs(sd - win.std(ddof=1)) <= float(c.eps) + 1e-4, (stage, sd)


@pytest.mark.parametrize("scheme", ALL)
@pytest.mark.parametrize("op", ["derivative", "laplacian"])
def test_region_stencils_match_cropped_decompression(scheme, op, field_2d):
    c = _c(scheme, field_2d)
    e = by_name(scheme).encode(c)
    win = _window_ref(scheme, c)
    stages = [Stage.Q, Stage.F] + ([Stage.P] if scheme.endswith("_nd") else [])
    for fld in (c, e):
        for stage in stages:
            if op == "derivative":
                for axis in (0, 1):
                    got = H.derivative(fld, stage, axis, region=REGION).numpy()
                    hi = [slice(1, -1)] * 2
                    lo = [slice(1, -1)] * 2
                    hi[axis], lo[axis] = slice(2, None), slice(None, -2)
                    ref = (win[tuple(hi)] - win[tuple(lo)]) * 0.5
                    np.testing.assert_allclose(got, ref, rtol=1e-4,
                                               atol=float(c.eps) * 1e-2)
            else:
                got = H.laplacian(fld, stage, region=REGION).numpy()
                ref = (-4 * win[1:-1, 1:-1] + win[2:, 1:-1] + win[:-2, 1:-1]
                       + win[1:-1, 2:] + win[1:-1, :-2])
                np.testing.assert_allclose(got, ref, rtol=1e-4,
                                           atol=float(c.eps) * 1e-1)


@pytest.mark.parametrize("scheme", ALL)
@pytest.mark.parametrize("op", ["divergence", "curl"])
def test_region_multivariate_match_cropped_decompression(scheme, op,
                                                         vector_field_2d):
    u, v = vector_field_2d
    cu, cv = _c(scheme, u), _c(scheme, v)
    region = REGIONS_VEC["interior"]
    comp = by_name(scheme)
    du = comp.decompress(cu, Stage.F).numpy()[20:60, 40:90]
    dv = comp.decompress(cv, Stage.F).numpy()[20:60, 40:90]
    if op == "divergence":
        ref = ((du[2:, 1:-1] - du[:-2, 1:-1]) * 0.5
               + (dv[1:-1, 2:] - dv[1:-1, :-2]) * 0.5)
    else:
        ref = ((dv[2:, 1:-1] - dv[:-2, 1:-1]) * 0.5
               - (du[1:-1, 2:] - du[1:-1, :-2]) * 0.5)
    fn = H.divergence if op == "divergence" else H.curl
    stages = [Stage.Q, Stage.F] + ([Stage.P] if scheme.endswith("_nd") else [])
    for stage in stages:
        got = fn([cu, cv], stage, region=region).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-4,
                                   atol=float(cu.eps) * 1e-1)


@pytest.mark.parametrize("scheme", ND)
def test_region_3d_matches_cropped_decompression(scheme, field_3d):
    c = _c(scheme, field_3d)
    region = REGIONS_3D["interior"]
    win = by_name(scheme).decompress(c, Stage.F).numpy()[4:20, 10:36, 5:29]
    for stage in (Stage.P, Stage.Q):
        assert abs(float(H.mean(c, stage, region=region)) - win.mean()) <= 2e-4
        got = H.derivative(c, stage, 1, region=region).numpy()
        ref = (win[1:-1, 2:, 1:-1] - win[1:-1, :-2, 1:-1]) * 0.5
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=float(c.eps) * 1e-2)


@pytest.mark.parametrize("scheme", ND)
def test_region_full_window_equals_full_field(scheme, field_2d):
    c = _c(scheme, field_2d)
    full = tuple((0, s) for s in c.shape)
    for stage in (Stage.P, Stage.Q):
        np.testing.assert_allclose(float(H.mean(c, stage, region=full)),
                                   float(H.mean(c, stage)), rtol=1e-6, atol=1e-6)
        assert torch.equal(H.derivative(c, stage, 0, region=full),
                           H.derivative(c, stage, 0))


def test_region_slice_specs(field_2d):
    c = _c("hszx_nd", field_2d)
    a = H.mean(c, Stage.P, region=(slice(30, 75), slice(10, 52)))
    assert torch.equal(a, H.mean(c, Stage.P, region=REGION))
    assert torch.equal(H.mean(c, Stage.P, region=(None, (10, 52))),
                       H.mean(c, Stage.P, region=((0, 181), (10, 52))))
    with pytest.raises(ValueError):
        H.mean(c, Stage.P, region=((0, 300), (0, 10)))
    with pytest.raises(ValueError):
        H.mean(c, Stage.P, region=((0, 10),))


def test_region_stage1_mean_requires_alignment():
    rng = np.random.default_rng(3)
    d = rng.normal(3.0, 1.0, (160, 160)).astype(np.float32)
    c = _c("hszx_nd", d)
    aligned = ((32, 80), (48, 96))
    mu = float(H.mean(c, Stage.M, region=aligned))
    assert abs(mu - d[32:80, 48:96].mean()) <= 2 * float(c.eps)
    with pytest.raises(UnsupportedStageError):
        H.mean(c, Stage.M, region=((33, 80), (48, 96)))


def test_region_stage1_mean_never_decodes(field_2d, monkeypatch):
    """A region's stage-① mean reads the window's block metadata only."""
    c = _c("hszx_nd", field_2d)
    e = by_name("hszx_nd").encode(c)
    aligned = ((32, 80), (48, 96))
    want = H.mean(e, Stage.M, region=aligned)

    def refuse(*args, **kwargs):
        raise AssertionError("stage-1 region mean decoded the payload")

    monkeypatch.setattr(encode, "decode_region", refuse)
    assert torch.equal(want, H.mean(e, Stage.M, region=aligned))
    with pytest.raises(AssertionError, match="decoded"):
        H.mean(e, Stage.P, region=aligned)


def test_region_closure_fractions():
    rng = np.random.default_rng(4)
    c = _c("hszp_nd", rng.normal(0, 1, (160, 160)).astype(np.float32))
    region = ((128, 160), (128, 160))
    assert R.closure_fraction(c, "derivative", Stage.P, region,
                              axis=0) == pytest.approx(0.2)
    assert R.closure_fraction(c, "derivative", Stage.Q, region,
                              axis=0) == pytest.approx(1.0)
    x = _c("hszx_nd", rng.normal(0, 1, (160, 160)).astype(np.float32))
    for stage in (Stage.P, Stage.Q, Stage.F):
        assert R.closure_fraction(x, "mean", stage, region) == pytest.approx(
            (32 * 32) / (160 * 160))
    assert R.closure_fraction(x, "mean", Stage.M, region) == pytest.approx(4 / 100)


# -- the region halves of test_fused.py / test_fused_kernels.py --------------

FUSED_SETS = [("mean", "std"), ("mean", "std", "laplacian"),
              ("std", "derivative"), ("mean", "gradient")]


def _single(op, c, stage, axis=0, region=None):
    return {"mean": lambda: H.mean(c, stage, region=region),
            "std": lambda: H.std(c, stage, region=region),
            "derivative": lambda: H.derivative(c, stage, axis, region=region),
            "gradient": lambda: H.gradient(c, stage, region=region),
            "laplacian": lambda: H.laplacian(c, stage, region=region)}[op]()


@pytest.mark.parametrize("scheme", ALL)
@pytest.mark.parametrize("ops_", FUSED_SETS, ids="+".join)
def test_fused_region_bit_exact_vs_single_op(scheme, ops_, field_2d):
    c = _c(scheme, field_2d)
    e = by_name(scheme).encode(c)
    for fld in (c, e):
        for stage in _stages(scheme, ops_):
            if stage == Stage.P and not scheme.endswith("_nd") and any(
                    o not in ("mean", "std") for o in ops_):
                continue
            out = H.compute(fld, ops_, stage, axis=1, region=REGION)
            for op in ops_:
                _bitwise(_single(op, fld, stage, axis=1, region=REGION),
                         out[op], f"{scheme} {op} {stage.name}")


@pytest.mark.parametrize("scheme", ND)
def test_fused_region_multivariate_bit_exact(scheme, vector_field_2d):
    u, v = vector_field_2d
    cu, cv = _c(scheme, u), _c(scheme, v)
    for stage in (Stage.P, Stage.Q, Stage.F):
        for r in (None, REGIONS_VEC["interior"]):
            out = H.compute([cu, cv], ["curl", "divergence"], stage, region=r)
            _bitwise(H.divergence([cu, cv], stage, region=r),
                     out["divergence"], "divergence")
            _bitwise(H.curl([cu, cv], stage, region=r), out["curl"], "curl")


AB_OPS = {"deriv0": lambda f, s, r: H.derivative(f, s, 0, region=r),
          "deriv1": lambda f, s, r: H.derivative(f, s, 1, region=r),
          "gradient": lambda f, s, r: H.gradient(f, s, region=r),
          "laplacian": lambda f, s, r: H.laplacian(f, s, region=r)}
AB_CELLS = [(s, c, r) for s in ND for c in CONTAINERS
            for r in ("interior", "far-edge", "origin")]


@pytest.mark.parametrize("scheme,container,region", AB_CELLS,
                         ids=[f"{s}-{c}-{r}" for s, c, r in AB_CELLS])
def test_fused_region_rules_equal_torch_rules(scheme, container, region):
    """Every covered stencil cell on a region: the fused rule (kernel
    wrappers on the gathered sub-plane) equals the torch rule bitwise."""
    (_, (tf,)) = _pairs(scheme, container, "scalar")
    reg = REGIONS_2D[region]
    for stage in (Stage.P, Stage.Q, Stage.F):
        for name, call in AB_OPS.items():
            got = call(tf, stage, reg)
            with ops.override_mode("off"):
                want = call(tf, stage, reg)
            _bitwise(want, got, f"{scheme} {container} {region} {name} "
                     f"{stage.name}")


def test_payload_path_predicate_on_regions(field_2d):
    """Region and seeded contexts never take the payload kernels; they
    reach the residual-plane kernels through ``ctx.sub``."""
    from repro_torch.store import materialize
    e = by_name("hszp_nd").encode(_c("hszp_nd", field_2d))
    closure = oplib.set_closure(["gradient"], e.scheme, Stage.Q)
    assert fused_mod._payload2(oplib.StageContext(e, Stage.Q, None, closure))
    region_ctx = oplib.StageContext(e, Stage.Q, REGION, closure)
    assert not fused_mod._payload2(region_ctx)
    assert fused_mod._covers_2d(region_ctx)
    seeded = oplib.StageContext(e, Stage.P, None, "cover",
                                seed=materialize(e, Stage.P))
    assert not fused_mod._payload2(seeded)
    w0, w1 = fused_mod._window2(region_ctx)
    plan = region_ctx.plan
    assert (w0.start, w0.stop) == (plan.window[0].start + 1,
                                   plan.window[0].stop - 1)
    assert (w1.start, w1.stop) == (plan.window[1].start + 1,
                                   plan.window[1].stop - 1)


def test_cpu_region_path_launches_no_kernel(field_2d):
    ops.reset_launches()
    for scheme in ND:
        e = by_name(scheme).encode(_c(scheme, field_2d))
        for stage in (Stage.P, Stage.Q):
            H.gradient(e, stage, region=REGION)
            H.laplacian(e, stage, region=REGION)
            H.mean(e, stage, region=REGION)
    assert set(ops.LAUNCHES.values()) == {0}


# -- test_oracle_fields.py with region= --------------------------------------

N0, N1 = 48, 64
ORACLE_REGIONS = [((5, 30), (7, 50)), ((20, 48), (0, 64))]


def _oracle(scheme, data):
    return by_name(scheme).compress(np.asarray(data, np.float32), abs_eb=0.25,
                                    device="cpu")


def _grid():
    i = np.arange(N0, dtype=np.float32)[:, None]
    j = np.arange(N1, dtype=np.float32)[None, :]
    return i + np.zeros((N0, N1), np.float32), j + np.zeros((N0, N1), np.float32)


def _oracle_stages(scheme):
    return [Stage.Q, Stage.F] + ([Stage.P] if scheme.endswith("_nd") else [])


def _inner(x, region):
    (s0, e0), (s1, e1) = region
    return x[s0 + 1:e0 - 1, s1 + 1:e1 - 1]


@pytest.mark.parametrize("scheme", ALL)
def test_oracle_region_derivative_and_laplacian_exact(scheme):
    """Quadratics on a region: d(i²)/di = 2i and ∇²(i² + j²) = 4 exactly
    on the window interior."""
    i, j = _grid()
    for region in ORACLE_REGIONS:
        for axis, coord in ((0, i), (1, j)):
            c = _oracle(scheme, coord * coord)
            for stage in _oracle_stages(scheme):
                got = H.derivative(c, stage, axis, region=region).numpy()
                np.testing.assert_allclose(got, 2.0 * _inner(coord, region),
                                           rtol=1e-5, atol=1e-3)
        c = _oracle(scheme, i * i + j * j)
        for stage in _oracle_stages(scheme):
            got = H.laplacian(c, stage, region=region).numpy()
            np.testing.assert_allclose(got, 4.0, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("scheme", ALL)
def test_oracle_region_curl_and_divergence_exact(scheme):
    """Rigid rotation (u, v) = (-j, i): curl is +2 on any window; the radial
    field (i, j) has divergence 2."""
    i, j = _grid()
    for region in ORACLE_REGIONS:
        rot = [_oracle(scheme, -j), _oracle(scheme, i)]
        rad = [_oracle(scheme, i), _oracle(scheme, j)]
        for stage in _oracle_stages(scheme):
            np.testing.assert_allclose(H.curl(rot, stage, region=region).numpy(),
                                       2.0, atol=1e-3)
            np.testing.assert_allclose(
                H.divergence(rad, stage, region=region).numpy(), 2.0, atol=1e-3)


@pytest.mark.parametrize("scheme", ALL)
def test_oracle_region_stats_linear_field(scheme):
    """f = i + j: the window mean is the mean of its coordinates, exactly
    representable, at every stage that has it."""
    i, j = _grid()
    c = _oracle(scheme, i + j)
    for (s0, e0), (s1, e1) in ORACLE_REGIONS:
        want = (s0 + e0 - 1) / 2 + (s1 + e1 - 1) / 2
        for stage in (Stage.P, Stage.Q, Stage.F):
            got = float(H.mean(c, stage, region=((s0, e0), (s1, e1))))
            assert abs(got - want) <= 1e-3, (scheme, stage, got, want)


# ===========================================================================
# device copies of plan arrays
# ===========================================================================

def test_device_cache_is_bounded_and_reused(field_2d, monkeypatch):
    """Repeated queries copy nothing new; past the byte bound the least
    recently used plan arrays leave, and the values stay the same."""
    e = by_name("hszp_nd").encode(_c("hszp_nd", field_2d))
    def held() -> int:
        return sum(n for _, n in R._DEVICE_CACHE.values())

    R._DEVICE_CACHE.clear()
    want = H.gradient(e, Stage.Q, region=REGION)
    n_entries, n_bytes = len(R._DEVICE_CACHE), held()
    assert n_entries > 0 and n_bytes > 0
    _bitwise(want, H.gradient(e, Stage.Q, region=REGION), "repeat")
    assert (len(R._DEVICE_CACHE), held()) == (n_entries, n_bytes)
    monkeypatch.setattr(R, "DEVICE_CACHE_BYTES", n_bytes // 2)
    for k in range(4):
        H.gradient(e, Stage.Q, region=((k, 60 + k), (2, 50)))
    assert held() <= max(n_bytes // 2,
                         max(n for _, n in R._DEVICE_CACHE.values()))
    _bitwise(want, H.gradient(e, Stage.Q, region=REGION), "after eviction")


@pytest.mark.parametrize("container", CONTAINERS)
def test_full_field_mean_weights_are_built_once(field_2d, container, monkeypatch):
    """Two full-field mean@② queries of one layout build the separable
    Lorenzo weights once and read the device copy after that (no copy from
    the host on a warm query); the values stay bitwise the same."""
    from repro_torch.core import oplib
    c = _c("hszp_nd", field_2d)
    f = by_name("hszp_nd").encode(c) if container == "encoded" else c
    g = _c("hszp_nd", field_2d[::-1].copy())      # another field, one layout
    R._DEVICE_CACHE.clear()
    built = []
    real = oplib.np.clip
    monkeypatch.setattr(oplib.np, "clip",
                        lambda *a, **k: built.append(1) or real(*a, **k))
    first = H.mean(f, Stage.P)
    assert len(built) == 2                        # one weight vector per axis
    keys = [k for k in R._DEVICE_CACHE if k[0] == "full-field weights"]
    assert keys == [("full-field weights", tuple(c.padded_shape),
                     tuple(c.shape), "cpu")]
    _bitwise(first, H.mean(f, Stage.P), "repeat")
    H.mean(g, Stage.P)
    assert len(built) == 2
    w = R._DEVICE_CACHE[keys[0]][0]
    assert oplib.full_field_weights(tuple(c.padded_shape), tuple(c.shape),
                                    "cpu") is w
    for wa, npad, n in zip(w, c.padded_shape, c.shape):
        np.testing.assert_array_equal(
            wa.numpy(), np.maximum(n - np.arange(npad), 0).astype(np.float32))


# ===========================================================================
# the card (skips without one)
# ===========================================================================

@pytest.mark.gpu
@pytest.mark.parametrize("scheme", ND)
def test_region_queries_on_card_equal_cpu(scheme, field_2d):
    """Region stencil cells on the card — the residual-plane kernels on the
    gathered sub-planes — equal the CPU port bitwise, with no payload
    kernel and no full-field unpack launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    comp = by_name(scheme)
    hc = comp.compress(field_2d, abs_eb=1e-3, device="cpu")
    dc = comp.compress(field_2d, abs_eb=1e-3, device="cuda")
    pairs = ((hc, dc), (comp.encode(hc), comp.encode(dc)))
    ops.reset_launches()
    for host, card in pairs:
        for region in REGIONS_2D.values():
            for stage in (Stage.P, Stage.Q, Stage.F):
                for call in AB_OPS.values():
                    want = call(host, stage, region)
                    got = call(card, stage, region)
                    _bitwise(want, tuple(g.cpu() for g in _tup(got)),
                             f"{scheme} {stage.name} {region}")
    site = "lorenzo2d.stencil" if scheme == "hszp_nd" else "blockmean2d"
    assert ops.LAUNCHES[site] > 0
    for never in ("lorenzo_enc2d.edges", "lorenzo_enc2d.stencil",
                  "blockmean_enc2d", "unpack.residuals"):
        assert ops.LAUNCHES[never] == 0, never
