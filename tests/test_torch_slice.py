"""The port's first slice as a whole: compress -> encode -> homomorphic ops.

The same numpy fields go through the JAX reference (``repro``, CPU, its
Pallas kernels in interpret mode as its own tests run them) and through the
port (``repro_torch``, ``device="cpu"``, where every kernel wrapper takes its
plain version).  Tolerances, per result kind:

* derivative / gradient / laplacian: **bitwise** — an exact integer plane
  times eps (or 2·eps), or the block-mean laplacian's fixed f32 order;
* divergence / curl: ``rtol=1e-6`` with ``atol=1e-6·max|ref|`` — a sum of
  two bitwise-equal derivative planes, which XLA's CPU fusion may contract
  into a multiply-add where torch rounds the product first;
* mean / std: ``rtol=1e-5`` — the flat f32 reductions run in another order.
  A mean near 0 makes a relative gap meaningless, so the gap may instead
  reach half of the paper's own bias bound (``error_analysis.
  mean_bias_bound`` / ``std_bias_bound``: 64·ε_f32·√n·eps at stages ②③④);
  where that bound is eps (stage-① mean, stage-② block-mean std) the gap
  must stay below 1e-3 of it.  One cell is looser, the 1-D Lorenzo stage-②
  mean (see ``test_1d_schemes_compute``).
"""
import ast
import functools
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Stage as JStage
from repro.core import UnsupportedStageError as JUnsupported
from repro.core import by_name as jax_by_name
from repro.core import homomorphic as JH
from repro_torch import convert
from repro_torch.core import Stage, UnsupportedStageError, by_name
from repro_torch.core import error_analysis
from repro_torch.core import homomorphic as H
from repro_torch.kernels import ops

ROOT = pathlib.Path(__file__).resolve().parents[1]
ND = ["hszp_nd", "hszx_nd"]
BLOCK = (8, 8)
OPS = ["mean", "std", "deriv0", "deriv1", "gradient", "laplacian",
       "divergence", "curl"]


def _stages(scheme: str, op: str) -> tuple[Stage, ...]:
    if op == "mean":
        return ((Stage.M,) if scheme == "hszx_nd" else ()) + (
            Stage.P, Stage.Q, Stage.F)
    return (Stage.P, Stage.Q, Stage.F)


CELLS = [(s, cont, op, st) for s in ND for cont in ("compressed", "encoded")
         for op in OPS for st in _stages(s, op)]
CELL_IDS = [f"{s}-{cont}-{op}-{st.name}" for s, cont, op, st in CELLS]


def _call(mod, op: str, fields, stage):
    """One homomorphic call in either package (same API)."""
    f = fields[0]
    if op == "mean":
        return mod.mean(f, stage)
    if op == "std":
        return mod.std(f, stage)
    if op.startswith("deriv"):
        return mod.derivative(f, stage, int(op[-1]))
    if op == "gradient":
        return mod.gradient(f, stage)
    if op == "laplacian":
        return mod.laplacian(f, stage)
    return getattr(mod, op)(list(fields), stage)


@functools.lru_cache(maxsize=None)
def _pairs(scheme: str, key: str, arrays_id: int):
    """(jax containers, torch containers) for the cached numpy inputs."""
    arrays = _INPUTS[arrays_id]
    block = BLOCK if scheme.endswith("_nd") and arrays[0].ndim == 2 else None
    jcomp, tcomp = jax_by_name(scheme, block), by_name(scheme, block)
    jc = [jcomp.compress(jnp.asarray(a), abs_eb=1e-3) for a in arrays]
    tc = [tcomp.compress(a, abs_eb=1e-3, device="cpu") for a in arrays]
    if key == "encoded":
        return [jcomp.encode(c) for c in jc], [tcomp.encode(c) for c in tc]
    return jc, tc


_INPUTS: dict[int, tuple[np.ndarray, ...]] = {}


def _register(*arrays: np.ndarray) -> int:
    key = len(_INPUTS)
    _INPUTS[key] = tuple(np.ascontiguousarray(a, np.float32) for a in arrays)
    return key


@pytest.fixture(scope="module")
def inputs(field_2d, vector_field_2d, field_3d):
    """Registered numpy inputs: the scalar 2-D field, the (u, v) field,
    the 3-D field and a 3-component 3-D vector field."""
    f3 = field_3d
    return {
        "scalar": _register(field_2d),
        "vector": _register(*vector_field_2d),
        "scalar3d": _register(f3),
        "vector3d": _register(f3, np.roll(f3, 3, axis=0) * 0.5,
                              np.flip(f3, axis=2) + 1.0),
    }


def _fields(inputs, scheme, container, op):
    key = inputs["vector" if op in ("divergence", "curl") else "scalar"]
    return _pairs(scheme, container, key)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _bitwise(want, got, what):
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(want) == len(got), what
    for w, g in zip(want, got):
        w, g = _np(w), _np(g)
        assert (w.shape, w.dtype) == (g.shape, g.dtype), what
        assert w.tobytes() == g.tobytes(), what


def _close_vector(want, got, what):
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for w, g in zip(want, got):
        w, g = _np(w), _np(g)
        assert w.shape == g.shape, what
        np.testing.assert_allclose(g, w, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(w).max()),
                                   err_msg=what)


def _close_stat(want, got, field, stage, op, what, tol=None):
    w, g = float(_np(want)), float(_np(got))
    eps = float(field.eps.item())
    bound = (error_analysis.mean_bias_bound if op == "mean"
             else error_analysis.std_bias_bound)(field, stage)
    if tol is None:
        tol = max(1e-5 * abs(w), (1e-3 if bound >= eps else 0.5) * bound)
    assert abs(g - w) <= tol, (what, abs(g - w), tol)


# ===========================================================================
# every feasible (scheme, container, op, stage) cell of the n-D schemes
# ===========================================================================

@pytest.mark.parametrize("scheme,container,op,stage", CELLS, ids=CELL_IDS)
def test_cell_matches_reference(inputs, scheme, container, op, stage):
    jf, tf = _fields(inputs, scheme, container, op)
    want = _call(JH, op, jf, JStage(int(stage)))
    got = _call(H, op, tf, stage)
    what = f"{scheme} {container} {op} {stage.name}"
    if op in ("mean", "std"):
        _close_stat(want, got, tf[0], stage, op, what)
    elif op in ("divergence", "curl"):
        _close_vector(want, got, what)
    else:
        _bitwise(want, got, what)


@pytest.mark.parametrize("scheme", ND)
def test_infeasible_cells_raise_in_both(inputs, scheme):
    jf, tf = _fields(inputs, scheme, "encoded", "mean")
    cells = [("derivative", Stage.M), ("std", Stage.M)]
    if scheme == "hszp_nd":
        cells.append(("mean", Stage.M))
    for op, stage in cells:
        with pytest.raises(JUnsupported):
            _call(JH, "deriv0" if op == "derivative" else op, jf,
                  JStage(int(stage)))
        with pytest.raises(UnsupportedStageError):
            _call(H, "deriv0" if op == "derivative" else op, tf, stage)


# ===========================================================================
# fused rules against the plain torch rules (override_mode("off"))
# ===========================================================================

AB_OPS = ["deriv0", "deriv1", "gradient", "laplacian", "divergence", "curl"]
AB_CELLS = [(s, cont, op, st) for s in ND for cont in ("compressed", "encoded")
            for op in AB_OPS for st in (Stage.P, Stage.Q, Stage.F)]


@pytest.mark.parametrize(
    "scheme,container,op,stage", AB_CELLS,
    ids=[f"{s}-{c}-{o}-{st.name}" for s, c, o, st in AB_CELLS])
def test_fused_rules_equal_torch_rules(inputs, scheme, container, op, stage):
    _, tf = _fields(inputs, scheme, container, op)
    got = _call(H, op, tf, stage)
    with ops.override_mode("off"):
        want = _call(H, op, tf, stage)
    _bitwise(want, got, f"{scheme} {container} {op} {stage.name}")


def test_stage1_mean_never_decodes(inputs, monkeypatch):
    """Stage ① reads block metadata only: the payload is never unpacked."""
    from repro_torch.core import encode

    (_, (te,)) = _pairs("hszx_nd", "encoded", inputs["scalar"])
    want = H.mean(te, Stage.M)

    def refuse(e):
        raise AssertionError("stage-1 mean decoded the payload")

    monkeypatch.setattr(encode, "decode_device", refuse)
    _bitwise(want, H.mean(te, Stage.M), "mean@M")
    with pytest.raises(AssertionError, match="decoded"):
        H.mean(te, Stage.P)


def test_override_mode_rejects_unknown_modes():
    with pytest.raises(ValueError, match="mode"):
        with ops.override_mode("interpret"):
            pass
    assert ops.kernels_enabled()


# ===========================================================================
# 1-D schemes and 3-D fields through compute (plain torch rules only)
# ===========================================================================

FIELD_SETS = {
    "stats": (("mean", "std"), (Stage.P, Stage.Q, Stage.F)),
    "stencils": (("derivative", "gradient", "laplacian"),
                 (Stage.Q, Stage.F)),
}


@pytest.mark.parametrize("scheme", ["hszp", "hszx"])
@pytest.mark.parametrize("opset", list(FIELD_SETS))
def test_1d_schemes_compute(inputs, scheme, opset):
    names, stages = FIELD_SETS[opset]
    (jc,), (tc,) = _pairs(scheme, "encoded", inputs["scalar"])
    for stage in stages:
        want = JH.compute(jc, names, JStage(int(stage)), axis=1)
        got = H.compute(tc, names, stage, axis=1)
        _compare_sets(want, got, tc, stage)
    if opset == "stencils":
        with pytest.raises(UnsupportedStageError):
            H.compute(tc, names, Stage.P)


@pytest.mark.parametrize("scheme", ND)
@pytest.mark.parametrize("container", ["compressed", "encoded"])
def test_3d_fields_compute(inputs, scheme, container):
    (jc,), (tc,) = _pairs(scheme, container, inputs["scalar3d"])
    jv, tv = _pairs(scheme, container, inputs["vector3d"])
    names = ("mean", "std", "derivative", "gradient", "laplacian")
    for stage in (Stage.P, Stage.Q, Stage.F):
        js = JStage(int(stage))
        _compare_sets(JH.compute(jc, names, js, axis=2),
                      H.compute(tc, names, stage, axis=2), tc, stage)
        for op in ("divergence", "curl"):
            _close_vector(JH.compute(jv, op, js)[op],
                          H.compute(tv, op, stage)[op], f"3-D {op}")


def _compare_sets(want: dict, got: dict, tc, stage):
    assert list(want) == list(got)
    for name in want:
        what = f"{tc.scheme.value} {name} {stage.name}"
        if name in ("mean", "std"):
            tol = None
            if (name, stage, tc.scheme.value) == ("mean", Stage.P, "hszp"):
                # one f32 dot of all residuals with weights up to n: the
                # reference lands ~5e-3·eps from the exact stage-③ mean
                # here, about 5x its own bias bound
                tol = 1e-2 * float(tc.eps.item())
            _close_stat(want[name], got[name], tc, stage, name, what, tol)
        else:
            _bitwise(want[name], got[name], what)


# ===========================================================================
# carrying containers across (convert) and the CPU dispatch
# ===========================================================================

def _jax_arrays(c):
    """numpy leaves + layout metadata of a reference container."""
    kind = type(c).__name__
    names = (("payload",) if kind == "Encoded" else ("residuals",)) + (
        "metadata", "bitwidths", "eps", "valid_counts")
    arrays = {n: np.asarray(getattr(c, n)) for n in names}
    meta = {"scheme": c.scheme.value, "shape": c.shape,
            "padded_shape": c.padded_shape, "block": c.block,
            "orig_dtype": np.dtype(c.orig_dtype).name}
    if kind == "Encoded":
        meta["bits"] = c.bits
    return kind, arrays, meta


@pytest.mark.parametrize("scheme", ND)
def test_convert_from_reference_encoded(inputs, scheme):
    (je,), (te,) = _pairs(scheme, "encoded", inputs["scalar"])
    kind, arrays, meta = _jax_arrays(je)
    ce = convert.from_arrays(kind, arrays, meta, device="cpu")
    for leaf in ("payload", "metadata", "bitwidths", "eps", "valid_counts"):
        _bitwise(getattr(te, leaf), getattr(ce, leaf), leaf)
    assert (ce.bits, ce.shape, ce.padded_shape, ce.block, ce.orig_dtype) == (
        te.bits, te.shape, te.padded_shape, te.block, te.orig_dtype)
    names = ("mean", "std", "derivative", "gradient", "laplacian")
    for stage in (Stage.P, Stage.Q, Stage.F):
        a, b = H.compute(te, names, stage), H.compute(ce, names, stage)
        for name in names:
            _bitwise(a[name], b[name], name)
    kind2, arrays2, meta2 = convert.to_arrays(ce)
    assert kind2 == kind and meta2 == {k: (tuple(v) if isinstance(v, tuple)
                                           else v) for k, v in meta.items()}
    for name, a in arrays.items():
        _bitwise(a, arrays2[name], name)


def test_cpu_slice_launches_no_kernel(inputs):
    ops.reset_launches()
    for scheme in ND:
        for container in ("compressed", "encoded"):
            (_, tf) = _pairs(scheme, container, inputs["scalar"])
            for op in ("mean", "deriv0", "gradient", "laplacian"):
                _call(H, op, tf, Stage.Q)
                _call(H, op, tf, Stage.P)
    assert set(ops.LAUNCHES.values()) == {0}


# ===========================================================================
# the port stands alone: no jax, nothing of the reference package
# ===========================================================================

def test_port_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "import repro_torch, repro_torch.core.homomorphic, "
            "repro_torch.kernels.fused, repro_torch.convert, "
            "repro_torch.data.scientific, repro_torch.serve, "
            "repro_torch.shard, repro_torch.launch.mesh, "
            "repro_torch.train, repro_torch.launch.train, repro_torch.comm, "
            "repro_torch.examples.train_lm_compressed_dp, "
            "repro_torch.launch.dryrun, repro_torch.launch.roofline, "
            "repro_torch.launch.op_analysis, "
            "repro_torch.examples.hom_sync_bench; "
            "assert not [m for m in sys.modules if m.split('.')[0] == 'repro']")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_sources_import_no_jax_and_no_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)
