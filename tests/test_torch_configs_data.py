"""The port's configs, token pipeline, ``ScientificStore`` and science
examples against the JAX reference.

Tolerances, per result kind:

* configs, shapes, parameter counts and token batches: **exact** (field by
  field, ``param_dtype`` / ``compute_dtype`` mapped by name; arrays equal);
* ``HSZ2`` bytes: **bitwise**;
* store outputs one rounding away from an integer plane (gradient at ②③
  = int plane × eps, the stage-④ field = q × 2·eps): **bitwise**; the
  stage-④ gradient ``rtol=1e-6`` with ``atol=1e-6·max|ref|`` (a difference
  of two floats, which XLA may contract into a multiply-add);
* ``stats`` (mean, std): the slice rule of ``test_torch_slice.py`` — ``rtol
  1e-5``, or half of the paper's bias bound
  (``error_analysis.mean_bias_bound`` / ``std_bias_bound``; 1e-3 of it
  where the bound is eps);
* ``normalized_batches``: the stats' gap propagated, ``rtol=1e-5`` with
  ``atol=1e-5``.

A port store and a reference store see one field only through ``.hsz``
bytes under a shared ``root=``: ``synth_field`` seeds differ between the
packages (the reference's ``hash`` is salted per process).
"""
import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import Stage as JStage
from repro.core import by_name as jax_by_name
from repro.core import encode as jencode
from repro.core import homomorphic as JH
from repro.data import scientific as jsci
from repro.data import tokens as jtokens
from repro_torch import configs
from repro_torch.configs.base import cell_supported
from repro_torch.core import Stage, encode, error_analysis, hszx_nd
from repro_torch.core import homomorphic as H
from repro_torch.data import ScientificStore, TokenPipeline, TokenPipelineConfig
from repro_torch.data.scientific import dataset_dims, synth_field

ARCH_NAMES = list(configs.ARCHS)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_value(j, t) -> bool:
    if isinstance(t, torch.dtype):
        return jnp.dtype(j).name == str(t).removeprefix("torch.")
    return j == t and type(j) is type(t)


def _same_config(jc, tc):
    assert [f.name for f in dataclasses.fields(jc)] == \
        [f.name for f in dataclasses.fields(tc)]
    for f in dataclasses.fields(jc):
        j, t = getattr(jc, f.name), getattr(tc, f.name)
        assert _same_value(j, t), (jc.name, f.name, j, t)


# ===========================================================================
# configs
# ===========================================================================

@pytest.mark.parametrize("name", ARCH_NAMES, ids=ARCH_NAMES)
def test_config_matches_reference(name):
    jc, tc = jconfigs.ARCHS[name], configs.ARCHS[name]
    _same_config(jc, tc)
    _same_config(jconfigs.reduced(jc), configs.reduced(tc))
    assert tc.param_count == jc.param_count
    assert tc.active_param_count == jc.active_param_count
    assert type(tc.param_count) is int


def test_arch_registry_and_shapes():
    assert list(configs.ARCHS) == list(jconfigs.ARCHS)
    assert configs.SHAPES.keys() == jconfigs.SHAPES.keys()
    for k, s in configs.SHAPES.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(jconfigs.SHAPES[k])
    assert configs.ARCHS["smollm-360m"].compute_dtype == torch.bfloat16
    assert configs.ARCHS["smollm-360m"].param_dtype == torch.float32


def test_cell_support_matrix():
    """long_500k runs only for sub-quadratic families, as the reference's."""
    for a, s in itertools.product(configs.ARCHS, configs.SHAPES):
        assert cell_supported(configs.ARCHS[a], configs.SHAPES[s]) == \
            jconfigs.cell_supported(jconfigs.ARCHS[a], jconfigs.SHAPES[s])
    runnable = {a for a in configs.ARCHS
                if cell_supported(configs.ARCHS[a],
                                  configs.SHAPES["long_500k"])[0]}
    assert runnable == {"falcon-mamba-7b", "recurrentgemma-9b"}


def test_param_counts_full_configs():
    """The reference's advertised ballparks hold for the port's counts."""
    expected = {
        "qwen3-4b": (3.0e9, 6.5e9), "granite-3-2b": (2.0e9, 3.6e9),
        "smollm-360m": (0.3e9, 0.5e9), "minitron-4b": (3.5e9, 6.5e9),
        "falcon-mamba-7b": (6.0e9, 8.5e9), "whisper-base": (0.05e9, 0.2e9),
        "granite-moe-3b-a800m": (2.5e9, 4.5e9),
        "deepseek-v3-671b": (6.0e11, 7.5e11),
        "recurrentgemma-9b": (7.5e9, 11e9), "paligemma-3b": (2.2e9, 4.0e9),
    }
    for name, (lo, hi) in expected.items():
        assert lo <= configs.ARCHS[name].param_count <= hi, name
    ds = configs.ARCHS["deepseek-v3-671b"]
    assert ds.active_param_count < 0.1 * ds.param_count


# ===========================================================================
# token pipeline
# ===========================================================================

TOKEN_CFGS = [dict(vocab=1000, seq_len=16, global_batch=4),
              dict(vocab=100, seq_len=8, global_batch=8, n_shards=2, shard=1),
              dict(vocab=49152, seq_len=33, global_batch=3, seed=7)]


@pytest.mark.parametrize("kw", TOKEN_CFGS, ids=["plain", "shard1", "seed7"])
def test_token_batches_match_reference(kw):
    a = TokenPipeline(TokenPipelineConfig(**kw))
    b = jtokens.TokenPipeline(jtokens.TokenPipelineConfig(**kw))
    for _ in range(4):
        x, y = next(a)["tokens"], next(b)["tokens"]
        assert x.dtype == y.dtype == np.int32
        np.testing.assert_array_equal(x, y)
    assert a.state_dict() == b.state_dict() == {"step": 4}


def test_token_pipeline_resume_and_shards():
    cfg = TokenPipelineConfig(vocab=1000, seq_len=16, global_batch=4)
    a = TokenPipeline(cfg)
    batches = [next(a)["tokens"] for _ in range(5)]
    b = TokenPipeline(cfg, start_step=3)
    np.testing.assert_array_equal(next(b)["tokens"], batches[3])
    c = TokenPipeline(cfg)
    c.load_state_dict(a.state_dict())
    ref = jtokens.TokenPipeline(jtokens.TokenPipelineConfig(
        vocab=1000, seq_len=16, global_batch=4))
    ref.load_state_dict(a.state_dict())
    np.testing.assert_array_equal(next(c)["tokens"], next(ref)["tokens"])
    with pytest.raises(ValueError):
        TokenPipeline(TokenPipelineConfig(vocab=10, seq_len=4, global_batch=3,
                                          n_shards=2))


# ===========================================================================
# ScientificStore
# ===========================================================================

def _close_stat(want, got, field, stage, op, what):
    bound = (error_analysis.mean_bias_bound if op == "mean"
             else error_analysis.std_bias_bound)(field, stage)
    eps = float(field.eps.item())
    tol = max(1e-5 * abs(want), (1e-3 if bound >= eps else 0.5) * bound)
    assert abs(got - want) <= tol, (what, abs(got - want), tol)


def _bitwise(want, got, what):
    w, g = _np(want), _np(got)
    assert w.dtype == g.dtype and w.shape == g.shape, what
    if w.dtype == np.float32:   # bit patterns: -0.0 and 0.0 differ
        w, g = w.view(np.int32), g.view(np.int32)
    np.testing.assert_array_equal(g, w, err_msg=what)


STORE_CASES = [("Ocean", "hszp_nd"), ("Ocean", "hszx_nd"),
               ("Miranda", "hszp_nd"), ("Miranda", "hszx_nd")]


@pytest.mark.parametrize("dataset,scheme", STORE_CASES,
                         ids=[f"{d}-{s}" for d, s in STORE_CASES])
def test_store_reads_reference_bytes(tmp_path, dataset, scheme):
    """A port store under the reference store's ``root=`` answers stats /
    derivative_features / raw / normalized_batches as the reference does."""
    kw = dict(compressor_name=scheme, rel_eb=1e-3, scale=32, root=str(tmp_path))
    ref = jsci.ScientificStore(**kw)
    ref.put_all([dataset])
    port = ScientificStore(**kw, device="cpu")
    n_fields = jsci.DATASETS[dataset][0]
    for f in range(n_fields):
        assert port.get(dataset, f).blob == ref.get(dataset, f).blob
    c = port.get(dataset, 0).open()
    want, got = ref.stats(dataset, 0), port.stats(dataset, 0)
    stage1 = Stage.M if c.scheme.is_blockmean else Stage.P
    _close_stat(want["mean"], got["mean"], c, stage1, "mean", "mean")
    _close_stat(want["std"], got["std"], c, Stage.P, "std", "std")
    _bitwise(ref.raw(dataset, 0), port.raw(dataset, 0), "raw")
    for st in (Stage.P, Stage.Q):
        for w, g in zip(ref.derivative_features(dataset, 1, JStage(int(st))),
                        port.derivative_features(dataset, 1, st), strict=True):
            _bitwise(w, g, f"gradient@{st.name}")
    for w, g in zip(ref.derivative_features(dataset, 1, JStage.F),
                    port.derivative_features(dataset, 1, Stage.F), strict=True):
        w, g = _np(w), _np(g)
        np.testing.assert_allclose(g, w, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(w).max()))
    patch = (8, 8) if dataset == "Ocean" else (4, 4, 4)
    for bw, bg in zip(itertools.islice(ref.normalized_batches(dataset, 0, 3, patch), 3),
                      itertools.islice(port.normalized_batches(dataset, 0, 3, patch), 3)):
        assert bw.shape == bg.shape == (3,) + patch
        np.testing.assert_allclose(bg, bw, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("scheme", ["hszp_nd", "hszx_nd", "hszp", "hszx"])
def test_store_blob_equals_reference_serialize(scheme):
    """The port's blob for a field is the reference's
    ``serialize(compress(...))`` of the same array, byte for byte."""
    store = ScientificStore(compressor_name=scheme, scale=40, device="cpu")
    blob = store.get("Ocean", 1).blob
    data = synth_field("Ocean", 1, dataset_dims("Ocean", 40))
    want = jencode.serialize(jax_by_name(scheme).compress(jnp.asarray(data),
                                                          rel_eb=1e-3))
    assert blob == want


def test_store_disk_roundtrip_across_packages(tmp_path):
    """Bytes the port writes are read back by the port and by the
    reference, which agree on the stats."""
    s1 = ScientificStore(scale=48, root=str(tmp_path), device="cpu")
    st1 = s1.stats("Miranda", 0)
    assert (tmp_path / "Miranda_0.hsz").exists()
    assert ScientificStore(scale=48, root=str(tmp_path), device="cpu"
                           ).stats("Miranda", 0) == st1
    ref = jsci.ScientificStore(scale=48, root=str(tmp_path))
    c = s1.get("Miranda", 0).open()
    want = ref.stats("Miranda", 0)
    _close_stat(want["mean"], st1["mean"], c, Stage.P, "mean", "mean")
    _close_stat(want["std"], st1["std"], c, Stage.P, "std", "std")


def test_store_stats_against_decompressed():
    """The reference's own store checks, on the port alone."""
    store = ScientificStore(scale=24, rel_eb=1e-3, device="cpu")
    raw = _np(store.raw("Ocean", 0))
    st = store.stats("Ocean", 0)
    assert abs(st["mean"] - raw.mean()) <= 2e-3 * (raw.max() - raw.min())
    assert abs(st["std"] - raw.std(ddof=1)) <= 2e-3 * (raw.max() - raw.min())
    g = store.derivative_features("Ocean", 1)
    raw1 = _np(store.raw("Ocean", 1))
    ref0 = (raw1[2:, 1:-1] - raw1[:-2, 1:-1]) * 0.5
    np.testing.assert_allclose(_np(g[0]), ref0, atol=1e-5, rtol=1e-4)
    assert store.get("Ocean", 0).open().residuals.device.type == "cpu"


# ===========================================================================
# tests/test_system.py, on the port
# ===========================================================================

def test_paper_pipeline_end_to_end(tmp_path):
    """test_system's pipeline on the port, over the reference's bytes, held
    against the port's own stage-④ results and the reference's."""
    root = str(tmp_path)
    jstore = jsci.ScientificStore(scale=24, rel_eb=1e-3, root=root)
    jxstore = jsci.ScientificStore(compressor_name="hszx_nd", scale=24,
                                   rel_eb=1e-3, root=root + "/x")
    jstore.put_all(["Ocean"])
    jxstore.put_all(["Ocean"])
    store = ScientificStore(scale=24, rel_eb=1e-3, root=root, device="cpu")
    xstore = ScientificStore(compressor_name="hszx_nd", scale=24, rel_eb=1e-3,
                             root=root + "/x", device="cpu")
    c = xstore.get("Ocean", 0).open()
    raw = _np(xstore.raw("Ocean", 0))
    eps = float(c.eps)
    mean_m = float(H.mean(c, Stage.M))
    assert abs(mean_m - raw.mean()) <= 2 * eps
    _close_stat(float(JH.mean(jxstore.get("Ocean", 0).open(), JStage.M)),
                mean_m, c, Stage.M, "mean", "mean@M")
    cp = store.get("Ocean", 0).open()
    jcp = jstore.get("Ocean", 0).open()
    ref = _np(H.laplacian(cp, Stage.F))
    for stage in (Stage.P, Stage.Q):
        lap = H.laplacian(cp, stage)
        assert np.abs(_np(lap) - ref).max() < 1e-4
        _bitwise(JH.laplacian(jcp, JStage(int(stage))), lap, f"lap@{stage.name}")
    cu, cv = store.get("Ocean", 0).open(), store.get("Ocean", 1).open()
    div_q = H.divergence([cu, cv], Stage.Q)
    assert np.abs(_np(div_q) - _np(H.divergence([cu, cv], Stage.F))).max() < 1e-4
    jdiv = _np(JH.divergence([jstore.get("Ocean", 0).open(),
                              jstore.get("Ocean", 1).open()], JStage.Q))
    np.testing.assert_allclose(_np(div_q), jdiv, rtol=1e-6,
                               atol=1e-6 * float(np.abs(jdiv).max()))


def test_stage_selection_economics():
    """Lower stages decode strictly less (test_system's structural check)."""
    rng = np.random.default_rng(0)
    d = rng.normal(0, 1, (256, 256)).astype(np.float32)
    c = hszx_nd.compress(d, rel_eb=1e-3, device="cpu")
    assert c.metadata.numel() == c.n_blocks
    assert c.metadata.numel() < 0.01 * d.size
    p = hszx_nd.decompress(c, Stage.P)
    q = hszx_nd.decompress(c, Stage.Q, crop=False)
    assert p.dtype == q.dtype == torch.int32
    assert hszx_nd.decompress(c, Stage.F).dtype == torch.float32
    assert encode.serialize(c) == jencode.serialize(
        jax_by_name("hszx_nd").compress(jnp.asarray(d), rel_eb=1e-3))


# ===========================================================================
# the port's examples, at their smallest arguments on the CPU
# ===========================================================================

EXAMPLES = {
    "quickstart": [],
    "derived_operators": ["--n", "32"],
    "homomorphic_analytics": ["--scale", "64"],
    "serve_batched": [],
}


@pytest.mark.filterwarnings("ignore::DeprecationWarning")
@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_runs(name, capsys):
    import importlib
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    mod.main(EXAMPLES[name] + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.strip() and "nan" not in out.lower()
    if name == "derived_operators":
        assert "mean +2.000000 (exact +2)" in out
    if name == "serve_batched":
        assert out.count("8 requests, 96 tokens") == 2
