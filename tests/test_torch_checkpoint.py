"""The port's checkpoints (``repro_torch.train.checkpoint``) against the JAX
reference's (``repro.train.checkpoint``): one on-disk layout.

A reduced ``smollm-360m`` training state after one reference step (params,
AdamW moments, counts, the token pipeline's step, a bf16 leaf) is written
by both packages from the same numpy values.  What is held:

* leaf paths and their order equal the reference's (jax's pytree order:
  dict keys sorted, NamedTuple fields as ``.name``, ``None`` no leaf), also
  with a ``hom``-mode residual, which the port stores as worker 0's tree;
* the ``arrays/<i>.bin`` files **byte-identical** in lossless and HSZ mode;
* manifests equal apart from ``time``, with the HSZ ``stats`` within the
  restore check's own tolerance ``max(2·eps, 1e-6·max(|mean|, 1))``: they
  are the stage-② mean and std of a 1-D Lorenzo stream, the cell where the
  reference loses precision (ROADMAP queue 3);
* a checkpoint written by either package restores in the other: lossless
  leaves **bitwise**, HSZ leaves **bitwise** the other package's restore
  (the same streams decompressed) and within ``rel_eb·range·1.01``;
* the mirrors of ``tests/test_train_integration.py``'s exact resume
  (losses rtol 1e-6), failure recovery and HSZ error bound, an async
  save, and a corrupted manifest mean raising on restore.
"""
import dataclasses
import filecmp
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data.tokens import TokenPipeline as JPipeline
from repro.data.tokens import TokenPipelineConfig as JPipelineConfig
from repro.models import get_model as jget_model
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import configs, convert
from repro_torch.comm import PerWorker
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import get_model
from repro_torch.models.common import tree_flatten_with_paths, tree_map
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

ARCH = "smollm-360m"


@pytest.fixture(scope="module")
def ref_state():
    """(reference TrainState after one step, its numpy leaves, the
    pipeline's state)."""
    cfg = jconfigs.reduced(jconfigs.ARCHS[ARCH])
    m = jget_model(cfg)
    params, _ = m.init(jax.random.PRNGKey(0))
    step = jax.jit(jts.make_train_step(m, jopt.AdamWConfig(
        lr=3e-3, warmup_steps=5, total_steps=100, weight_decay=0.0)))
    pipe = JPipeline(JPipelineConfig(vocab=cfg.vocab, seq_len=32, global_batch=4))
    state = jts.init_state(params)
    state, _ = step(state, {k: jnp.asarray(v) for k, v in next(pipe).items()})
    return state, jax.tree.map(np.asarray, state), pipe.state_dict()


def _bf16():
    rng = np.random.default_rng(4)
    return rng.normal(0, 1, (40, 64)).astype(np.float32)


def _jax_tree(state, data):
    return state._asdict() | {"data": dict(data),
                              "extra": {"h": jnp.asarray(_bf16(), jnp.bfloat16)}}


def _port_tree(arrays, data):
    st = convert.train_state_from_arrays(arrays, device="cpu")
    return st._asdict() | {"data": dict(data), "extra": {
        "h": torch.as_tensor(_bf16()).to(torch.bfloat16)}}


def _np(x):
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


def _hom_state(arrays, world):
    """The reference state carried into the port with the params as every
    worker's residual tree (on ``["cpu"] * world``)."""
    st = convert.train_state_from_arrays(arrays._replace(
        ef_residual=arrays.params), device="cpu")
    mesh = make_host_mesh(devices=["cpu"] * world)
    return st._replace(ef_residual=PerWorker(
        tree_map(lambda t, _d=d: t.to(_d), st.ef_residual)
        for d in mesh.devices))


def _port_model(**kw):
    cfg = dataclasses.replace(configs.reduced(configs.ARCHS[ARCH]), **kw)
    return cfg, get_model(cfg)


# ===========================================================================
# layout against the reference
# ===========================================================================

def test_leaf_paths_and_order_equal_the_references(ref_state):
    state, arrays, data = ref_state
    want = jckpt._flatten_with_paths(_jax_tree(state, data))[0]
    got = tree_flatten_with_paths(ckpt._host_view(_port_tree(arrays, data)))[0]
    assert got == want
    assert want[:2] == ["data/step", "extra/h"] and want[-1] == "step"
    assert "opt/.count" in want and "opt/.m/embed" in want
    # a hom-mode residual: the reference's one tree, the port's worker 0
    jhom = state._replace(ef_residual=state.params)._asdict()
    port = _hom_state(arrays, 2)
    assert isinstance(port.ef_residual, PerWorker) and len(port.ef_residual) == 2
    assert (tree_flatten_with_paths(ckpt._host_view(port._asdict()))[0]
            == jckpt._flatten_with_paths(jhom)[0])


@pytest.mark.parametrize("mode", ["lossless", "hsz"])
def test_files_byte_identical_and_manifests_equal(ref_state, tmp_path, mode):
    state, arrays, data = ref_state
    jd, td = str(tmp_path / "jax"), str(tmp_path / "torch")
    jckpt.save(jd, 1, _jax_tree(state, data), mode=mode, rel_eb=1e-4)
    ckpt.save(td, 1, _port_tree(arrays, data), mode=mode, rel_eb=1e-4)
    jm, tm = _manifest(jd, 1), _manifest(td, 1)
    assert set(jm) == set(tm)
    for k in jm:
        if k not in ("time", "leaves"):
            assert jm[k] == tm[k], k
    assert len(jm["leaves"]) == len(tm["leaves"])
    n_hsz = 0
    for je, te in zip(jm["leaves"], tm["leaves"]):
        js, ts_ = je.pop("stats", None), te.pop("stats", None)
        assert je == te
        assert filecmp.cmp(os.path.join(jd, "step_00000001", je["file"]),
                           os.path.join(td, "step_00000001", te["file"]),
                           shallow=False), je["path"]
        if js is not None:
            n_hsz += 1
            from repro.core import encode as jencode
            with open(os.path.join(jd, "step_00000001", je["file"]), "rb") as f:
                eps = float(jencode.deserialize(f.read()).eps)
            for stat in ("mean", "std"):
                tol = max(2 * eps, 1e-6 * max(abs(js[stat]), 1))
                assert abs(ts_[stat] - js[stat]) <= tol, (je["path"], stat)
    assert (n_hsz > 0) == (mode == "hsz")
    if mode == "hsz":   # the bf16 leaf stays lossless in both
        h = next(e for e in tm["leaves"] if e["path"] == "extra/h")
        assert h["dtype"] == "bfloat16" and h["codec"] in ("zstd", "zlib")


@pytest.mark.parametrize("mode", ["lossless", "hsz"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_restores_across_packages(ref_state, tmp_path, mode, writer):
    state, arrays, data = ref_state
    d = str(tmp_path)
    jtree, ttree = _jax_tree(state, data), _port_tree(arrays, data)
    if writer == "jax":
        jckpt.save(d, 3, jtree, mode=mode, rel_eb=1e-4)
    else:
        ckpt.save(d, 3, ttree, mode=mode, rel_eb=1e-4)
    assert ckpt.latest_step(d) == jckpt.latest_step(d) == 3
    jr = jckpt.restore(d, 3, jtree)
    tr = ckpt.restore(d, 3, ttree, device="cpu")
    paths, got = tree_flatten_with_paths(tr)
    want = jax.tree.leaves(jr)
    originals = jax.tree.leaves(jtree)
    assert len(got) == len(want) == len(originals)
    for path, g, w, o in zip(paths, got, want, originals):
        assert isinstance(g, torch.Tensor), path
        np.testing.assert_array_equal(_np(g), _np(w), err_msg=path)
        o = _np(o)
        if mode == "lossless" or o.size < 1024 or path == "extra/h":
            np.testing.assert_array_equal(_np(g), o, err_msg=path)
        else:
            rng = float(o.max() - o.min())
            assert np.abs(_np(g) - o).max() <= max(1e-4 * rng, 1e-7) * 1.01, path
    assert tr["extra"]["h"].dtype == torch.bfloat16
    assert tr["step"].dtype == torch.int32 and int(tr["data"]["step"]) == 1


def test_per_worker_residual_stored_as_worker0_restored_on_each(ref_state, tmp_path):
    _, arrays, _ = ref_state
    st = _hom_state(arrays, 3)
    st = st._replace(ef_residual=PerWorker(
        tree_map(lambda t, _w=w: t + _w, r) for w, r in enumerate(st.ef_residual)))
    ckpt.save(str(tmp_path), 2, st._asdict())
    fresh = _hom_state(arrays, 3)
    fresh = fresh._replace(ef_residual=PerWorker(
        tree_map(torch.zeros_like, r) for r in fresh.ef_residual))
    back = ts.TrainState(**ckpt.restore(str(tmp_path), 2, fresh._asdict(),
                                        device="cpu"))
    assert isinstance(back.ef_residual, PerWorker) and len(back.ef_residual) == 3
    for r in back.ef_residual:
        for a, b in zip(tree_flatten_with_paths(r)[1],
                        tree_flatten_with_paths(st.ef_residual[0])[1]):
            assert torch.equal(a, b)
    # the reference reads the same file as its one residual tree
    jtarget = jts.TrainState(
        params=arrays.params, opt=arrays.opt, step=arrays.step,
        ef_residual=arrays.params)._asdict()
    jr = jckpt.restore(str(tmp_path), 2, jtarget)
    for a, b in zip(jax.tree.leaves(jr["ef_residual"]),
                    tree_flatten_with_paths(st.ef_residual[0])[1]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


# ===========================================================================
# the reference's integration tests, mirrored on the port
# ===========================================================================

def _setup():
    cfg, model = _port_model()
    params, _ = model.init(torch.Generator().manual_seed(0), device="cpu")
    opt_cfg = opt.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=100,
                              weight_decay=0.0)
    pipe = TokenPipeline(TokenPipelineConfig(vocab=cfg.vocab, seq_len=32,
                                             global_batch=4))
    return ts.make_train_step(model, opt_cfg), ts.init_state(params), pipe


def _next(pipe):
    return {k: torch.as_tensor(v) for k, v in next(pipe).items()}


def test_checkpoint_exact_resume(tmp_path):
    step, state, pipe = _setup()
    for _ in range(4):
        state, _ = step(state, _next(pipe))
    ckpt.save(str(tmp_path), 4, state._asdict() | {"data": pipe.state_dict()},
              mode="lossless")
    cont, state_a = [], state
    pipe_a = TokenPipeline(pipe.cfg, start_step=pipe.step)
    for _ in range(3):
        state_a, m = step(state_a, _next(pipe_a))
        cont.append(float(m["loss"]))
    step2, state_b, pipe_b = _setup()
    last = ckpt.latest_step(str(tmp_path))
    assert last == 4
    restored = ckpt.restore(str(tmp_path), last,
                            state_b._asdict() | {"data": pipe_b.state_dict()},
                            device="cpu")
    pipe_b.load_state_dict(restored.pop("data"))
    state_b = ts.TrainState(**restored)
    resumed = []
    for _ in range(3):
        state_b, m = step2(state_b, _next(pipe_b))
        resumed.append(float(m["loss"]))
    np.testing.assert_allclose(resumed, cont, rtol=1e-6)


def test_simulated_failure_recovery(tmp_path):
    step, state, pipe = _setup()
    for i in range(6):
        state, _ = step(state, _next(pipe))
        if i % 2 == 1:
            ckpt.save(str(tmp_path), i, state._asdict(), mode="lossless", keep=2)
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]
    last = ckpt.latest_step(str(tmp_path))
    assert last == 5
    step2, state2, _ = _setup()
    state2 = ts.TrainState(**ckpt.restore(str(tmp_path), last, state2._asdict(),
                                          device="cpu"))
    state2, m = step2(state2, _next(pipe))
    assert np.isfinite(float(m["loss"]))
    assert len([d for d in os.listdir(tmp_path) if d.startswith("step_")]) <= 2


def test_hsz_checkpoint_error_bounded(tmp_path):
    step, state, pipe = _setup()
    state, _ = step(state, _next(pipe))
    ckpt.save(str(tmp_path), 1, {"params": state.params}, mode="hsz", rel_eb=1e-4)
    restored = ckpt.restore(str(tmp_path), 1, {"params": state.params},
                            device="cpu")
    for a, b in zip(tree_flatten_with_paths(state.params)[1],
                    tree_flatten_with_paths(restored["params"])[1]):
        a, b = a.numpy(), b.numpy()
        rng = a.max() - a.min()
        if a.size >= 1024:
            assert np.max(np.abs(a - b)) <= max(1e-4 * rng, 1e-7) * 1.01
        else:
            np.testing.assert_array_equal(a, b)  # small leaves stay lossless


def test_async_save_and_retention(tmp_path):
    _, state, pipe = _setup()
    tree = state._asdict() | {"data": pipe.state_dict()}
    threads = [ckpt.save(str(tmp_path), s, tree, blocking=False, keep=2)
               for s in (1,)]
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    t = ckpt.save(str(tmp_path), 2, tree, mode="hsz", blocking=False, keep=2)
    t.join(timeout=120)
    assert not t.is_alive()
    ckpt.save(str(tmp_path), 3, tree, keep=2)
    assert sorted(os.listdir(tmp_path)) == ["step_00000002", "step_00000003"]
    back = ckpt.restore(str(tmp_path), 2, tree, device="cpu")
    assert int(back["step"]) == 0 and int(back["data"]["step"]) == 0


def test_corrupted_manifest_mean_raises(tmp_path):
    _, state, _ = _setup()
    ckpt.save(str(tmp_path), 1, {"params": state.params}, mode="hsz")
    path = os.path.join(str(tmp_path), "step_00000001", "manifest.json")
    with open(path) as f:
        manifest = json.load(f)
    entry = next(e for e in manifest["leaves"] if e["codec"] == "hsz")
    entry["stats"]["mean"] += 1.0
    with open(path, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ValueError, match="integrity check failed"):
        ckpt.restore(str(tmp_path), 1, {"params": state.params}, device="cpu")
    # the check can be turned off, as in the reference
    ckpt.restore(str(tmp_path), 1, {"params": state.params}, device="cpu",
                 verify=False)
