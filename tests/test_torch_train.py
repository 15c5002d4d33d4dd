"""The port's training side (``repro_torch.train``, ``launch.train``, the
example) against the JAX reference (``repro.train``).

Reduced archs on the reference's initialised params
(``convert.params_from_arrays``) and the same seeded numpy batches; the
reference's entry points under ``jax.jit``.  What is held, with its
tolerance:

* AdamW ``update`` and ``schedule`` on the same numpy grads, params and
  state: params and ``lr`` within 2 f32 ulps, ``m`` and ``v`` within 2 ulps
  of their larger term (XLA contracts ``b·m + (1-b)·g`` into a fused
  multiply-add, so a sum that cancels differs by more ulps of the result;
  its ``cos`` and ``pow`` are not torch's), the count exact;
* loss and every gradient leaf of the ten reduced archs at f32 compute
  against ``jax.value_and_grad``: ``rtol=atol=1e-4`` (the same f32
  arithmetic summed in another order; the models' own parity tests see
  about 2e-6 on the forward);
* ``remat`` ``"none"`` / ``"full"`` / ``"dots"``: loss and grads **bitwise**
  equal on the CPU (remat changes memory, not values);
* the mirrors of ``tests/test_train_integration.py``'s loss decrease and
  microbatching (loss rtol 1e-5, grad norm rtol 1e-3);
* three ``gspmd`` steps from a state carried over from the reference
  (``convert.train_state_from_arrays``) at f32 compute: losses rtol 1e-4;
* the ``hom`` step over 4 workers on ``make_host_mesh(devices=["cpu"] *
  4)``: its per-worker residuals **bitwise**, and its params within 8 ulps
  of the larger term of ``p - lr·step`` plus ``1e-5·lr`` (``lr·step`` is
  rounded about six times, and a cancelling moment moves ``step`` by about
  2^-23), of the reference's pieces composed in a 4-device subprocess (its
  ``compressed_psum_tree`` under ``shard_map`` and ``optimizer.update``)
  fed the port's per-worker gradients.  The reference's own ``hom`` step
  is not the oracle: under this jax its autodiff sums the replicated
  params' cotangents over the workers inside the ``shard_map`` body, so it
  applies the sum of the workers' gradients (ROADMAP queue 3);
* ``python -m repro_torch.launch.train`` and the example, in subprocesses.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data.tokens import TokenPipeline as JPipeline
from repro.data.tokens import TokenPipelineConfig as JPipelineConfig
from repro.models import get_model as jget_model
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import configs, convert
from repro_torch.comm import PerWorker
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import get_model
from repro_torch.models.common import tree_flatten_with_paths
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALL_ARCHS = list(configs.ARCHS)
F32_TOL = dict(rtol=1e-4, atol=1e-4)
HOM_WORLD = 4


def _cfgs(name, f32=True, **kw):
    jc = jconfigs.reduced(jconfigs.ARCHS[name])
    tc = configs.reduced(configs.ARCHS[name])
    if f32:
        jc = dataclasses.replace(jc, compute_dtype=jnp.float32)
        tc = dataclasses.replace(tc, compute_dtype=torch.float32)
    return dataclasses.replace(jc, **kw), dataclasses.replace(tc, **kw)


@functools.lru_cache(maxsize=None)
def _ref_params(name):
    """The reference's initialised params (f32) as numpy leaves."""
    params, _ = jget_model(jconfigs.reduced(jconfigs.ARCHS[name])).init(
        jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def _batch(cfg, seed=1, b=2, t=8):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)}
    if cfg.prefix_tokens:
        out["prefix_embeds"] = rng.normal(
            size=(b, cfg.prefix_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        out["frames"] = rng.normal(
            size=(b, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    return out


def _leaves(tree):
    """numpy leaves of a port tree in jax's leaf order."""
    return [t.detach().numpy() for t in tree_flatten_with_paths(tree)[1]]


def _np_leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


# ===========================================================================
# optimizer
# ===========================================================================

def test_schedule_matches_reference():
    cfg = opt.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=100)
    jcfg = jopt.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=100)
    steps = np.asarray([0, 1, 3, 5, 6, 37, 50, 99, 100, 101, 5000], np.int32)
    want = np.asarray(jax.jit(jax.vmap(lambda s: jopt.schedule(jcfg, s)))(steps))
    got = torch.stack([opt.schedule(cfg, torch.tensor(s)) for s in steps]).numpy()
    np.testing.assert_array_max_ulp(got, want, maxulp=2)


@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_adamw_update_matches_reference(clip):
    rng = np.random.default_rng(5)
    shapes = {"w": (33, 17), "b": (17,), "layers": [(4, 8), (8,)]}
    mk = lambda s, sd: rng.normal(0, sd, s).astype(np.float32)
    params = {"w": mk(shapes["w"], 1), "b": mk(shapes["b"], 1),
              "layers": [mk(s, 1) for s in shapes["layers"]]}
    grads = jax.tree.map(lambda p: mk(p.shape, 0.3), params)
    m = jax.tree.map(lambda p: mk(p.shape, 0.01), params)
    v = jax.tree.map(lambda p: np.abs(mk(p.shape, 0.01)), params)
    count = np.int32(3)
    jcfg = jopt.AdamWConfig(grad_clip=clip, warmup_steps=2, total_steps=20)
    cfg = opt.AdamWConfig(grad_clip=clip, warmup_steps=2, total_steps=20)
    j_p, j_s, j_st = jax.jit(functools.partial(jopt.update, jcfg))(
        grads, jopt.OptState(m, v, count), params)
    as_t = lambda t: jax.tree.map(torch.as_tensor, t)
    p, s, st = opt.update(cfg, as_t(grads), opt.OptState(
        as_t(m), as_t(v), torch.tensor(count)), as_t(params))
    for a, b in zip(_leaves(p), _np_leaves(j_p)):
        np.testing.assert_array_max_ulp(a, b, maxulp=2)
    # a moment is a two-term sum that can cancel: its ulps are counted at
    # the larger term (XLA fuses ``b·m`` into a multiply-add, torch rounds it)
    scale = min(1.0, clip / float(j_st["grad_norm"]))
    for got, want, old, b, sq in ((s.m, j_s.m, m, jcfg.b1, False),
                                  (s.v, j_s.v, v, jcfg.b2, True)):
        for a, w, o, g in zip(_leaves(got), _np_leaves(want),
                              jax.tree.leaves(old), jax.tree.leaves(grads)):
            g = g * scale
            term = np.maximum(np.abs(b * o), np.abs((1 - b) * (g * g if sq else g)))
            assert np.all(np.abs(a - w) <= 2 * np.spacing(term.astype(np.float32)))
    assert int(s.count) == int(j_s.count) == 4 and s.count.dtype == torch.int32
    np.testing.assert_array_max_ulp(st["lr"].numpy(), np.asarray(j_st["lr"]), 2)
    np.testing.assert_allclose(float(st["grad_norm"]), float(j_st["grad_norm"]),
                               rtol=1e-6)


def test_global_norm_sums_leaves_in_jax_order():
    tree = {"z": torch.tensor([3.0]), "a": [torch.tensor([4.0]),
                                           torch.tensor([12.0])]}
    assert float(opt.global_norm(tree)) == 13.0
    assert tree_flatten_with_paths(tree)[0] == ["a/0", "a/1", "z"]


# ===========================================================================
# gradients against jax.value_and_grad, remat
# ===========================================================================

@pytest.mark.parametrize("name", ALL_ARCHS)
def test_loss_and_grads_match_reference_f32(name):
    jc, tc = _cfgs(name)
    arrays = _ref_params(name)
    batch = _batch(tc)
    j_loss, j_grads = jax.jit(jax.value_and_grad(jget_model(jc).loss_fn))(
        jax.tree.map(jnp.asarray, arrays),
        {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = ts.value_and_grad(
        get_model(tc).loss_fn, convert.params_from_arrays(arrays, device="cpu"),
        {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(j_loss), **F32_TOL)
    paths, got = tree_flatten_with_paths(grads)
    want = _np_leaves(j_grads)
    assert len(got) == len(want)
    for path, g, w in zip(paths, got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, path
        np.testing.assert_allclose(g.numpy(), w, err_msg=path, **F32_TOL)


@pytest.mark.parametrize("name", ALL_ARCHS)
def test_remat_modes_bitwise_equal(name):
    arrays = _ref_params(name)
    batch = {k: torch.as_tensor(v)
             for k, v in _batch(configs.reduced(configs.ARCHS[name])).items()}
    out = {}
    for mode in ("none", "full", "dots"):
        _, tc = _cfgs(name, f32=False, remat=mode)
        out[mode] = ts.value_and_grad(
            get_model(tc).loss_fn,
            convert.params_from_arrays(arrays, device="cpu"), batch)
    for mode in ("full", "dots"):
        assert torch.equal(out[mode][0], out["none"][0]), mode
        for a, b in zip(_leaves(out[mode][1]), _leaves(out["none"][1])):
            np.testing.assert_array_equal(a, b, err_msg=mode)


# ===========================================================================
# the train step: the reference's integration tests, mirrored
# ===========================================================================

def _setup(lr=3e-3, seq_len=32, batch=4, **kw):
    cfg = dataclasses.replace(configs.reduced(configs.ARCHS["smollm-360m"]), **kw)
    model = get_model(cfg)
    params = convert.params_from_arrays(_ref_params("smollm-360m"), device="cpu")
    opt_cfg = opt.AdamWConfig(lr=lr, warmup_steps=5, total_steps=100,
                              weight_decay=0.0)
    pipe = TokenPipeline(TokenPipelineConfig(vocab=cfg.vocab, seq_len=seq_len,
                                             global_batch=batch))
    return model, opt_cfg, ts.init_state(params), pipe


def _tensors(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def test_loss_decreases():
    model, opt_cfg, state, pipe = _setup()
    step = ts.make_train_step(model, opt_cfg)
    losses = []
    for _ in range(30):
        state, metrics = step(state, _tensors(next(pipe)))
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1, losses
    assert int(state.step) == 30 and state.step.dtype == torch.int32
    assert all(not p.requires_grad for p in tree_flatten_with_paths(state.params)[1])


def test_microbatched_matches_full_batch():
    model, _, state, pipe = _setup()
    opt_cfg = opt.AdamWConfig(lr=1e-3, weight_decay=0.0)
    batch = _tensors(next(pipe))
    _, m1 = ts.make_train_step(model, opt_cfg)(state, batch)
    _, m2 = ts.make_train_step(model, opt_cfg, microbatch=2)(state, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m1["grad_norm"]), float(m2["grad_norm"]),
                               rtol=1e-3)


def test_gspmd_steps_match_reference_from_carried_state():
    """Two reference steps, the state carried into the port, then three
    steps in each package on the same batches (f32 compute)."""
    jc, tc = _cfgs("smollm-360m")
    jcfg = jopt.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=100)
    cfg = opt.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=100)
    jstep = jax.jit(jts.make_train_step(jget_model(jc), jcfg))
    jstate = jts.init_state(jax.tree.map(jnp.asarray, _ref_params("smollm-360m")))
    jpipe = JPipeline(JPipelineConfig(vocab=jc.vocab, seq_len=32, global_batch=4))
    for _ in range(2):
        jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in next(jpipe).items()})
    state = convert.train_state_from_arrays(jax.tree.map(np.asarray, jstate),
                                            device="cpu")
    assert int(state.step) == 2 and state.ef_residual is None
    back = convert.train_state_to_arrays(state)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, jstate)),
                    _np_leaves(jts.TrainState(*back))):
        np.testing.assert_array_equal(a, b)
    step = ts.make_train_step(get_model(tc), cfg)
    pipe = TokenPipeline(TokenPipelineConfig(vocab=tc.vocab, seq_len=32,
                                             global_batch=4), start_step=jpipe.step)
    for _ in range(3):
        b = next(jpipe)
        np.testing.assert_array_equal(b["tokens"], next(pipe)["tokens"])
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = step(state, _tensors(b))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
    assert int(state.step) == int(jstate.step) == 5


# ===========================================================================
# hom mode: the port's step against the reference's composed pieces
# ===========================================================================

HOM_SCRIPT = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.comm import hom_collectives as hom
from repro.launch.mesh import auto_axis_types
from repro.train import optimizer as opt_lib

src, dst = sys.argv[1], sys.argv[2]
data = dict(np.load(src))
names = [k[len("p0/"):] for k in data if k.startswith("p0/")]
tree = lambda pre: {n: jnp.asarray(data[pre + n]) for n in names}
mesh = jax.make_mesh((4,), ("data",), **auto_axis_types(1))
spec = {n: P("data") for n in names}

def body(g, r):
    mean, new_r = hom.compressed_psum_tree(
        {n: v[0] for n, v in g.items()}, {n: v[0] for n, v in r.items()},
        "data", 4)
    return mean, {n: v[None] for n, v in new_r.items()}

psum = jax.jit(compat.shard_map(body, mesh=mesh, in_specs=(spec, spec),
                                out_specs=({n: P() for n in names}, spec),
                                check=False))
cfg = opt_lib.AdamWConfig(**json.loads(sys.argv[3]))
update = jax.jit(lambda g, s, p: opt_lib.update(cfg, g, s, p))
res = {n: jnp.zeros_like(data["g0/" + n]) for n in names}
out = {}
for s in range(2):
    # each step from the port's state before it (its params within ulps of
    # the reference's), the residual carried from the previous psum
    state = opt_lib.OptState(m=tree(f"m{s}/"), v=tree(f"v{s}/"),
                             count=jnp.asarray(data[f"count{s}"]))
    mean, res = psum(tree(f"g{s}/"), res)
    params, state, stats = update(mean, state, tree(f"p{s}/"))
    for n in names:
        out[f"res{s}/" + n] = np.asarray(res[n])
        out[f"p{s}/" + n] = np.asarray(params[n])
    out[f"gnorm{s}"] = np.asarray(stats["grad_norm"])
np.savez(dst, **out)
"""


def _flat_names(tree):
    paths, leaves = tree_flatten_with_paths(tree)
    return {p.replace("/", "."): l for p, l in zip(paths, leaves)}


def test_hom_step_world4_matches_reference_pieces(tmp_path):
    model, opt_cfg, state, pipe = _setup(batch=8)
    mesh = make_host_mesh(devices=["cpu"] * HOM_WORLD)
    state = ts.init_state(state.params, hom_mode=True, mesh=mesh)
    assert isinstance(state.ef_residual, PerWorker)
    step = ts.make_train_step(model, opt_cfg, mode="hom", mesh=mesh)
    feed, states, metrics = {}, [], []
    for s in range(2):
        for pre, tree in (("p", state.params), ("m", state.opt.m),
                          ("v", state.opt.v)):
            feed.update({f"{pre}{s}/{n}": t.numpy()
                         for n, t in _flat_names(tree).items()})
        feed[f"count{s}"] = state.opt.count.numpy()
        batch = _tensors(next(pipe))
        per_worker = [ts.value_and_grad(model.loss_fn, state.params, b)
                      for b in ts.split_batch(batch, HOM_WORLD)]
        for n in _flat_names(state.params):
            feed[f"g{s}/{n}"] = np.stack(
                [_flat_names(g)[n].numpy() for _, g in per_worker])
        state, m = step(state, batch)
        np.testing.assert_allclose(
            float(m["loss"]), np.mean([float(l) for l, _ in per_worker]),
            rtol=1e-6)
        states.append(state)
        metrics.append(m)
    np.savez(tmp_path / "in.npz", **feed)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", HOM_SCRIPT, str(tmp_path / "in.npz"),
                        str(tmp_path / "out.npz"),
                        json.dumps(dataclasses.asdict(opt_cfg))], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    ref = dict(np.load(tmp_path / "out.npz"))
    for s, (st, m) in enumerate(zip(states, metrics)):
        assert len(st.ef_residual) == HOM_WORLD and int(st.step) == s + 1
        for w in range(HOM_WORLD):
            for n, t in _flat_names(st.ef_residual[w]).items():
                np.testing.assert_array_equal(t.numpy(), ref[f"res{s}/{n}"][w],
                                              err_msg=f"step {s} worker {w} {n}")
        for n, t in _flat_names(st.params).items():
            # ``p - lr·step`` cancels where a param is near its update, so
            # the ulps are counted at the larger of its two terms, and
            # ``lr·step`` is rounded about six times on the way; a moment
            # that cancels (``b·m + (1-b)·g``, fused by XLA) moves ``step``
            # by at most about 2^-23 / sqrt(1 - b2), hence ``1e-5·lr``
            old, want = feed[f"p{s}/{n}"], ref[f"p{s}/{n}"]
            term = np.maximum(np.abs(old), np.abs(old - want))
            gap = np.abs(t.numpy() - want)
            bad = gap > 8 * np.spacing(term) + 1e-5 * opt_cfg.lr
            assert not bad.any(), (n, old[bad][:4], want[bad][:4],
                                   t.numpy()[bad][:4], int(bad.sum()))
        np.testing.assert_allclose(float(m["grad_norm"]), float(ref[f"gnorm{s}"]),
                                   rtol=1e-6)


# ===========================================================================
# entry points
# ===========================================================================

def _run(args, tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-m", *args], capture_output=True,
                       text=True, env=env, cwd=tmp_path, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def test_launch_train_cli_and_resume(tmp_path):
    ck = str(tmp_path / "ck")
    out = _run(["repro_torch.launch.train", "--reduced", "--device", "cpu",
                "--steps", "3", "--ckpt-dir", ck, "--ckpt-every", "2"], tmp_path)
    assert "[train] finished 3 steps" in out and "step     1 loss" in out
    assert os.path.isdir(os.path.join(ck, "step_00000002"))
    out = _run(["repro_torch.launch.train", "--reduced", "--device", "cpu",
                "--steps", "4", "--ckpt-dir", ck], tmp_path)
    assert "resumed from step 2" in out and "finished 4 steps" in out


def test_train_example_runs_with_failure_and_restart(tmp_path):
    out = _run(["repro_torch.examples.train_lm_compressed_dp", "--device", "cpu",
                "--steps", "12", "--fail-at", "8", "--ckpt-every", "4",
                "--seq-len", "32", "--batch", "4",
                "--ckpt-dir", str(tmp_path / "ck")], tmp_path)
    assert "simulated failure at step 8" in out and "done: 12 steps" in out
    loss = float(out.rsplit("final loss", 1)[1])
    assert np.isfinite(loss)
