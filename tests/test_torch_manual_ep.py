"""Manual expert parallelism (``repro_torch.models.ffn.moe_manual_ep``) and
the ``("data", "model")`` mesh in training, against the JAX reference.

The reference runs in subprocesses with
``--xla_force_host_platform_device_count=8``: its ``moe_manual_ep`` under a
``shard_map`` over the mesh, with ``jax.lax.all_to_all`` / ``all_gather``
wrapped to record what every (data, model) peer sends (``jax.debug.callback``
with the peer's axis indices).  The port runs the same inputs on
``make_host_mesh(shape, devices=["cpu"] * n)``, its ``comm.exchange``
wrapped the same way.  What is held, at f32, with its tolerance:

* meshes (1, 4), (2, 4), (2, 2) with 5 experts (padded to 8 / 8 / 6),
  softmax and sigmoid routers, ``n_shared`` 0 and 1, ``capacity_factor``
  1.25 (tokens dropped at both stages; ``round`` half to even: cap2 of 12.5
  is 12) and 8.0:
  - the routing plan **bitwise**: every peer's stage-1 send rows (gathers of
    ``x``) and local-expert ids (``send_le``; ``E_loc`` marks an empty
    slot), which fix ``slot1``;
  - the expert outputs each peer sends back (``slot2``'s dispatch through
    the experts), the combined rows before the all-gather and the output
    within ``atol=rtol=1e-5`` (about 2e-7 observed: einsums summed in
    another order);
* gradients of ``sum(y · ct)`` for params and ``x`` against ``jax.grad``
  within 1e-4, on every mesh;
* with nothing dropped (``capacity_factor`` 16), the port's ``moe``
  (within 1e-6);
* a ``gspmd`` train step of the reduced ``granite-moe-3b-a800m`` and
  ``deepseek-v3-671b`` at f32 compute under a (2, 2) mesh (manual EP in
  every MoE layer) against the reference's under the same mesh: loss and
  every gradient leaf within 1e-4, one step's params within 1e-4;
* ``hom`` on the (2, 2) mesh equals the (2, 1) mesh **bitwise** (inside the
  worker body ``CTX.manual_dp`` is set, so no expert parallelism);
* ``shard`` under an active mesh is the identity.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import get_model as jget_model
from repro_torch import configs, convert
from repro_torch.comm import exchange
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import common, ffn, get_model, transformer
from repro_torch.models.common import tree_flatten_with_paths
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, F, E, K = 16, 8, 5, 2
B, S = 4, 8
MESHES = [(1, 4), (2, 4), (2, 2)]
CASES = [dict(mesh=m, softmax=sm, n_shared=ns, cf=cf)
         for m in MESHES for sm in (True, False) for ns in (0, 1)
         for cf in (1.25, 8.0)]
GRAD_CASES = [dict(mesh=m, softmax=True, n_shared=1, cf=1.25) for m in MESHES]
STEP_ARCHS = ["granite-moe-3b-a800m", "deepseek-v3-671b"]
EP_TOL = dict(rtol=1e-5, atol=1e-5)
F32_TOL = dict(rtol=1e-4, atol=1e-4)


def _case_id(c):
    return (f"{c['mesh'][0]}x{c['mesh'][1]}-{'softmax' if c['softmax'] else 'sigmoid'}"
            f"-shared{c['n_shared']}-cf{c['cf']}")


def _inputs():
    rng = np.random.default_rng(0)
    n = lambda *s: rng.normal(size=s).astype(np.float32) * 0.5
    return {"p/router": n(D, E), "p/w_gate": n(E, D, F), "p/w_up": n(E, D, F),
            "p/w_down": n(E, F, D), "p/shared/gate": n(D, F),
            "p/shared/up": n(D, F), "p/shared/down": n(F, D),
            "x": n(B, S, D), "ct": n(B, S, D)}


REF_EP = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp
import numpy as np
from repro.launch import mesh as mesh_lib
from repro.models import ffn

src, dst = sys.argv[1], sys.argv[2]
cases, grad_cases = json.loads(sys.argv[3]), json.loads(sys.argv[4])
data = dict(np.load(src))
seen = {}
orig = {"all_to_all": jax.lax.all_to_all, "all_gather": jax.lax.all_gather}


def spy(kind):
    def wrapped(x, axis_name, *a, **kw):
        i = spy.n[kind]
        spy.n[kind] += 1
        def store(v, d, g, i=i):
            seen[f"{kind}{i}/{int(d)}/{int(g)}"] = np.asarray(v)
        jax.debug.callback(store, x, jax.lax.axis_index("data"),
                           jax.lax.axis_index("model"))
        return orig[kind](x, axis_name, *a, **kw)
    return wrapped


spy.n = {}
jax.lax.all_to_all = spy("all_to_all")
jax.lax.all_gather = spy("all_gather")


def params(n_shared):
    p = {k: jnp.asarray(data["p/" + k]) for k in ("router", "w_gate", "w_up", "w_down")}
    if n_shared:
        p["shared"] = {k: jnp.asarray(data["p/shared/" + k]) for k in ("gate", "up", "down")}
    return p


def setup(c):
    mesh = jax.sharding.Mesh(
        np.array(jax.devices()[:c["mesh"][0] * c["mesh"][1]]).reshape(c["mesh"]),
        ("data", "model"))
    mesh_lib.activate(mesh)
    cfg = ffn.FfnCfg(d_model=16, d_ff=8, moe=True, n_experts=5, top_k=2,
                     n_shared=c["n_shared"], shared_d_ff=8,
                     capacity_factor=c["cf"], router_softmax=c["softmax"])
    return cfg


out = {}
x, ct = jnp.asarray(data["x"]), jnp.asarray(data["ct"])
for ci, c in enumerate(cases):
    cfg = setup(c)
    spy.n = {"all_to_all": 0, "all_gather": 0}
    seen.clear()
    y = jax.jit(lambda p, x: ffn.moe_manual_ep(p, x, cfg))(params(c["n_shared"]), x)
    jax.effects_barrier()
    out[f"{ci}/y"] = np.asarray(y)
    for k, v in seen.items():
        out[f"{ci}/{k}"] = v
    mesh_lib.deactivate()
for ci, c in enumerate(grad_cases):
    cfg = setup(c)
    f = lambda p, x: jnp.sum(ffn.moe_manual_ep(p, x, cfg) * ct)
    gp, gx = jax.jit(jax.grad(f, argnums=(0, 1)))(params(c["n_shared"]), x)
    out[f"g{ci}/x"] = np.asarray(gx)
    for path, leaf in jax.tree_util.tree_flatten_with_path(gp)[0]:
        out[f"g{ci}/p/" + "/".join(str(k.key) for k in path)] = np.asarray(leaf)
    mesh_lib.deactivate()
np.savez(dst, **out)
"""


def _run(script, tmp, *args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", script, *map(str, args)],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]


@pytest.fixture(scope="module")
def ref_ep(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ep")
    np.savez(tmp / "in.npz", **_inputs())
    _run(REF_EP, tmp, tmp / "in.npz", tmp / "out.npz", json.dumps(CASES),
         json.dumps(GRAD_CASES))
    return dict(np.load(tmp / "out.npz"))


def _port_params(n_shared, requires_grad=False):
    data = _inputs()
    p = {k: torch.tensor(data["p/" + k]) for k in ("router", "w_gate", "w_up", "w_down")}
    if n_shared:
        p["shared"] = {k: torch.tensor(data["p/shared/" + k])
                       for k in ("gate", "up", "down")}
    if requires_grad:
        p = common.tree_map(lambda t: t.requires_grad_(True), p)
    return p


def _cfg(c):
    return ffn.FfnCfg(d_model=D, d_ff=F, moe=True, n_experts=E, top_k=K,
                      n_shared=c["n_shared"], shared_d_ff=F,
                      capacity_factor=c["cf"], router_softmax=c["softmax"])


@pytest.fixture
def on_mesh():
    """Activate a CPU host mesh of a shape; deactivate afterwards."""
    def activate(shape):
        mesh = mesh_lib.make_host_mesh(shape, devices=["cpu"] * int(np.prod(shape)))
        mesh_lib.activate(mesh)
        return mesh
    yield activate
    mesh_lib.deactivate()


def _spied(monkeypatch):
    """Record the inputs of every port exchange: ``{kind: [[per peer], ...]}``."""
    calls = {"all_to_all": [], "all_gather": []}
    for kind in calls:
        real = getattr(exchange, kind)

        def wrapped(xs, _real=real, _kind=kind):
            calls[_kind].append([x.detach().clone() for x in xs])
            return _real(xs)
        monkeypatch.setattr(exchange, kind, wrapped)
    return calls


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_manual_ep_matches_reference(case, ref_ep, on_mesh, monkeypatch):
    ci = CASES.index(case)
    dp, tp = case["mesh"]
    on_mesh(case["mesh"])
    calls = _spied(monkeypatch)
    x = torch.tensor(_inputs()["x"])
    assert ffn._can_manual_ep(_cfg(case), x)
    y = ffn.moe_manual_ep(_port_params(case["n_shared"]), x, _cfg(case))
    # three all-to-alls (rows, local-expert ids, outputs) and one
    # all-gather per data group, in that order
    assert len(calls["all_to_all"]) == 3 * dp and len(calls["all_gather"]) == dp
    for d in range(dp):
        for g in range(tp):
            for i in range(3):
                want = ref_ep[f"{ci}/all_to_all{i}/{d}/{g}"]
                got = calls["all_to_all"][3 * d + i][g].numpy()
                what = f"{_case_id(case)} peer ({d}, {g}) exchange {i}"
                if i < 2:   # send rows and send_le: the routing plan
                    np.testing.assert_array_equal(got, want, err_msg=what)
                else:
                    np.testing.assert_allclose(got, want, **EP_TOL, err_msg=what)
            np.testing.assert_allclose(
                calls["all_gather"][d][g].numpy(),
                ref_ep[f"{ci}/all_gather0/{d}/{g}"], **EP_TOL)
    np.testing.assert_allclose(y.numpy(), ref_ep[f"{ci}/y"], **EP_TOL)


def test_capacity_drops_tokens_in_some_case(ref_ep):
    """The 1.25 cases drop: stage-1 send ids hold fewer live slots than the
    K·Ts token-slots routed (the test data reach the overflow path)."""
    dropped = 0
    for ci, c in enumerate(CASES):
        if c["cf"] != 1.25:
            continue
        dp, tp = c["mesh"]
        e_loc = -(-E // tp)
        live = sum(int((ref_ep[f"{ci}/all_to_all1/{d}/{g}"] < e_loc).sum())
                   for d in range(dp) for g in range(tp))
        dropped += B * S * K - live
    assert dropped > 0


@pytest.mark.parametrize("case", GRAD_CASES, ids=_case_id)
def test_manual_ep_grads_match_reference(case, ref_ep, on_mesh):
    gi = GRAD_CASES.index(case)
    on_mesh(case["mesh"])
    p = _port_params(case["n_shared"], requires_grad=True)
    x = torch.tensor(_inputs()["x"], requires_grad=True)
    ct = torch.tensor(_inputs()["ct"])
    y = ffn.moe_manual_ep(p, x, _cfg(case))
    paths, leaves = tree_flatten_with_paths(p)
    grads = torch.autograd.grad((y * ct).sum(), leaves + [x])
    np.testing.assert_allclose(grads[-1].numpy(), ref_ep[f"g{gi}/x"], **F32_TOL)
    for path, g in zip(paths, grads):
        np.testing.assert_allclose(g.numpy(), ref_ep[f"g{gi}/p/{path}"],
                                   **F32_TOL, err_msg=path)


@pytest.mark.parametrize("shape", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_manual_ep_without_drops_equals_moe(shape, on_mesh):
    case = dict(mesh=shape, softmax=False, n_shared=1, cf=16.0)
    p, x = _port_params(1), torch.tensor(_inputs()["x"])
    want = ffn.moe(p, x, _cfg(case))
    on_mesh(shape)
    assert ffn._can_manual_ep(_cfg(case), x)
    got = ffn.forward(p, x, _cfg(case))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)


def test_manual_ep_casts_weights_to_the_input_dtype(on_mesh):
    """At bf16 the router and the experts run in ``x``'s dtype (the
    reference casts them before the body), so an f32 master copy gives a
    bf16 output."""
    case = dict(mesh=(1, 4), softmax=True, n_shared=0, cf=8.0)
    on_mesh((1, 4))
    y = ffn.moe_manual_ep(_port_params(0), torch.tensor(_inputs()["x"]).bfloat16(),
                          _cfg(case))
    assert y.dtype == torch.bfloat16 and torch.isfinite(y.float()).all()


def test_forward_dispatch_follows_the_reference_rule(on_mesh):
    """No mesh, a model axis of 1, a manual-DP body, or too few tokens per
    peer: ``moe``; else manual EP."""
    cfg, x = _cfg(dict(softmax=True, n_shared=0, cf=1.25)), torch.zeros(B, S, D)
    assert not ffn._can_manual_ep(cfg, x)
    on_mesh((4, 1))
    assert not ffn._can_manual_ep(cfg, x)
    mesh_lib.activate(mesh_lib.make_host_mesh((1, 4), devices=["cpu"] * 4))
    assert ffn._can_manual_ep(cfg, x)
    # 4 tokens over 4 peers: one token, K = 2 slots, fewer than 4 peers
    assert not ffn._can_manual_ep(cfg, torch.zeros(B, 1, D))
    common.CTX.manual_dp = True
    try:
        assert not ffn._can_manual_ep(cfg, x)
    finally:
        common.CTX.manual_dp = False


def test_shard_is_identity_under_a_mesh(on_mesh):
    on_mesh((2, 2))
    x = torch.arange(12.0).reshape(3, 4)
    assert common.shard(x, "batch", "embed") is x


def test_host_mesh_peer_grid():
    """Peers in row-major order: data index major, model index minor."""
    mesh = mesh_lib.make_host_mesh((2, 4), devices=[f"cpu:{i}" for i in range(8)])
    grid = mesh.grid(("data",))
    assert [[d.index for d in row] for row in grid] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert [[d.index for d in row] for row in mesh.grid(("model",))] == [
        [0, 4], [1, 5], [2, 6], [3, 7]]
    assert [d.index for d in ts.worker_devices(mesh)] == [0, 4]


def test_exchanges_follow_lax_semantics():
    xs = [torch.arange(8.0).reshape(4, 2) + 100 * j for j in range(2)]
    out = exchange.all_to_all(xs)
    # peer i: chunk i of peer 0, then chunk i of peer 1
    np.testing.assert_array_equal(out[0].numpy(), np.concatenate(
        [xs[0][:2].numpy(), xs[1][:2].numpy()]))
    np.testing.assert_array_equal(out[1].numpy(), np.concatenate(
        [xs[0][2:].numpy(), xs[1][2:].numpy()]))
    gathered = exchange.all_gather(xs)
    assert all(torch.equal(g, torch.cat(xs)) for g in gathered)
    summed = exchange.all_reduce(xs)
    assert all(torch.equal(s, xs[0] + xs[1]) for s in summed)
    with pytest.raises(ValueError):
        exchange.all_to_all([torch.zeros(3, 2), torch.zeros(3, 2)])


def test_exchange_counters_and_symmetric_peers():
    exchange.reset_counts()
    xs = [torch.zeros(8, 3) for _ in range(4)]
    exchange.all_to_all(xs)
    exchange.all_gather(xs)
    c = exchange.counts()
    assert c == {"all-to-all": {"count": 1, "bytes": 96},
                 "all-gather": {"count": 1, "bytes": 384}}
    # symmetric peers run peer 0 alone on meta, weighed by the peer count
    seen = []
    metas = [torch.empty(8, 3, device="meta")] * 4
    with exchange.symmetric_peers():
        out = exchange.map_peers(lambda t: seen.append(exchange.PEER_WEIGHT) or t,
                                 metas)
        cpu = exchange.map_peers(lambda t: t, xs)
    assert seen == [4] and len(out) == 4 and exchange.PEER_WEIGHT == 1
    assert all(a is b for a, b in zip(cpu, xs))
    exchange.reset_counts()


# ===========================================================================
# training under a (data, model) mesh
# ===========================================================================

REF_STEP = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp
import numpy as np
from repro import configs as jconfigs
from repro.launch import mesh as mesh_lib
from repro.models import get_model
from repro.train import optimizer as jopt
from repro.train import train_step as jts

src, dst, names = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
data = dict(np.load(src))
mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
mesh_lib.activate(mesh)
out = {}
for name in names:
    cfg = dataclasses.replace(jconfigs.reduced(jconfigs.ARCHS[name]),
                              compute_dtype=jnp.float32)
    m = get_model(cfg)
    params, _ = m.init(jax.random.PRNGKey(0))
    batch = {"tokens": jnp.asarray(data[name + "/tokens"])}
    loss, g = jax.jit(jax.value_and_grad(m.loss_fn))(params, batch)
    out[name + "/loss"] = np.asarray(loss)
    for path, leaf in jax.tree_util.tree_flatten_with_path(g)[0]:
        out[name + "/g/" + jax.tree_util.keystr(path)] = np.asarray(leaf)
    step = jax.jit(jts.make_train_step(m, jopt.AdamWConfig(), mode="gspmd"))
    st, met = step(jts.init_state(params), batch)
    out[name + "/step_loss"] = np.asarray(met["loss"])
    for path, leaf in jax.tree_util.tree_flatten_with_path(st.params)[0]:
        out[name + "/p/" + jax.tree_util.keystr(path)] = np.asarray(leaf)
np.savez(dst, **out)
"""


def _tokens(name):
    cfg = configs.reduced(configs.ARCHS[name])
    return np.random.default_rng(1).integers(0, cfg.vocab, (B, S)).astype(np.int32)


@pytest.fixture(scope="module")
def ref_steps(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("step")
    np.savez(tmp / "in.npz", **{n + "/tokens": _tokens(n) for n in STEP_ARCHS})
    _run(REF_STEP, tmp, tmp / "in.npz", tmp / "out.npz", json.dumps(STEP_ARCHS))
    return dict(np.load(tmp / "out.npz"))


@functools.lru_cache(maxsize=None)
def _ref_params(name):
    params, _ = jget_model(jconfigs.reduced(jconfigs.ARCHS[name])).init(
        jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def _keyed(tree, ref_keys):
    """The port tree's leaves in jax's order, against the reference's
    ``keystr`` paths (the same order)."""
    leaves = tree_flatten_with_paths(tree)[1]
    assert len(leaves) == len(ref_keys)
    return zip(ref_keys, leaves)


@pytest.mark.parametrize("name", STEP_ARCHS)
def test_gspmd_step_on_2x2_mesh_matches_reference(name, ref_steps, on_mesh,
                                                  monkeypatch):
    cfg = dataclasses.replace(configs.reduced(configs.ARCHS[name]),
                              compute_dtype=torch.float32)
    model = get_model(cfg)
    params = convert.params_from_arrays(_ref_params(name), device="cpu")
    batch = {"tokens": torch.tensor(_tokens(name))}
    on_mesh((2, 2))
    calls = _spied(monkeypatch)
    loss, grads = ts.value_and_grad(model.loss_fn, params, batch)
    n_moe = sum(c for c, kind in transformer.layer_groups(cfg) if kind == "moe")
    # manual EP ran in every MoE layer: 3 all-to-alls per data group, in the
    # forward and again in remat's recomputation
    assert len(calls["all_to_all"]) == 2 * 3 * 2 * n_moe
    np.testing.assert_allclose(float(loss), float(ref_steps[name + "/loss"]),
                               **F32_TOL)
    gkeys = [k for k in ref_steps if k.startswith(name + "/g/")]
    for k, g in _keyed(grads, gkeys):
        np.testing.assert_allclose(g.numpy(), ref_steps[k], **F32_TOL, err_msg=k)
    state, m = ts.make_train_step(model, opt.AdamWConfig())(
        ts.init_state(params), batch)
    np.testing.assert_allclose(float(m["loss"]),
                               float(ref_steps[name + "/step_loss"]), **F32_TOL)
    pkeys = [k for k in ref_steps if k.startswith(name + "/p/")]
    for k, p in _keyed(state.params, pkeys):
        np.testing.assert_allclose(p.numpy(), ref_steps[k], **F32_TOL, err_msg=k)


@pytest.mark.parametrize("name", ["smollm-360m", "granite-moe-3b-a800m"])
def test_hom_on_2x2_equals_2x1_bitwise(name):
    """The hom step splits the batch over ``data`` only, and the worker body
    sets ``CTX.manual_dp``: no expert parallelism, so a (2, 2) mesh gives
    the (2, 1) mesh's bits."""
    cfg = dataclasses.replace(configs.reduced(configs.ARCHS[name]),
                              compute_dtype=torch.float32)
    model = get_model(cfg)
    params = convert.params_from_arrays(_ref_params(name), device="cpu")
    batch = {"tokens": torch.tensor(_tokens(name))}
    out = {}
    for shape in ((2, 1), (2, 2)):
        mesh = mesh_lib.make_host_mesh(shape, devices=["cpu"] * int(np.prod(shape)))
        mesh_lib.activate(mesh)
        try:
            step = ts.make_train_step(model, opt.AdamWConfig(), mode="hom",
                                      mesh=mesh)
            state = ts.init_state(params, hom_mode=True, mesh=mesh)
            for _ in range(2):
                state, m = step(state, batch)
        finally:
            mesh_lib.deactivate()
        out[shape] = (state, m)
    (s1, m1), (s2, m2) = out[(2, 1)], out[(2, 2)]
    assert float(m1["loss"]) == float(m2["loss"])
    for a, b in zip(tree_flatten_with_paths(s1)[1], tree_flatten_with_paths(s2)[1]):
        assert torch.equal(a, b)
