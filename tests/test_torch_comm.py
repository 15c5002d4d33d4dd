"""The port's compressed collectives (``repro_torch.comm``) and training
host mesh against the JAX reference (``repro.comm``).

One controller drives every worker in the port: a worker axis is a list,
worker ``w``'s tensors on ``mesh.devices[w]`` (here ``["cpu"] * world``).
World 1 runs the reference in process under ``shard_map``; world 8 runs it
in a subprocess with 8 host devices (the XLA device count is fixed at the
first jax init), fed and read back through an ``.npz``.  What is held:

* ``compressed_psum_tree``: means and every worker's residual **bitwise**
  the reference's on the same per-worker gradients and residuals, at world
  1 (two rounds, the residual carried) and 8; worker 0's residual tree
  equals what the reference's host reads from a residual returned under
  ``out_specs=P()``; the mean within the per-worker eps bound of
  ``tests/test_comm.py`` of the exact mean;
* ``packed_allgather`` **bitwise** at bits 4, 8, 12, 15 and n 33, 96, 97
  (world 1) and at bits 8 and 12 over 8 workers;
* ``bit_budget`` equal over world 1–512, and the int16 sum of every
  worker's clipping bound exact (no wrap);
* ``stage1_stats`` within rtol 1e-5 of the reference's;
* ``make_host_mesh``'s placement rules.

The reference's compiled collective arithmetic is what the port mirrors
(XLA multiplies by the f32 reciprocal of ``qmax`` and ``world`` and
contracts the residual into a fused multiply-add), so the bits match.
"""
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import compat
from repro.comm import hom_collectives as jhom
from repro.launch.mesh import auto_axis_types
from repro_torch.comm import PerWorker, hom_collectives as hom
from repro_torch.launch.mesh import HostMesh, make_host_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8
GATHER_BITS = (8, 12)

SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.comm import hom_collectives as hom
from repro.launch.mesh import auto_axis_types

src, dst = sys.argv[1], sys.argv[2]
data = dict(np.load(src))
mesh = jax.make_mesh((8,), ("data",), **auto_axis_types(1))
keys = ("a", "b")
grads = {k: jnp.asarray(data["g_" + k][:, 0]) for k in keys}     # (8, ...)
resid = {k: jnp.asarray(data["r_" + k][:, 0]) for k in keys}

def body(g, r):
    local = {k: v[0] for k, v in g.items()}
    res = {k: v[0] for k, v in r.items()}
    mean, new_r = hom.compressed_psum_tree(local, res, "data", 8)
    return mean, {k: v[None] for k, v in new_r.items()}

spec = {k: P("data") for k in keys}
out = {}
f = compat.shard_map(body, mesh=mesh, in_specs=(spec, spec),
                     out_specs=({k: P() for k in keys}, spec), check=False)
mean, per_worker = jax.jit(f)(grads, resid)
# the host's read of a residual returned under out_specs=P()
h = compat.shard_map(body, mesh=mesh, in_specs=(spec, spec),
                     out_specs=({k: P() for k in keys},
                                {k: P() for k in keys}), check=False)
_, host = jax.jit(h)(grads, resid)
for k in keys:
    out["mean_" + k] = np.asarray(mean[k])
    out["res_" + k] = np.asarray(per_worker[k])
    out["host_" + k] = np.asarray(host[k])[0]
for bits in (8, 12):
    g = compat.shard_map(lambda xs: hom.packed_allgather(xs[0], "data", bits=bits),
                         mesh=mesh, in_specs=(P("data"),), out_specs=P(),
                         check=False)
    out[f"gather_{bits}"] = np.asarray(jax.jit(g)(jnp.asarray(data["x"])))
np.savez(dst, **out)
"""


def _world8_inputs():
    rng = np.random.default_rng(0)
    return {
        "g_a": rng.normal(0, 1e-3, (WORLD, 1, 64, 32)).astype(np.float32),
        "g_b": rng.normal(0, 3e-4, (WORLD, 1, 128)).astype(np.float32),
        "r_a": rng.normal(0, 1e-6, (WORLD, 1, 64, 32)).astype(np.float32),
        "r_b": rng.normal(0, 1e-7, (WORLD, 1, 128)).astype(np.float32),
        "x": rng.normal(0, 1.0, (WORLD, 1, 97)).astype(np.float32),
    }


@pytest.fixture(scope="module")
def world8(tmp_path_factory):
    """(inputs, the reference's outputs) of the world-8 subprocess."""
    tmp = tmp_path_factory.mktemp("comm8")
    inputs = _world8_inputs()
    np.savez(tmp / "in.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp / "in.npz"),
                        str(tmp / "out.npz")], capture_output=True, text=True,
                       env=env, cwd=ROOT, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return inputs, dict(np.load(tmp / "out.npz"))


def _cpu_mesh(world):
    return make_host_mesh(devices=["cpu"] * world)


def _port_psum(inputs):
    grads = [{k: torch.as_tensor(inputs["g_" + k][w, 0]) for k in "ab"}
             for w in range(WORLD)]
    res = [{k: torch.as_tensor(inputs["r_" + k][w, 0]) for k in "ab"}
           for w in range(WORLD)]
    return hom.compressed_psum_tree(grads, res, _cpu_mesh(WORLD), WORLD)


def _world1_mesh():
    return jax.make_mesh((1,), ("data",), **auto_axis_types(1))


# ===========================================================================
# compressed psum
# ===========================================================================

def test_compressed_psum_world1_bitwise_over_two_rounds():
    rng = np.random.default_rng(7)
    grads = {"w": rng.normal(0, 1e-3, (64, 32)).astype(np.float32),
             "b": rng.normal(0, 3e-4, (128,)).astype(np.float32)}
    specs = {"w": P(), "b": P()}
    f = jax.jit(compat.shard_map(
        lambda g, r: jhom.compressed_psum_tree(g, r, "data", world=1),
        mesh=_world1_mesh(), in_specs=(specs, specs),
        out_specs=(specs, specs), check=False))
    j_res = {k: np.zeros_like(v) for k, v in grads.items()}
    t_res = None
    tg = [{k: torch.as_tensor(v) for k, v in grads.items()}]
    for _ in range(2):
        j_mean, j_res = f(grads, j_res)
        t_mean, t_res = hom.compressed_psum_tree(tg, t_res, _cpu_mesh(1), 1)
        assert isinstance(t_res, PerWorker) and len(t_res) == 1
        for k in grads:
            np.testing.assert_array_equal(t_mean[k].numpy(), np.asarray(j_mean[k]))
            np.testing.assert_array_equal(t_res[0][k].numpy(), np.asarray(j_res[k]))
        j_res = {k: np.asarray(v) for k, v in j_res.items()}


def test_compressed_psum_world8_bitwise(world8):
    inputs, ref = world8
    mean, res = _port_psum(inputs)
    for k in "ab":
        np.testing.assert_array_equal(mean[k].numpy(), ref["mean_" + k])
        for w in range(WORLD):
            np.testing.assert_array_equal(res[w][k].numpy(),
                                          ref["res_" + k][w])


def test_host_reads_worker0_residual(world8):
    """What the reference's host reads from a per-device residual returned
    under ``out_specs=P()`` is device 0's buffer: the port's worker 0."""
    inputs, ref = world8
    _, res = _port_psum(inputs)
    for k in "ab":
        np.testing.assert_array_equal(res[0][k].numpy(), ref["host_" + k])
        assert not np.array_equal(ref["res_" + k][1], ref["host_" + k])


def test_compressed_psum_error_bounded():
    """``tests/test_comm.py``'s bound on the port: zero residuals, the mean
    within one per-worker eps of the exact mean, residuals finite."""
    inputs = _world8_inputs()
    inputs.update(r_a=np.zeros_like(inputs["r_a"]), r_b=np.zeros_like(inputs["r_b"]))
    mean, res = _port_psum(inputs)
    qmax = 2 ** (hom.bit_budget(WORLD) - 1) - 1
    for k in "ab":
        g = inputs["g_" + k][:, 0]
        bound = np.abs(g).max() / qmax
        assert np.abs(mean[k].numpy() - g.mean(axis=0)).max() <= bound
        assert all(torch.isfinite(r[k]).all() for r in res)


# ===========================================================================
# packed all-gather
# ===========================================================================

@pytest.mark.parametrize("bits", [4, 8, 12, 15])
@pytest.mark.parametrize("n", [96, 97, 33])
def test_packed_allgather_world1_bitwise(bits, n):
    qmax = 2 ** (bits - 1) - 1
    rng = np.random.default_rng(bits * 100 + n)
    q = rng.integers(-qmax, qmax + 1, size=n)
    q[0] = qmax
    f = jax.jit(compat.shard_map(
        lambda xs: jhom.packed_allgather(xs[0], "data", bits=bits),
        mesh=_world1_mesh(), in_specs=(P("data"),), out_specs=P(), check=False))
    for x in (q.astype(np.float32), rng.normal(0, 1.0, n).astype(np.float32)):
        want = np.asarray(f(jnp.asarray(x).reshape(1, 1, n)))
        got = hom.packed_allgather([torch.as_tensor(x).reshape(1, n)],
                                   _cpu_mesh(1), bits)
        assert got.shape == want.shape == (1, 1, n)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bits", GATHER_BITS)
def test_packed_allgather_world8_bitwise(world8, bits):
    inputs, ref = world8
    xs = [torch.as_tensor(inputs["x"][w]) for w in range(WORLD)]
    got = hom.packed_allgather(xs, _cpu_mesh(WORLD), bits)
    assert got.shape == ref[f"gather_{bits}"].shape == (WORLD, 1, 97)
    np.testing.assert_array_equal(got.numpy(), ref[f"gather_{bits}"])
    # within half a bin of every source value
    delta = np.abs(inputs["x"]).max() / (2 ** (bits - 1) - 1)
    assert np.abs(got.numpy() - inputs["x"]).max() <= delta * 0.5 * 1.01


# ===========================================================================
# the bit budget
# ===========================================================================

@pytest.mark.parametrize("world", [1, 2, 3, 8, 100, 256, 511, 512])
def test_bit_budget_int16_sum_never_wraps(world):
    """The budget equals the reference's, and ``world`` workers each at the
    clipping bound sum exactly in the int16 container."""
    bits = hom.bit_budget(world)
    assert bits == jhom.bit_budget(world)
    assert hom.worst_case_psum(world) == jhom.worst_case_psum(world)
    assert hom.worst_case_psum(world) <= hom.PSUM_CONTAINER_MAX
    vs = [torch.full((3,), 1.0)] * world    # every worker at max|v|
    summed, _ = hom._leaf_compressed_psum(vs, bits)
    delta = hom._shared_delta(vs, float(2 ** (bits - 1) - 1))
    qsum = torch.round(summed / delta)
    assert torch.equal(qsum, torch.full((3,), float(world * (2 ** (bits - 1) - 1))))


def test_bit_budget_over_every_supported_world():
    for world in range(1, 513):
        assert hom.bit_budget(world) == jhom.bit_budget(world)
        assert hom.worst_case_psum(world) == jhom.worst_case_psum(world) < 2 ** 15


# ===========================================================================
# stage-1 telemetry, residual init
# ===========================================================================

def test_stage1_stats_matches_reference():
    rng = np.random.default_rng(3)
    tree = {"w": rng.normal(0.1, 2.0, (513, 37)).astype(np.float32),
            "b": rng.normal(-1, 0.5, (1000,)).astype(np.float32),
            "a": [rng.normal(0, 1e-3, (4096 * 2 + 5,)).astype(np.float32)]}
    for block in (256, 4096):
        want = jhom.stage1_stats(jax.tree.map(jnp.asarray, tree), block=block)
        got = hom.stage1_stats(jax.tree.map(torch.as_tensor, tree), block=block)
        assert set(got) == set(want) == {"mean", "rms", "std", "norm"}
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5)
    flat = np.concatenate([np.ravel(v) for v in jax.tree.leaves(tree)])
    got = hom.stage1_stats(jax.tree.map(torch.as_tensor, tree))
    np.testing.assert_allclose(float(got["mean"]), flat.mean(), rtol=1e-4)
    np.testing.assert_allclose(float(got["norm"]), np.linalg.norm(flat), rtol=1e-4)


def test_init_residuals_zero_f32_like_params():
    params = {"w": torch.ones((3, 4), dtype=torch.bfloat16), "b": [torch.ones(5)]}
    r = hom.init_residuals(params)
    assert r["w"].dtype == torch.float32 and r["w"].shape == (3, 4)
    assert float(r["b"][0].abs().sum()) == 0.0


# ===========================================================================
# the host mesh
# ===========================================================================

def test_make_host_mesh_device_lists():
    m = make_host_mesh(devices=["cpu"] * 4)
    assert isinstance(m, HostMesh)
    assert m.shape == {"data": 4, "model": 1} and m.size == 4
    assert m.axis_names == ("data", "model")
    assert all(d == torch.device("cpu") for d in m.devices)
    assert make_host_mesh((2, 1), devices=["cpu", "cpu"]).shape["data"] == 2
    # a model axis > 1 is taken (manual expert parallelism), in row-major
    # order over (data, model)
    m = make_host_mesh((2, 2), devices=["cpu"] * 4)
    assert m.shape == {"data": 2, "model": 2} and m.size == 4
    with pytest.raises(ValueError):
        make_host_mesh((3, 1), devices=["cpu"] * 4)
    with pytest.raises(ValueError):
        make_host_mesh(devices=[])


def test_make_host_mesh_takes_cards_by_default():
    """Without ``devices`` the mesh takes the CUDA cards and never the CPU:
    without a card it raises."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        with pytest.raises(ValueError):
            make_host_mesh()
    else:
        assert make_host_mesh().shape["data"] == n
        assert math.prod(make_host_mesh().axis_sizes) == n
