"""The port's mesh layer, dry run, op counter and roofline
(``repro_torch.launch.{mesh,dryrun,op_analysis,roofline}``,
``repro_torch.examples.hom_sync_bench``) against the JAX reference.

The reference runs in subprocesses with
``--xla_force_host_platform_device_count=512`` (its production meshes need
the devices).  What is held:

* the mirrors of ``tests/test_mesh_dryrun.py``'s cell-support matrix and
  divisibility fallback;
* for all ten archs x {16x16, 2x16x16} x ``seq_shard`` {off, on}: every
  param leaf's partition spec and per-device shard shape **equal** the
  reference's ``tree_shardings`` / ``NamedSharding.shard_shape``, and the
  summed per-device param bytes equal; the same for every cell's
  ``input_specs`` under ``batch_shardings`` and every decode cell's cache
  under ``cache_specs``;
* the dry run against the reference's compiled cells (``smollm-360m`` x
  ``decode_32k`` / ``prefill_32k`` / ``train_4k`` on 16x16):
  ``argument_bytes`` and ``alias_bytes`` **equal**; ``output_bytes`` equal
  up to XLA's output tuple, 8 bytes per output leaf (the pinned
  difference); on a (1, 1) mesh (the reference's ``make_production_mesh``
  monkeypatched) the per-device ``dot_flops`` is the global count, and the
  port's **equals** it for decode and train; for prefill it exceeds it by
  exactly one q / k / v projection per layer (2·T·D·(h + 2·kv)·hd: the
  cache's second projection computes q, k and v eagerly, where XLA drops
  the unused q and merges k, v with the attention's own, 2.1 % here);
* every ``--all`` cell's status equals ``cell_supported`` (the meta step
  replaced by a stub except for a few cells), a failed cell makes the CLI
  exit non-zero;
* ``roofline.analyze_record`` equals the reference's with its constants
  set to the port's;
* the op counter on known programs, and the dry run's symmetric peers
  against the full per-peer loop (equal counts);
* the hom sync bench's wire bytes.
"""
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from repro.launch import roofline as jroofline
from repro_torch.comm import exchange
from repro_torch.configs import ARCHS, SHAPES, ShapeConfig, cell_supported, reduced
from repro_torch.examples import hom_sync_bench
from repro_torch.launch import dryrun, mesh as mesh_lib, op_analysis, roofline
from repro_torch.models import get_model, input_specs
from repro_torch.models.common import tree_flatten_with_paths, tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"16x16": False, "2x16x16": True}
ALL_ARCHS = list(ARCHS)
DECODE_CELLS = [(a, s) for a in ALL_ARCHS for s in SHAPES
                if SHAPES[s].kind == "decode" and cell_supported(ARCHS[a], SHAPES[s])[0]]
DRY_CELLS = ["decode_32k", "prefill_32k", "train_4k"]


def _run(script, *args, timeout=900):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", script, *map(str, args)],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=timeout)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def _spec_json(spec) -> list:
    """A partition spec as JSON, trailing ``None``s dropped (jax treats
    them as absent)."""
    out = [list(a) if isinstance(a, tuple) else a for a in spec]
    while out and out[-1] is None:
        out.pop()
    return out


# ===========================================================================
# mirrors of tests/test_mesh_dryrun.py
# ===========================================================================

def test_cell_support_matrix():
    """long_500k runs only for sub-quadratic families (DESIGN.md §4)."""
    runnable = {a for a in ARCHS
                if cell_supported(ARCHS[a], SHAPES["long_500k"])[0]}
    assert runnable == {"falcon-mamba-7b", "recurrentgemma-9b"}
    for a in ARCHS:
        for s in ("train_4k", "prefill_32k", "decode_32k"):
            assert cell_supported(ARCHS[a], SHAPES[s])[0]


def test_divisibility_fallback_rules():
    """Non-divisible dims fall back to replication, never error."""
    mesh = mesh_lib.make_host_mesh((1, 1), devices=["meta"])
    rules = mesh_lib.logical_rules(mesh)
    s = mesh_lib.spec_to_sharding(mesh, ("vocab", "embed"), (15, 7), rules)
    assert s.spec is not None  # resolved without exception
    pm = mesh_lib.make_production_mesh()
    rules = mesh_lib.logical_rules(pm)
    # 15 does not split over model (16): replicated; 32 splits over data
    s = mesh_lib.spec_to_sharding(pm, ("vocab", "embed_w"), (15, 32), rules)
    assert s.spec == (None, "data") and s.shard_shape((15, 32)) == (15, 2)
    # an axis shards only one dim: heads and kv_heads both map to model
    s = mesh_lib.spec_to_sharding(pm, ("heads", "kv_heads"), (16, 16), rules)
    assert s.spec == ("model", None)


def test_production_mesh_is_logical():
    for mp, shape, axes in ((False, (16, 16), ("data", "model")),
                            (True, (2, 16, 16), ("pod", "data", "model"))):
        m = mesh_lib.make_production_mesh(multi_pod=mp)
        assert m.axis_sizes == shape and m.axis_names == axes
        assert m.size == math.prod(shape) and m.shape == dict(zip(axes, shape))
        assert all(d.type == "meta" for d in m.devices)


def test_batch_shardings_pod_fallback():
    """A batch that does not split over (pod, data) falls back to data."""
    m = mesh_lib.make_production_mesh(multi_pod=True)
    sh = mesh_lib.batch_shardings(m, {
        "a": torch.empty(64, 3, device="meta"),      # 64 % 32 == 0
        "b": torch.empty(48, 3, device="meta"),      # 48 % 16 == 0 only
        "c": torch.empty(5, 3, device="meta"),       # neither
        "d": torch.empty((), device="meta")})
    assert sh["a"].spec == (("pod", "data"), None)
    assert sh["b"].spec == ("data", None)
    assert sh["c"].spec == (None, None) and sh["d"].spec == ()


# ===========================================================================
# shardings against the reference
# ===========================================================================

REF_SHARDINGS = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax
import numpy as np
from jax.sharding import NamedSharding
from repro.configs import ARCHS, SHAPES, cell_supported
from repro.launch import mesh as mesh_lib
from repro.models import get_model, input_specs

is_sh = lambda x: isinstance(x, NamedSharding)


def path_str(path):
    out = []
    for k in path:
        if hasattr(k, "key"):
            out.append(str(k.key))
        elif hasattr(k, "idx"):
            out.append(str(k.idx))
        else:
            out.append("." + k.name)
    return "/".join(out)


def spec_json(spec):
    out = [list(a) if isinstance(a, tuple) else a for a in spec]
    while out and out[-1] is None:
        out.pop()
    return out


def table(shardings, shapes):
    sh = jax.tree_util.tree_flatten_with_path(shardings, is_leaf=is_sh)[0]
    leaves = jax.tree.leaves(shapes)
    return {path_str(p): [spec_json(s.spec), list(s.shard_shape(l.shape))]
            for (p, s), l in zip(sh, leaves)}


out = {"params": {}, "bytes": {}, "batch": {}, "cache": {}}
for mp, mname in ((False, "16x16"), (True, "2x16x16")):
    mesh = mesh_lib.make_production_mesh(multi_pod=mp)
    for arch, cfg in ARCHS.items():
        model = get_model(cfg)
        params, specs = model.init(None)
        for seq in (False, True):
            sh = mesh_lib.tree_shardings(mesh, specs, params, seq_shard=seq)
            out["params"][f"{arch}|{mname}|{seq}"] = table(sh, params)
            if not seq:
                out["bytes"][f"{arch}|{mname}"] = int(sum(
                    int(np.prod(s.shard_shape(l.shape))) * l.dtype.itemsize
                    for s, l in zip(jax.tree.leaves(sh, is_leaf=is_sh),
                                    jax.tree.leaves(params))))
        for sname, shape in SHAPES.items():
            specs_in = input_specs(cfg, shape)
            out["batch"][f"{arch}|{sname}|{mname}"] = table(
                mesh_lib.batch_shardings(mesh, specs_in), specs_in)
            if shape.kind != "decode" or not cell_supported(cfg, shape)[0]:
                continue
            B, S = shape.global_batch, shape.seq_len
            cache = jax.eval_shape(lambda: model.init_cache(B, S))
            for seq in (False, True):
                sh = mesh_lib.tree_shardings(mesh, model.cache_specs(B, S), cache,
                                             seq_shard=seq)
                out["cache"][f"{arch}|{sname}|{mname}|{seq}"] = table(sh, cache)
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def ref_shardings(tmp_path_factory):
    path = tmp_path_factory.mktemp("sh") / "ref.json"
    _run(REF_SHARDINGS, path)
    with open(path) as f:
        return json.load(f)


def _table(shardings, tree) -> dict:
    paths, leaves = tree_flatten_with_paths(tree)
    shs = tree_flatten_with_paths(shardings)[1]
    assert len(shs) == len(leaves)
    return {p: [_spec_json(s.spec), list(s.shard_shape(tuple(l.shape)))]
            for p, s, l in zip(paths, shs, leaves)}


@pytest.mark.parametrize("seq", [False, True], ids=["seq_off", "seq_on"])
@pytest.mark.parametrize("mname", list(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_shardings_match_reference(arch, mname, seq, ref_shardings):
    mesh = mesh_lib.make_production_mesh(multi_pod=MESHES[mname])
    params, specs = get_model(ARCHS[arch]).init(None)
    sh = mesh_lib.tree_shardings(mesh, specs, params, seq_shard=seq)
    assert _table(sh, params) == ref_shardings["params"][f"{arch}|{mname}|{seq}"]
    if not seq:
        got = sum(s.shard_nbytes(l) for s, l in
                  zip(tree_leaves(sh), tree_leaves(params)))
        assert got == ref_shardings["bytes"][f"{arch}|{mname}"]


def test_per_device_param_bytes_figures(ref_shardings):
    """The figures the dry run starts from: smollm's 0.016 GiB, deepseek's
    10.898, and granite-3-2b above qwen3-4b (its vocab of 49155 does not
    split over model, so the fallback replicates it)."""
    gib = {a: ref_shardings["bytes"][f"{a}|16x16"] / 2**30 for a in ALL_ARCHS}
    assert round(gib["smollm-360m"], 3) == 0.016
    assert round(gib["deepseek-v3-671b"], 3) == 10.898
    assert round(gib["granite-3-2b"], 3) == 0.434
    assert gib["granite-3-2b"] > gib["qwen3-4b"]


@pytest.mark.parametrize("mname", list(MESHES))
@pytest.mark.parametrize("sname", list(SHAPES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_batch_shardings_match_reference(arch, sname, mname, ref_shardings):
    mesh = mesh_lib.make_production_mesh(multi_pod=MESHES[mname])
    specs = input_specs(ARCHS[arch], SHAPES[sname])
    sh = mesh_lib.batch_shardings(mesh, specs)
    assert _table(sh, specs) == ref_shardings["batch"][f"{arch}|{sname}|{mname}"]


@pytest.mark.parametrize("seq", [False, True], ids=["seq_off", "seq_on"])
@pytest.mark.parametrize("mname", list(MESHES))
@pytest.mark.parametrize("cell", DECODE_CELLS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_cache_shardings_match_reference(cell, mname, seq, ref_shardings):
    arch, sname = cell
    mesh = mesh_lib.make_production_mesh(multi_pod=MESHES[mname])
    model = get_model(ARCHS[arch])
    B, S = SHAPES[sname].global_batch, SHAPES[sname].seq_len
    cache = model.init_cache(B, S, device="meta")
    sh = mesh_lib.tree_shardings(mesh, model.cache_specs(B, S), cache,
                                 seq_shard=seq)
    assert _table(sh, cache) == ref_shardings["cache"][f"{arch}|{sname}|{mname}|{seq}"]


# ===========================================================================
# the dry run against the reference's compiled cells
# ===========================================================================

REF_CELLS = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax
import numpy as np
from repro.launch import dryrun
from repro.launch import mesh as mesh_lib

cells = json.loads(sys.argv[2])
out = {}
for sname in cells:
    rec = dryrun.build_cell("smollm-360m", sname, multi_pod=False)
    out["16x16|" + sname] = {"memory": rec["memory"], "hlo": rec["hlo"]}
one = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
mesh_lib.make_production_mesh = lambda multi_pod=False: one
for sname in cells:
    rec = dryrun.build_cell("smollm-360m", sname, multi_pod=False)
    out["1x1|" + sname] = {"memory": rec["memory"], "hlo": rec["hlo"]}
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def ref_cells(tmp_path_factory):
    path = tmp_path_factory.mktemp("cells") / "ref.json"
    _run(REF_CELLS, path, json.dumps(DRY_CELLS))
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def port_cells():
    out = {}
    one = mesh_lib.make_host_mesh((1, 1), devices=["meta"])
    for sname in DRY_CELLS:
        out["16x16|" + sname] = dryrun.build_cell("smollm-360m", sname,
                                                  multi_pod=False)
        out["1x1|" + sname] = dryrun.build_cell("smollm-360m", sname,
                                                multi_pod=False, mesh=one)
    return out


def _n_output_leaves(sname) -> int:
    """Leaves of the reference's jitted outputs: the train state and its
    three metrics; the logits and the cache."""
    model = get_model(ARCHS["smollm-360m"])
    params, _ = model.init(None)
    n_params = len(tree_leaves(params))
    if SHAPES[sname].kind == "train":
        return 3 * n_params + 2 + 3     # params, m, v, count, step; metrics
    shape = SHAPES[sname]
    cache = model.init_cache(shape.global_batch, shape.seq_len, device="meta")
    return 1 + len(tree_leaves(cache))


@pytest.mark.parametrize("mname", ["16x16", "1x1"])
@pytest.mark.parametrize("sname", DRY_CELLS)
def test_dryrun_bytes_match_reference(sname, mname, ref_cells, port_cells):
    got = port_cells[f"{mname}|{sname}"]
    want = ref_cells[f"{mname}|{sname}"]["memory"]
    assert got["status"] == "ok", got.get("error")
    mem = got["memory"]
    assert mem["argument_bytes"] == want["argument_bytes"]
    assert mem["alias_bytes"] == want["alias_bytes"]
    # XLA's output buffer also holds the output tuple's pointer table
    assert want["output_bytes"] - mem["output_bytes"] == 8 * _n_output_leaves(sname)
    assert mem["temp_bytes"] >= 0
    assert mem["peak_per_device_gib"] == round(
        (mem["argument_bytes"] + mem["output_bytes"] + mem["temp_bytes"]
         - mem["alias_bytes"]) / 2**30, 3)


@pytest.mark.parametrize("sname", DRY_CELLS)
def test_dryrun_global_dot_flops_match_reference(sname, ref_cells, port_cells):
    got = port_cells[f"1x1|{sname}"]["hlo"]["dot_flops"]
    want = ref_cells[f"1x1|{sname}"]["hlo"]["dot_flops"]
    if sname == "prefill_32k":
        # the cache's K/V projection recomputes q, k and v in every layer
        cfg, shape = ARCHS["smollm-360m"], SHAPES[sname]
        T = shape.global_batch * shape.seq_len
        want += cfg.n_layers * 2 * T * cfg.d_model * (
            cfg.n_heads + 2 * cfg.n_kv) * cfg.head_dim
    assert got == want
    # per device on 16x16: the ideal split of the same global count
    per_dev = port_cells[f"16x16|{sname}"]["hlo"]["dot_flops"]
    assert per_dev == pytest.approx(got / 256, rel=1e-9)


def test_dryrun_record_keys(port_cells):
    rec = port_cells["16x16|train_4k"]
    for k in ("arch", "shape", "mesh", "mode", "hom_grads", "kv_quant",
              "seq_shard", "devices", "microbatch", "lower_s", "compile_s",
              "memory", "cost", "hlo", "status"):
        assert k in rec
    for k in ("dot_flops", "bytes_proxy", "collectives", "wire_bytes_total"):
        assert k in rec["hlo"]
    assert rec["mesh"] == "16x16" and rec["devices"] == 256


def test_dryrun_moe_cell_takes_expert_parallelism():
    """granite-moe prefill on 16x16 takes manual EP in the reference
    (T_loc = 2 x 32768 tokens over 16 peers): the group keeps the model
    axis and the table holds its exchanges, 3 all-to-alls and one
    all-gather per MoE layer; decode does not (8 tokens over 16 peers)."""
    cfg = ARCHS["granite-moe-3b-a800m"]
    rec = dryrun.build_cell("granite-moe-3b-a800m", "prefill_32k", multi_pod=False)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["group"] == {"mesh": "1x16", "batch": 2, "data_shards": 16,
                            "expert_parallel": True}
    coll = rec["hlo"]["collectives"]
    assert coll["all-to-all"]["count"] == 3 * cfg.n_layers
    assert coll["all-gather"]["count"] == cfg.n_layers
    rec = dryrun.build_cell("granite-moe-3b-a800m", "decode_32k", multi_pod=True)
    assert rec["status"] == "ok" and not rec["group"]["expert_parallel"]
    assert rec["hlo"]["collectives"] == {}


def test_dryrun_hom_cell_counts_the_compressed_psum():
    """hom train: per leaf one f32 pmax and one int16 psum, plus the loss's
    pmean; nothing aliased."""
    rec = dryrun.build_cell("smollm-360m", "train_4k", multi_pod=True,
                            hom_grads=True)
    assert rec["status"] == "ok", rec.get("error")
    params, _ = get_model(ARCHS["smollm-360m"]).init(None)
    n = len(tree_leaves(params))
    ar = rec["hlo"]["collectives"]["all-reduce"]
    assert ar["count"] == 2 * n + 1
    assert ar["bytes"] == 2 * sum(p.numel() for p in tree_leaves(params)) + 4 * n + 4
    assert ar["wire_bytes"] == 2 * ar["bytes"]
    assert rec["memory"]["alias_bytes"] == 0


def test_dryrun_all_statuses_and_failures(tmp_path, monkeypatch):
    """``--all`` over every cell and both meshes: each record's status is
    what ``cell_supported`` says; the meta step runs for a few cells and a
    stub stands in for the rest.  A failing cell is recorded as "failed"
    and the CLI exits 1."""
    real = dryrun.count_step
    ran = []

    def step(run, group, seq_shard, shares):
        if len(ran) < 3:
            ran.append(group)
            return real(run, group, seq_shard, shares)
        counts = {"dot_flops": 0.0, "bytes_proxy": 0.0, "collectives": {},
                  "wire_bytes_total": 0.0, "peak_live_bytes": 0.0, "ops": 0}
        return (None, {}), counts

    monkeypatch.setattr(dryrun, "count_step", step)
    monkeypatch.setattr(dryrun, "_logits_bytes", lambda *a: 0)
    out = tmp_path / "dry"
    assert dryrun.main(["--all", "--out", str(out)]) == 0
    recs = {(r["arch"], r["shape"], r["mesh"]): r["status"]
            for r in map(lambda f: json.load(open(out / f)), os.listdir(out))}
    assert len(recs) == len(ARCHS) * len(SHAPES) * 2 and len(ran) == 3
    for (arch, shape, mesh), status in recs.items():
        ok = cell_supported(ARCHS[arch], SHAPES[shape])[0]
        assert status == ("ok" if ok else "skipped"), (arch, shape, mesh)

    def broken(*a):
        raise RuntimeError("boom")

    monkeypatch.setattr(dryrun, "count_step", broken)
    out2 = tmp_path / "dry2"
    assert dryrun.main(["--arch", "qwen3-4b", "--shape", "decode_32k",
                        "--out", str(out2)]) == 1
    rec = json.load(open(out2 / "qwen3-4b_decode_32k_16x16.json"))
    assert rec["status"] == "failed" and "boom" in rec["error"]


# ===========================================================================
# roofline
# ===========================================================================

@pytest.mark.parametrize("sname", DRY_CELLS)
def test_analyze_record_matches_reference(sname, port_cells, monkeypatch):
    monkeypatch.setattr(jroofline, "PEAK_FLOPS", roofline.PEAK_FLOPS)
    monkeypatch.setattr(jroofline, "HBM_BW", roofline.HBM_BW)
    monkeypatch.setattr(jroofline, "ICI_EFF", roofline.LINK_BW)
    rec = port_cells[f"16x16|{sname}"]
    got, want = roofline.analyze_record(rec), jroofline.analyze_record(rec)
    assert got.pop("fits_80g") == (rec["memory"]["peak_per_device_gib"] <= 80.0)
    want.pop("fits_16g")
    assert got == want


def test_model_flops_match_reference():
    for arch in ARCHS:
        for sname in SHAPES:
            for dev in (256, 512):
                assert roofline.model_flops_per_device(arch, sname, dev) == \
                    jroofline.model_flops_per_device(arch, sname, dev)


def test_roofline_cli(tmp_path, capsys, port_cells):
    for sname in DRY_CELLS:
        with open(tmp_path / f"smollm-360m_{sname}_16x16.json", "w") as f:
            json.dump(port_cells[f"16x16|{sname}"], f)
    assert len(roofline.load_all(str(tmp_path))) == 3
    roofline.main(["--dir", str(tmp_path), "--markdown"])
    out = capsys.readouterr().out
    assert out.count("| smollm-360m |") == 3


def test_roofline_constants_are_the_datasheet_figures():
    assert roofline.PEAK_FLOPS == 989e12 and roofline.HBM_BW == 3.35e12
    assert roofline.LINK_BW == 450e9 and roofline.HBM_GIB == 80.0


# ===========================================================================
# the op counter and symmetric peers
# ===========================================================================

def test_op_counter_counts_dots_bytes_and_slice_writes():
    a = torch.empty(8, 16, device="meta")
    w = torch.empty(16, 4, device="meta")
    buf = torch.empty(2, 100, 3, device="meta")
    val = torch.empty(2, 1, 3, device="meta")
    with op_analysis.OpCounter() as c:
        y = a @ w                                   # mm: 2·8·16·4
        z = (y * 2 + 1).exp()                       # elementwise: no bytes
        s = z.sum(0)                                # a reduction: output bytes
        b2 = buf.index_copy(1, torch.tensor([5], device="meta"), val)
        r = c.result()
    assert r["dot_flops"] == 2 * 8 * 16 * 4
    mm_bytes = (8 * 16 + 16 * 4 + 8 * 4) * 4
    assert r["bytes_proxy"] == mm_bytes + 4 * 4 + 2 * 3 * 4
    assert r["collectives"] == {} and r["wire_bytes_total"] == 0
    # live after the block: y, z, s and b2 (y * 2 and + 1 died; the index
    # tensor was made outside any op, so it is the caller's)
    assert r["end_live_bytes"] == (8 * 4 * 4) * 2 + 4 * 4 + 2 * 100 * 3 * 4
    assert r["peak_live_bytes"] >= r["end_live_bytes"]


def test_op_counter_peak_and_shares():
    x = torch.empty(1000, device="meta")
    with op_analysis.OpCounter(shares={(1000,): 4}) as c:
        t = [x + i for i in range(3)]     # three 4000-byte tensors at share 4
        del t
        u = torch.empty(50, device="meta").clone()
        r = c.result()
    assert r["peak_live_bytes"] == pytest.approx(3 * 1000)
    assert r["end_live_bytes"] == 200


def test_op_counter_reads_collectives():
    xs = [torch.empty(8, 4, device="meta")] * 2
    with op_analysis.OpCounter() as c:
        exchange.all_to_all(xs)
        exchange.all_reduce(xs)
        r = c.result()
    assert r["collectives"] == {
        "all-to-all": {"count": 1.0, "bytes": 128.0, "wire_bytes": 128.0},
        "all-reduce": {"count": 1.0, "bytes": 128.0, "wire_bytes": 256.0}}
    assert r["wire_bytes_total"] == 384.0
    assert r["bytes_proxy"] == 0      # the exchanges' copies are not counted


@pytest.mark.parametrize("tp", [2, 4])
def test_symmetric_peers_count_as_the_full_loop(tp):
    """The dry run's scale trick: one peer weighed by the peer count gives
    the counts of every peer run, forward and backward."""
    cfg = reduced(ARCHS["granite-moe-3b-a800m"])
    model = get_model(cfg)
    params, _ = model.init(None)
    batch = input_specs(cfg, ShapeConfig("t", "train", 16, 4))
    mesh = mesh_lib.make_host_mesh((1, tp), devices=["meta"] * tp)
    from repro_torch.train import train_step as ts
    res = []
    for symmetric in (False, True):
        mesh_lib.activate(mesh)
        try:
            ctx = exchange.symmetric_peers() if symmetric else _null()
            with ctx, op_analysis.OpCounter() as c:
                ts.value_and_grad(model.loss_fn, params, batch)
                res.append(c.result())
        finally:
            mesh_lib.deactivate()
    full, sym = res
    assert full["collectives"]["all-to-all"]["count"] > 0
    assert sym["dot_flops"] == full["dot_flops"]
    assert sym["bytes_proxy"] == full["bytes_proxy"]
    assert sym["collectives"] == full["collectives"]


@pytest.mark.parametrize("tp", [1, 2])
def test_symmetric_microbatches_count_as_the_full_loop(tp):
    """Microbatches are symmetric too: the first and a last one weighed by
    the rest, the middle ones' gradients held as copies, give the counts of
    the full loop (its exchanges per microbatch included) and, with no
    peers, its peak and end bytes.  With EP peers the symmetric peak is one
    peer's (the per-device share), the full loop's every peer's at once."""
    cfg = reduced(ARCHS["granite-moe-3b-a800m"])
    model = get_model(cfg)
    params, _ = model.init(None)
    batch = input_specs(cfg, ShapeConfig("t", "train", 16, 8))
    mesh = mesh_lib.make_host_mesh((1, tp), devices=["meta"] * tp)
    from repro_torch.train import optimizer as opt, train_step as ts
    step = ts.make_train_step(model, opt.AdamWConfig(), microbatch=4)
    res = []
    for symmetric in (False, True):
        mesh_lib.activate(mesh)
        try:
            ctx = exchange.symmetric_peers() if symmetric else _null()
            with ctx, op_analysis.OpCounter() as c:
                out = step(ts.init_state(params), batch)
                res.append(c.result())
            del out
        finally:
            mesh_lib.deactivate()
    full, sym = res
    keys = ["dot_flops", "bytes_proxy", "collectives", "end_live_bytes"]
    for k in keys + (["peak_live_bytes"] if tp == 1 else []):
        assert sym[k] == full[k], k
    if tp > 1:
        assert full["collectives"]["all-to-all"]["count"] > 0
        assert sym["peak_live_bytes"] < full["peak_live_bytes"]
    assert sym["ops"] < full["ops"]


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


# ===========================================================================
# the hom sync bench
# ===========================================================================

@pytest.mark.parametrize("world", [4, 8])
def test_hom_sync_bench_wire_bytes(world):
    r = hom_sync_bench.sync_bytes("smollm-360m", world)
    params, _ = get_model(ARCHS["smollm-360m"]).init(None)
    leaves = tree_leaves(params)
    numel = sum(p.numel() for p in leaves)
    assert r["f32"]["collectives"] == {"all-reduce": {
        "count": len(leaves), "bytes": 4 * numel}}
    assert r["hom16"]["collectives"] == {"all-reduce": {
        "count": 2 * len(leaves), "bytes": 2 * numel + 4 * len(leaves)}}
    assert r["f32"]["wire_GB"] / r["hom16"]["wire_GB"] == pytest.approx(2.0, rel=1e-4)
