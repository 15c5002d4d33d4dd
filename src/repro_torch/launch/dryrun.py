"""Dry run of every (arch x shape x mesh) cell on ``meta`` tensors: no card,
no allocation.

The reference lowers and compiles each cell's step for a 256- or 512-device
TPU mesh and reads XLA's memory and cost analyses.  The port compiles
nothing; for each cell it records:

* **exact**, from the production mesh's shardings
  (``launch/mesh.tree_shardings`` / ``batch_shardings``, jax's
  ``shard_shape`` rule): ``argument_bytes`` (params, optimizer state and
  step count, the batch, the cache), ``output_bytes`` (the new state and
  the metrics; the logits and the cache) and ``alias_bytes`` (what the
  reference donates: the whole state of a ``gspmd`` train step, the cache
  of a decode step; nothing in ``hom`` mode or in prefill), per device;
* **counted**, by running the cell's step eagerly on ``meta`` tensors
  under ``launch/op_analysis.OpCounter``: one data group's program.  The
  step runs on the local batch of one data shard (the global batch over
  the shards ``batch_shardings`` gives the tokens) on a mesh of that one
  group: its ``model`` axis keeps the production extent where the
  production mesh takes manual expert parallelism (each peer then routes
  the same token slice and capacities as in production), else 1.  Under
  ``comm.exchange.symmetric_peers()`` the group's peers run as one (one
  peer's work, weighed by the peer count) and a train step's microbatches
  as two (the first, and the last weighed by the rest, the middle ones'
  gradients held as copies): the counts of the full loops and one
  device's peak (one peer's temporaries beside every microbatch's
  gradients), at a fraction of the meta ops (``deepseek-v3-671b`` x ``train_4k``:
  about 20 s on a host core instead of about 95).  ``dot_flops`` and
  ``bytes_proxy`` per device are the group's counts times the data shards
  over the devices: the ideal split of the global work (the reference's
  HLO count is the per-device program, replicated work included); the
  collectives are the group's per-peer exchanges, which are per device;
* **estimated**: ``temp_bytes``.  Rule: the peak of the live bytes the
  group's step makes (its arguments excluded), each tensor whole as one
  device's activation, except a tensor shaped like a parameter or like
  one layer of a stacked one (a gradient, a moment, a new parameter, a
  layer's weights cast to the compute dtype), or such a shape under one
  leading dim (the microbatches' stacked gradients), which counts at that
  parameter's per-device share; minus the outputs that are not aliased
  (``output - alias``), so that ``peak_per_device_gib``, the reference's
  ``argument + output + temp - alias``, is the arguments plus the step's
  own peak, as an eager step holds them.  It is not XLA's buffer assignment: model-axis
  splits of activations (heads, mlp, vocab) are not credited, and donation
  saves nothing in an eager step.

The collective table holds only the exchanges the port issues: manual
expert parallelism's all-to-alls and all-gather, and the ``hom`` step's
pmax / int16 psum / loss pmean.  The FSDP and tensor-parallel collectives
GSPMD implies have no counterpart in a port that does not shard weights.
Records keep the reference's keys; ``hlo`` holds the op counter's dict
(there is no HLO), ``cost`` the group's raw counts, ``lower_s`` the set-up
and ``compile_s`` the meta step's seconds.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k [--multi-pod]
  python -m repro_torch.launch.dryrun --all [--out build/dryrun]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any

import torch

from ..comm import exchange
from ..configs import ARCHS, SHAPES, cell_supported
from ..models import ffn, get_model, input_specs as model_input_specs
from ..models.common import tree_leaves, tree_map
from ..train import optimizer as opt_lib
from ..train import train_step as ts_lib
from . import mesh as mesh_lib
from .op_analysis import OpCounter

# activation-memory lever: grad-accumulation microbatches per train step
MICROBATCH = {
    "deepseek-v3-671b": 8, "falcon-mamba-7b": 4, "recurrentgemma-9b": 4,
    "minitron-4b": 2, "qwen3-4b": 2, "granite-3-2b": 2,
    "granite-moe-3b-a800m": 2, "paligemma-3b": 2,
}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _sharded_bytes(tree, shardings) -> int:
    """Per-device bytes of a tensor tree under a same-structured sharding
    tree."""
    return sum(sh.shard_nbytes(t) for t, sh in
               zip(tree_leaves(tree), tree_leaves(shardings)) if t is not None)


def _mesh_name(mesh) -> str:
    return "x".join(str(s) for s in mesh.axis_sizes)


def _batch_shards(mesh, batch_sh) -> int:
    """How many ways the batch splits (the tokens leaf's leading dim)."""
    axis = batch_sh["tokens"].spec[0]
    if axis is None:
        return 1
    return math.prod(mesh.shape[a] for a in
                     (axis if isinstance(axis, tuple) else (axis,)))


def _group_mesh(mesh, ep: bool):
    """One data group: every axis 1 but ``model``, which keeps its extent
    where the production mesh takes manual expert parallelism."""
    sizes = tuple(s if (a == "model" and ep) else 1
                  for a, s in zip(mesh.axis_names, mesh.axis_sizes))
    return mesh_lib.HostMesh((torch.device("meta"),) * math.prod(sizes),
                             mesh.axis_names, sizes)


def _takes_ep(cfg, mesh, seq_shard: bool, x_shape) -> bool:
    """Whether the production mesh takes manual EP for an MoE input of
    ``x_shape``."""
    if not cfg.moe:
        return False
    mesh_lib.activate(mesh, seq_shard=seq_shard)
    try:
        fcfg = ffn.FfnCfg(d_model=cfg.d_model, d_ff=cfg.d_ff, moe=True,
                          n_experts=cfg.n_experts, top_k=cfg.top_k)
        return ffn._can_manual_ep(fcfg, _meta(x_shape, cfg.compute_dtype))
    finally:
        mesh_lib.deactivate()


def _shares(params, specs, param_sh) -> dict[tuple, float]:
    """Parameter shape -> its per-device share (the smallest over params of
    that shape); one layer of a stacked parameter (the ``layers`` axis is
    never split) shares its stack's."""
    out: dict[tuple, float] = {}

    def one(p, spec, sh):
        shape = tuple(p.shape)
        f = math.prod(shape) / max(math.prod(sh.shard_shape(shape)), 1)
        for s in ((shape, shape[1:]) if spec[:1] == ("layers",) else (shape,)):
            out[s] = min(out.get(s, f), f)

    tree_map(one, params, specs, param_sh)
    return out


def count_step(run, group, seq_shard: bool, shares: dict):
    """``run()`` on ``meta`` tensors with ``group`` active, its peers
    symmetric, under an :class:`OpCounter`: ``(outputs, counts)``."""
    mesh_lib.activate(group, seq_shard=seq_shard)
    try:
        with exchange.symmetric_peers(), OpCounter(shares=shares) as counter:
            out = run()
            return out, counter.result()
    finally:
        mesh_lib.deactivate()


def build_cell(arch: str, shape_name, *, multi_pod: bool,
               hom_grads: bool = False, remat: str | None = None,
               seq_shard: bool = False, microbatch: int | None = None,
               kv_quant: bool = False, fsdp_bf16: bool = False,
               mesh=None) -> dict[str, Any]:
    """Dry-run one cell; returns the result record.  ``shape_name`` names a
    ``SHAPES`` entry or is a ``ShapeConfig``; ``mesh`` (a ``HostMesh``)
    replaces the production mesh."""
    cfg = ARCHS[arch]
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    if kv_quant:
        cfg = dataclasses.replace(cfg, kv_quant=True)
    if fsdp_bf16:
        cfg = dataclasses.replace(cfg, fsdp_bf16_gather=True)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    if mesh is None:
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    rec: dict[str, Any] = {
        "arch": arch, "shape": shape.name, "mesh": _mesh_name(mesh),
        "mode": shape.kind, "hom_grads": hom_grads,
        "kv_quant": kv_quant, "seq_shard": seq_shard,
    }
    ok, reason = cell_supported(cfg, shape)
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = reason
        return rec

    n_dev = mesh.size
    rec["devices"] = n_dev
    try:
        t0 = time.time()
        model = get_model(cfg)
        params, specs = model.init(None)
        param_sh = mesh_lib.tree_shardings(mesh, specs, params,
                                           seq_shard=seq_shard)
        in_specs = model_input_specs(cfg, shape)
        batch_sh = mesh_lib.batch_shardings(mesh, in_specs)
        p_bytes = _sharded_bytes(params, param_sh)
        b_bytes = _sharded_bytes(in_specs, batch_sh)
        dp = _batch_shards(mesh, batch_sh)
        B, S = shape.global_batch, shape.seq_len
        B_loc = B // dp
        local = dataclasses.replace(shape, global_batch=B_loc)
        x_len = 1 if shape.kind == "decode" else S
        ep = _takes_ep(cfg, mesh, seq_shard, (B, x_len, cfg.d_model))
        group = _group_mesh(mesh, ep)
        batch = model_input_specs(cfg, local)
        scalar = _meta((), torch.int32)

        if shape.kind == "train":
            mode = "hom" if hom_grads else "gspmd"
            dp_axes = ("pod", "data") if "pod" in mesh.axis_names else ("data",)
            mb = microbatch if microbatch is not None else MICROBATCH.get(arch)
            rec["microbatch"] = mb
            opt_cfg = opt_lib.AdamWConfig()
            opt = opt_lib.init(params)
            state = ts_lib.TrainState(
                params=params, opt=opt, step=scalar,
                ef_residual=(ts_lib.hom.PerWorker(
                    [ts_lib.hom.init_residuals(params)]) if hom_grads else None))
            # state bytes: params, m, v (and residuals) at the params'
            # shardings, the count and the step replicated
            s_bytes = p_bytes * (4 if hom_grads else 3) + 4 + 4
            arg = s_bytes + b_bytes
            alias = 0 if hom_grads else s_bytes
            step = ts_lib.make_train_step(model, opt_cfg, mode=mode,
                                          mesh=group, dp_axes=dp_axes,
                                          microbatch=mb)
            run = lambda: step(state, batch)
            # metrics (loss, grad_norm, lr): replicated f32 scalars
            out_of = lambda out: s_bytes + 4 * len(out[1])
        elif shape.kind == "prefill":
            # cache must cover prefix tokens (VLM) + prompt + a little headroom
            max_len = S + cfg.prefix_tokens + 8
            arg, alias = p_bytes + b_bytes, 0
            run = lambda: model.prefill(params, batch, max_len)

            def out_of(out):
                logits, cache = out
                return (_logits_bytes(mesh, seq_shard, B, logits)
                        + _cache_bytes(model, mesh, seq_shard, B, max_len))
        else:  # decode
            cache = model.init_cache(B_loc, S, device="meta")
            c_bytes = _cache_bytes(model, mesh, seq_shard, B, S)
            tok = _meta((B_loc, 1), torch.int32)
            toks = {"tokens": _meta((B, 1), torch.int32)}
            tok_bytes = _sharded_bytes(toks, mesh_lib.batch_shardings(mesh, toks))
            arg = p_bytes + tok_bytes + c_bytes
            alias = c_bytes
            run = lambda: model.decode_step(params, tok, cache)
            out_of = lambda out: (_logits_bytes(mesh, seq_shard, B, out[0])
                                  + c_bytes)
        rec["lower_s"] = round(time.time() - t0, 2)

        t0 = time.time()
        out, counted = count_step(run, group, seq_shard,
                                  _shares(params, specs, param_sh))
        rec["compile_s"] = round(time.time() - t0, 2)
        output = out_of(out)
        del out

        temp = max(0, int(counted["peak_live_bytes"]) - (output - alias))
        rec["memory"] = {
            "argument_bytes": int(arg),
            "output_bytes": int(output),
            "temp_bytes": temp,
            "alias_bytes": int(alias),
            "peak_per_device_gib": round(
                (arg + output + temp - alias) / 2**30, 3),
        }
        rec["cost"] = {"flops_raw": counted["dot_flops"],
                       "bytes_accessed_raw": counted["bytes_proxy"]}
        rec["hlo"] = {
            "dot_flops": counted["dot_flops"] * dp / n_dev,
            "bytes_proxy": counted["bytes_proxy"] * dp / n_dev,
            "collectives": counted["collectives"],
            "wire_bytes_total": counted["wire_bytes_total"],
            "peak_live_bytes": counted["peak_live_bytes"],
            "ops": counted["ops"],
        }
        rec["group"] = {"mesh": _mesh_name(group), "batch": B_loc,
                        "data_shards": dp, "expert_parallel": ep}
        rec["notes"] = {
            "dot_flops": "the group's count x data shards / devices: the "
                         "ideal split of the global work",
            "temp_bytes": "estimate: the group step's peak of live bytes "
                          "(param-shaped tensors at their per-device share) "
                          "minus the unaliased outputs",
            "collectives": "only the exchanges the port issues (manual EP, "
                           "the hom psum); no FSDP / TP collectives",
        }
        rec["status"] = "ok"
        print(f"[dryrun] {arch} x {shape.name} x {rec['mesh']}"
              f"{' hom' if hom_grads else ''}: ok "
              f"(set-up {rec['lower_s']}s, meta step {rec['compile_s']}s, "
              f"peak {rec['memory']['peak_per_device_gib']} GiB/dev)")
    except Exception as e:  # noqa: BLE001 — record per-cell failures
        rec["status"] = "failed"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[dryrun] {arch} x {shape.name} x {rec['mesh']}: FAILED "
              f"{rec['error']}")
    return rec


def _logits_bytes(mesh, seq_shard, B, logits) -> int:
    """Per-device bytes of last-position logits (B, 1, V) at the logical
    spec ``("batch", "seq", "vocab")``."""
    rules = mesh_lib.logical_rules(mesh, seq_shard=seq_shard)
    full = _meta((B,) + tuple(logits.shape[1:]), logits.dtype)
    sh = mesh_lib.spec_to_sharding(mesh, ("batch", "seq", "vocab"),
                                   tuple(full.shape), rules)
    return sh.shard_nbytes(full)


def _cache_bytes(model, mesh, seq_shard, B, max_len) -> int:
    """Per-device bytes of the global cache at ``cache_specs``."""
    cache = model.init_cache(B, max_len, device="meta")
    sh = mesh_lib.tree_shardings(mesh, model.cache_specs(B, max_len), cache,
                                 seq_shard=seq_shard)
    return _sharded_bytes(cache, sh)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--hom-grads", action="store_true",
                    help="compressed (int16) homomorphic gradient all-reduce")
    ap.add_argument("--remat", default=None)
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--fsdp-bf16", action="store_true")
    ap.add_argument("--tag", default="", help="suffix for the output json")
    ap.add_argument("--out", default="build/dryrun")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    if args.all:
        cells = [(arch, shape) for arch in ARCHS for shape in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        cells = [(args.arch, args.shape)]
    meshes = [False, True] if (args.both_meshes or args.all) else [args.multi_pod]
    failed = []
    for arch, shape in cells:
        for mp in meshes:
            tag = f"{arch}_{shape}_{'2x16x16' if mp else '16x16'}" \
                  + ("_hom" if args.hom_grads else "") \
                  + ("_kvq" if args.kv_quant else "") \
                  + (f"_{args.tag}" if args.tag else "")
            out_path = os.path.join(args.out, tag + ".json")
            if os.path.exists(out_path):
                with open(out_path) as f:
                    if json.load(f).get("status") != "failed":
                        print(f"[dryrun] {tag}: cached")
                        continue
            rec = build_cell(arch, shape, multi_pod=mp, hom_grads=args.hom_grads,
                             remat=args.remat, seq_shard=args.seq_shard,
                             microbatch=args.microbatch, kv_quant=args.kv_quant,
                             fsdp_bf16=args.fsdp_bf16)
            if rec["status"] == "failed":
                failed.append(tag)
            with open(out_path, "w") as f:
                json.dump(rec, f, indent=1)
    if failed:
        print(f"[dryrun] {len(failed)} cell(s) failed: {', '.join(failed)}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
