"""End-to-end training example: a small LM for a few hundred steps with
HSZ-integrated infrastructure — compressed checkpoints with homomorphic
validation, stage-① gradient telemetry, simulated failure + restart.

    PYTHONPATH=src python -m repro_torch.examples.train_lm_compressed_dp \\
        [--steps 200] [--fail-at 120] [--ckpt-dir DIR] [--device cpu]

``--ckpt-dir`` defaults to ``hsz_ckpt`` under the system's temporary
directory.
"""
import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch.comm import stage1_stats
from repro_torch.configs import ARCHS, reduced
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import get_model
from repro_torch.models.common import tree_leaves
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_step as ts_lib


def build(seq_len, batch, dev):
    cfg = dataclasses.replace(
        reduced(ARCHS["smollm-360m"]), d_model=128, n_layers=4, n_heads=8,
        n_kv=4, head_dim=16, d_ff=384, vocab=2048, remat="none")
    model = get_model(cfg)
    params, _ = model.init(torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    n_params = sum(p.numel() for p in tree_leaves(params))
    opt_cfg = opt_lib.AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=400)
    # one program over the global batch; the homomorphic compressed
    # all-reduce is the train step's "hom" mode over a multi-worker mesh
    step = ts_lib.make_train_step(model, opt_cfg)
    pipe = TokenPipeline(TokenPipelineConfig(vocab=cfg.vocab, seq_len=seq_len,
                                             global_batch=batch))
    return cfg, model, step, ts_lib.init_state(params), pipe, n_params


def restore_latest(ckpt_dir, state, pipe, dev):
    last = ckpt.latest_step(ckpt_dir)
    restored = ckpt.restore(ckpt_dir, last,
                            state._asdict() | {"data": pipe.state_dict()},
                            device=dev)
    pipe.load_state_dict(restored.pop("data"))
    return last, ts_lib.TrainState(**restored)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, default=120,
                    help="simulate a node failure at this step (0 = off)")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "hsz_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = kernel_ops.resolve_device(args.device)

    cfg, model, step, state, pipe, n_params = build(args.seq_len, args.batch,
                                                    dev)
    print(f"model: {n_params/1e6:.1f}M params | tokens/step: "
          f"{args.batch * args.seq_len} | device {dev}")
    os.makedirs(args.ckpt_dir, exist_ok=True)

    # resume if a checkpoint exists (restart-after-failure path)
    if ckpt.latest_step(args.ckpt_dir) is not None:
        last, state = restore_latest(args.ckpt_dir, state, pipe, dev)
        print(f"resumed from checkpoint step {last}")

    t0 = time.time()
    failed = False
    while int(state.step) < args.steps:
        batch = {k: torch.as_tensor(v, device=dev) for k, v in next(pipe).items()}
        state, metrics = step(state, batch)
        s = int(state.step)
        if s % 20 == 0 or s == 1:
            # stage-① homomorphic telemetry on the CURRENT params (cheap)
            stats = stage1_stats(state.params)
            print(f"step {s:4d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"| hom-telemetry: param_rms {float(stats['rms']):.4f} "
                  f"({time.time()-t0:.0f}s)")
        if s % args.ckpt_every == 0:
            ckpt.save(args.ckpt_dir, s,
                      state._asdict() | {"data": pipe.state_dict()},
                      mode="hsz", rel_eb=1e-6, keep=3)
        if args.fail_at and s == args.fail_at and not failed:
            failed = True
            print(f"!! simulated failure at step {s} — restarting from latest "
                  f"checkpoint")
            cfg, model, step, state, pipe, _ = build(args.seq_len, args.batch,
                                                     dev)
            _, state = restore_latest(args.ckpt_dir, state, pipe, dev)

    print(f"done: {args.steps} steps in {time.time()-t0:.0f}s; final loss "
          f"{float(metrics['loss']):.4f}")


if __name__ == "__main__":
    main()
