"""Training launcher: the train step with checkpoint / restart.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --steps 50 --seq-len 64 --batch 4 --reduced [--device cpu]

Weights are a random init from a seeded ``torch.Generator`` on the device;
a ``--ckpt-dir`` that holds a checkpoint resumes from its latest step.
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from ..configs import ARCHS, reduced as reduce_cfg
from ..data.tokens import TokenPipeline, TokenPipelineConfig
from ..kernels import ops as kernel_ops
from ..models import get_model
from ..models.common import tree_leaves
from ..train import checkpoint as ckpt
from ..train import optimizer as opt_lib
from ..train import train_step as ts_lib


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=list(ARCHS))
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--ckpt-mode", default="lossless", choices=["lossless", "hsz"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = kernel_ops.resolve_device(args.device)
    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = reduce_cfg(cfg)
    model = get_model(cfg)
    params, _ = model.init(torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    n = sum(p.numel() for p in tree_leaves(params))
    print(f"[train] {cfg.name}{' (reduced)' if args.reduced else ''}: "
          f"{n/1e6:.1f}M params on {dev}")

    opt_cfg = opt_lib.AdamWConfig(lr=args.lr, warmup_steps=10,
                                  total_steps=max(args.steps, 100))
    step = ts_lib.make_train_step(model, opt_cfg, microbatch=args.microbatch)
    state = ts_lib.init_state(params)
    pipe = TokenPipeline(TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=args.seq_len, global_batch=args.batch))

    if args.ckpt_dir:
        os.makedirs(args.ckpt_dir, exist_ok=True)
        last = ckpt.latest_step(args.ckpt_dir)
        if last is not None:
            restored = ckpt.restore(args.ckpt_dir, last,
                                    state._asdict() | {"data": pipe.state_dict()},
                                    device=dev)
            pipe.load_state_dict(restored.pop("data"))
            state = ts_lib.TrainState(**restored)
            print(f"[train] resumed from step {last}")

    t0 = time.time()
    while int(state.step) < args.steps:
        batch = {k: torch.as_tensor(v, device=dev) for k, v in next(pipe).items()}
        state, metrics = step(state, batch)
        s = int(state.step)
        if s % 10 == 0 or s == 1:
            print(f"[train] step {s:5d} loss {float(metrics['loss']):.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({(time.time()-t0):.0f}s)")
        if args.ckpt_dir and s % args.ckpt_every == 0:
            ckpt.save(args.ckpt_dir, s,
                      state._asdict() | {"data": pipe.state_dict()},
                      mode=args.ckpt_mode, keep=3)
    print(f"[train] finished {args.steps} steps in {time.time()-t0:.0f}s")


if __name__ == "__main__":
    main()
