"""Serving launcher: batched decode over the slot engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
        --reduced --requests 8 [--kv-quant] [--device cpu]

Weights are a random init from a seeded ``torch.Generator`` on the device.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs import ARCHS, reduced as reduce_cfg
from ..kernels import ops as kernel_ops
from ..models import get_model
from ..serve import Engine, Request


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b", choices=list(ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--kv-quant", action="store_true",
                    help="HSZ stage-3 int8 KV-cache residency")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = kernel_ops.resolve_device(args.device)
    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = reduce_cfg(cfg)
    if args.kv_quant:
        cfg = dataclasses.replace(cfg, kv_quant=True)
    model = get_model(cfg)
    params, _ = model.init(torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    eng = Engine(model, params, slots=args.slots, max_len=args.max_len,
                 device=dev)

    rng = np.random.default_rng(0)
    for i in range(args.requests):
        eng.add_request(Request(
            uid=i, prompt=rng.integers(1, cfg.vocab, 8).astype(np.int32),
            max_new_tokens=args.max_new_tokens))
    t0 = time.time()
    done = eng.run_until_drained()
    dt = time.time() - t0
    toks = sum(len(r.out_tokens) for r in done)
    print(f"[serve] {len(done)} requests, {toks} tokens in {dt:.1f}s "
          f"({toks/dt:.1f} tok/s) kv_quant={args.kv_quant} device={dev}")


if __name__ == "__main__":
    main()
