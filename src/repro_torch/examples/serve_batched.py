"""Batched serving with HSZ stage-③ (int8) KV-cache residency.

    PYTHONPATH=src python -m repro_torch.examples.serve_batched [--device cpu]
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, reduced
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import get_model
from repro_torch.models.common import tree_leaves
from repro_torch.serve import Engine, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = kernel_ops.resolve_device(args.device)

    base = reduced(ARCHS["qwen3-4b"])
    rng = np.random.default_rng(0)
    for kv_quant in (False, True):
        cfg = dataclasses.replace(base, kv_quant=kv_quant)
        model = get_model(cfg)
        params, _ = model.init(torch.Generator(device=dev).manual_seed(0),
                               device=dev)
        eng = Engine(model, params, slots=4, max_len=96, device=dev)
        for i in range(8):
            eng.add_request(Request(
                uid=i, prompt=rng.integers(1, cfg.vocab, 6).astype(np.int32),
                max_new_tokens=12))
        t0 = time.time()
        done = eng.run_until_drained()
        dt = time.time() - t0
        cache_bytes = sum(t.nbytes for t in tree_leaves(eng.cache))
        toks = sum(len(r.out_tokens) for r in done)
        print(f"kv_quant={str(kv_quant):5s}: {len(done)} requests, {toks} tokens "
              f"in {dt:.1f}s | KV cache bytes/slot: {cache_bytes//4:,}")
        sample = done[0]
        print(f"  request {sample.uid}: prompt {list(sample.prompt)} -> "
              f"{sample.out_tokens}")


if __name__ == "__main__":
    main()
