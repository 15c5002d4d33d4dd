"""Gradient-synchronization wire bytes: the f32 all-reduce against the HSZ
homomorphic int16 all-reduce (``comm.compressed_psum_tree``), for one
arch's gradients, counted on ``meta`` tensors (no card, no allocation).

    PYTHONPATH=src python -m repro_torch.examples.hom_sync_bench \\
        [--arch qwen3-4b] [--worlds 256,512] [--out build]

For each world size every worker holds the arch's full f32 gradient tree;
the f32 baseline sums each leaf with ``comm.all_reduce`` (``lax.psum``),
the compressed path quantizes it to int16 with a shared eps (one f32
``pmax`` per leaf) and sums the integers.  ``comm.exchange``'s counters give
each collective's per-worker bytes and wire bytes (an all-reduce moves its
bytes twice); the per-worker wire bytes do not depend on the world size,
only the bit budget does.  The reference's ``experiments/hom_sync_bench.py``
reads the same from XLA's compiled HLO on the production mesh.
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from repro_torch.comm import exchange
from repro_torch.comm import hom_collectives as hom
from repro_torch.configs import ARCHS
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import get_model
from repro_torch.models.common import tree_leaves, tree_map


def wire(counts: dict) -> float:
    return sum(c["bytes"] * (2.0 if k == "all-reduce" else 1.0)
               for k, c in counts.items())


def sync_bytes(arch: str, world: int) -> dict:
    """Per-worker collective counts of both gradient syncs at ``world``."""
    params, _ = get_model(ARCHS[arch]).init(None)
    grads = tree_map(lambda p: torch.empty(p.shape, dtype=torch.float32,
                                           device="meta"), params)
    mesh = make_host_mesh((world, 1), devices=["meta"] * world)
    out = {}
    exchange.reset_counts()
    for g in tree_leaves(grads):
        exchange.all_reduce([g] * world)
    out["f32"] = exchange.counts()
    exchange.reset_counts()
    hom.compressed_psum_tree([grads] * world, None, mesh, world)
    out["hom16"] = exchange.counts()
    exchange.reset_counts()
    return {mode: {"wire_GB": wire(c) / 1e9, "collectives": c}
            for mode, c in out.items()}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b", choices=list(ARCHS))
    ap.add_argument("--worlds", default="256,512")
    ap.add_argument("--out", default="build")
    args = ap.parse_args(argv)
    results = {}
    for world in (int(w) for w in args.worlds.split(",")):
        r = sync_bytes(args.arch, world)
        results[str(world)] = r
        for mode in ("f32", "hom16"):
            print(f"{args.arch} world {world} {mode}: wire "
                  f"{r[mode]['wire_GB']:.3f} GB per worker — "
                  f"{r[mode]['collectives']}")
        ratio = r["f32"]["wire_GB"] / max(r["hom16"]["wire_GB"], 1e-9)
        r["reduction"] = ratio
        print(f"==> world {world}: gradient-sync wire reduction {ratio:.2f}x "
              f"(bit budget {hom.bit_budget(world)} bits in int16)")
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"hom_sync_{args.arch}.json")
    with open(path, "w") as fh:
        json.dump(results, fh, indent=1)


if __name__ == "__main__":
    main()
