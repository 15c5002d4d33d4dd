"""Throughput and tail over the number of clients, for choosing a mix's.

    python3 bench/sweep.py --workload <name> --clients 1,2,4,8 --seconds 4

runs the cell once per client count in one process, each with a short
window and the mix's ``clients`` replaced, and prints one JSON line per
count: the end-to-end metrics and how much of the window the host spent
inside ``step`` and waiting for the device.  The knee is the smallest
count past which more clients add little throughput and only lengthen
each request's wait.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--clients", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--seed", type=int, default=2 ** 31 + 101)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep: needs a CUDA card", file=sys.stderr)
        return 2
    import harness
    from spec import Spec
    spec = Spec()
    mix = spec.mix(spec.workload(args.workload)["traffic"])
    for clients in (int(c) for c in args.clients.split(",")):
        out = harness.run_cell(spec, args.workload, args.seed, args.seconds,
                               False, "cuda", time.perf_counter(),
                               mix=dict(mix, clients=clients))
        info = out["info"]
        print(json.dumps({
            "clients": clients, "correct": out["correct"],
            **{k: v["value"] for k, v in out["metrics"].items()},
            "steps": info["steps"], "host_step_s": info["host_step_s"],
            "sync_s": info["sync_s"],
            "memory_peak_bytes": out["device"]["memory_peak_bytes"]}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
