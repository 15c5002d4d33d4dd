"""Readings for the output check's limits: the system and the control.

    python3 bench/calibrate.py --workload <name> --seeds 1,2,3 --seconds 3

runs the cell once per seed in one process, each with a short window at the
cell's own load, and prints per seed the numbers the check compares: the
system's (the lower readings) and those of the control, the plain reference
computed in bfloat16 in the system's place on the same sampled requests
(the upper readings).  A limit is set between the two (``limits/``).  The
benchmark's own runs never run the control.
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
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    import harness
    from spec import Spec
    spec = Spec()
    for seed in (int(s) for s in args.seeds.split(",")):
        out = harness.run_cell(spec, args.workload, seed, args.seconds, False,
                               "cuda", time.perf_counter(), control=True)
        row = {"seed": seed, "correct": out["correct"],
               "program": {k: v["value"] for k, v in out["checks"].items()},
               "control": {k: v["value"] for k, v in out["control"].items()},
               "info": out["info"]}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
