"""Run one benchmark cell once and print its result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It needs a CUDA card: without one (or with
fewer than the cell asks for) it prints no result and exits with 2.  The
last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
also ``breakdown``; ``checks``, each compared number beside its limit,
last); the compared numbers are also the last lines of standard error.
"""
from __future__ import annotations

import os
import time


def _process_start() -> float:
    """``time.perf_counter()`` at the start of this process (Linux's
    process start time, 10 ms steps; now where it cannot be read)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        age = (time.clock_gettime(time.CLOCK_BOOTTIME)
               - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now
    return now - max(age, 0.0)


T_START = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache at a fixed path inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton_cache")):
    os.environ[var] = str(ROOT / "build" / sub)

import torch  # noqa: E402

#: top-level modules that must not be loaded in a run (JAX and the JAX
#: package the port was made from)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


GPU_QUERY = ("power.limit", "power.draw", "clocks.sm", "clocks.max.sm",
             "clocks.mem", "temperature.gpu", "clocks_throttle_reasons.active")


def gpu_state() -> dict:
    """The card's power limit, clocks and throttle reasons (``nvidia-smi``;
    empty where it cannot be read)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=" + ",".join(GPU_QUERY),
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return {}
    if out.returncode != 0 or not out.stdout.strip():
        return {}
    values = out.stdout.strip().splitlines()[0].split(", ")
    return dict(zip(GPU_QUERY, values))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from spec import Spec
    spec = Spec()
    chips = spec.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: cell {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import harness
    out = harness.run_cell(spec, args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda", T_START)
    gpu = gpu_state()
    out["device"]["power_limit"] = gpu.get("power.limit")
    out["info"]["gpu_after"] = gpu
    bad = loaded_forbidden()
    if bad:
        print(f"bench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
