"""Roofline analysis from dry-run records (``launch/dryrun.py``) against one
NVIDIA H100 SXM.

Three terms per (arch x shape x mesh) cell, all per device:

    compute    = dot_FLOPs / PEAK_FLOPS
    memory     = bytes_proxy / HBM_BW
    collective = wire_bytes / LINK_BW

The dominant term is the bottleneck; roofline fraction = compute_term /
max(all terms) (how close the cell is to being compute-bound, the ideal).
MODEL_FLOPS uses 6·N·D (dense) or 6·N_active·D (MoE) for training; 2·N(_act)
per generated/prefilled token for inference.  The constants are datasheet
figures, not measurements.

    PYTHONPATH=src python -m repro_torch.launch.roofline [--dir build/dryrun]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from ..configs import ARCHS, SHAPES

#: dense bf16 tensor-core peak of one H100 SXM, without sparsity (NVIDIA
#: H100 datasheet)
PEAK_FLOPS = 989e12
#: HBM3 bandwidth of one H100 SXM (NVIDIA H100 datasheet)
HBM_BW = 3.35e12
#: NVLink 4 bandwidth per direction of one H100 SXM: 900 GB/s total, 450 GB/s
#: each way (NVIDIA H100 datasheet)
LINK_BW = 450e9
#: device memory of one H100 SXM (NVIDIA H100 datasheet)
HBM_GIB = 80.0


def model_flops_per_device(arch: str, shape_name: str, devices: int) -> float:
    cfg = ARCHS[arch]
    shape = SHAPES[shape_name]
    n = cfg.active_param_count if cfg.moe else cfg.param_count
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens / devices
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens / devices
    tokens = shape.global_batch  # one token per sequence per step
    return 2.0 * n * tokens / devices


def analyze_record(rec: dict) -> dict:
    hlo = rec["hlo"]
    flops = hlo["dot_flops"]
    t_compute = flops / PEAK_FLOPS
    t_memory = hlo["bytes_proxy"] / HBM_BW
    t_coll = hlo["wire_bytes_total"] / LINK_BW
    terms = {"compute_s": t_compute, "memory_s": t_memory, "collective_s": t_coll}
    dominant = max(terms, key=terms.get)
    mf = model_flops_per_device(rec["arch"], rec["shape"], rec["devices"])
    return {
        **terms,
        "dominant": dominant.replace("_s", ""),
        "roofline_fraction": t_compute / max(max(terms.values()), 1e-30),
        "model_flops": mf,
        "useful_ratio": mf / max(flops, 1e-30),
        "peak_gib": rec["memory"]["peak_per_device_gib"],
        "fits_80g": rec["memory"]["peak_per_device_gib"] <= HBM_GIB,
    }


def load_all(dir_: str) -> list[dict]:
    out = []
    for f in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(f) as fh:
            rec = json.load(fh)
        rec["_file"] = os.path.basename(f)
        out.append(rec)
    return out


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="build/dryrun")
    ap.add_argument("--mesh", default="16x16",
                    help="mesh filter for the table (roofline is single-pod)")
    ap.add_argument("--markdown", action="store_true")
    args = ap.parse_args(argv)

    recs = [r for r in load_all(args.dir)
            if r.get("mesh") == args.mesh and not r.get("hom_grads")]
    header = (f"{'arch':22s} {'shape':12s} {'st':4s} {'comp_ms':>8s} {'mem_ms':>8s} "
              f"{'coll_ms':>8s} {'domin':>7s} {'roofl%':>7s} {'useful%':>8s} "
              f"{'GiB/dev':>8s}")
    if args.markdown:
        print("| arch | shape | status | compute ms | memory ms | collective ms "
              "| dominant | roofline | useful | GiB/dev |")
        print("|---|---|---|---|---|---|---|---|---|---|")
    else:
        print(header)
        print("-" * len(header))
    for rec in recs:
        arch, shape = rec["arch"], rec["shape"]
        if rec["status"] == "skipped":
            if args.markdown:
                print(f"| {arch} | {shape} | skipped | — | — | — | — | — | — | — |")
            else:
                print(f"{arch:22s} {shape:12s} skip  ({rec['reason'][:60]})")
            continue
        if rec["status"] != "ok":
            print(f"{arch:22s} {shape:12s} FAIL  {rec.get('error', '')[:60]}")
            continue
        a = analyze_record(rec)
        if args.markdown:
            print(f"| {arch} | {shape} | ok | {a['compute_s']*1e3:.1f} | "
                  f"{a['memory_s']*1e3:.1f} | {a['collective_s']*1e3:.2f} | "
                  f"{a['dominant']} | {a['roofline_fraction']*100:.0f}% | "
                  f"{min(a['useful_ratio'],9.99)*100:.0f}% | {a['peak_gib']:.1f} |")
        else:
            print(f"{arch:22s} {shape:12s} ok   {a['compute_s']*1e3:8.1f} "
                  f"{a['memory_s']*1e3:8.1f} {a['collective_s']*1e3:8.2f} "
                  f"{a['dominant']:>7s} {a['roofline_fraction']*100:6.0f}% "
                  f"{min(a['useful_ratio'],9.99)*100:7.0f}% {a['peak_gib']:8.1f}")


if __name__ == "__main__":
    main()
