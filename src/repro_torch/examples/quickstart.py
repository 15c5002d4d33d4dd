"""Quickstart: compress a scientific field, analyze it without decompressing.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import Stage, hszp_nd, hszx_nd, homomorphic as H
from repro_torch.examples._timing import timed
from repro_torch.kernels import ops as kernel_ops


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = kernel_ops.resolve_device(args.device)

    # a smooth 2-D field with noise (think: sea-surface temperature)
    rng = np.random.default_rng(0)
    g = np.linspace(0, 4 * np.pi, 1200)
    field = (np.sin(g)[:, None] * np.cos(g / 2)[None, :] * 5
             + rng.normal(0, 0.05, (1200, 1200))).astype(np.float32)
    data = torch.as_tensor(field, device=dev)

    print("== compress (HSZx-nd: block-mean metadata -> stage-1 stats) ==")
    c = hszx_nd.compress(data, rel_eb=1e-3, device=dev)
    print(f"error bound eps = {float(c.eps):.3e}")
    print(f"compression ratio = {float(hszx_nd.compression_ratio(c)):.2f}x")

    print("\n== mean at each decompression stage ==")
    for stage in (Stage.M, Stage.P, Stage.Q, Stage.F):
        val = float(H.mean(c, stage))
        dt = sum(timed(lambda s=stage: H.mean(c, s), dev)[1]
                 for _ in range(5)) / 5
        print(f"stage {stage.name}: mean={val:+.6f}   {dt*1e3:7.2f} ms "
              f"({'metadata only!' if stage == Stage.M else ''})")
    print(f"numpy reference: {field.mean():+.6f}")

    print("\n== derivatives straight from quantized integers (HSZp-nd) ==")
    cp = hszp_nd.compress(data, rel_eb=1e-3, device=dev)
    for stage in (Stage.P, Stage.Q, Stage.F):
        d0 = H.derivative(cp, stage, 0).cpu().numpy()
        ref = (field[2:, 1:-1] - field[:-2, 1:-1]) / 2
        print(f"stage {stage.name}: max|err| vs raw data = "
              f"{np.abs(d0 - ref).max():.2e} (eps={float(cp.eps):.2e})")


if __name__ == "__main__":
    main()
