"""Derived operators: vorticity from (u, v) as one expression query.

Builds a rigid-rotation velocity field (closed-form vorticity == +2),
registers u and v in a FieldStore, and computes

    vorticity = dv/dx - du/dy

as ONE expression query: one program, one stage reconstruction per
component, store-seeded on the second run.  Compares against the naive
spelling (two single-derivative queries composed on the host) for both
correctness and dispatch count, then shows a couple more derived
quantities riding the same store.

    PYTHONPATH=src python -m repro_torch.examples.derived_operators \
        [--n 192] [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.analytics import query
from repro_torch.analytics.engine import BatchedAnalytics
from repro_torch.core import by_name, expr
from repro_torch.examples._timing import timed
from repro_torch.kernels import ops as kernel_ops
from repro_torch.store import FieldStore


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=192)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = kernel_ops.resolve_device(args.device)
    n = args.n

    # rigid rotation (u, v) = (-y, x): vorticity dv/dx - du/dy == 2 exactly
    i = np.arange(n, dtype=np.float32)[:, None] + np.zeros((n, n), np.float32)
    j = np.arange(n, dtype=np.float32)[None, :] + np.zeros((n, n), np.float32)
    comp = by_name("hszp_nd")
    store = FieldStore(cache_bytes=256 << 20)
    store.put("u", comp.compress(-j, abs_eb=0.25, device=dev))
    store.put("v", comp.compress(i, abs_eb=0.25, device=dev))
    engine = BatchedAnalytics()

    vort = expr.sub(expr.derivative("v", axis=0), expr.derivative("u", axis=1))
    res = query(exprs=[vort], store=store, engine=engine)   # cold: materializes
    res, dt = timed(lambda: query(exprs=[vort], store=store, engine=engine),
                    dev)                                     # warm: seeded
    w = res.values[0].cpu().numpy()
    print(f"vorticity: shape {w.shape}, mean {w.mean():+.6f} (exact +2), "
          f"stage {res.stages[0].name}, {res.n_dispatches} dispatch(es), "
          f"store hits {res.store_hits}, {dt * 1e3:.2f} ms warm")

    # naive composition: one query per derivative, combined on the host
    naive = query(exprs=[expr.op("derivative", "v", axis=0)],
                  store=store, engine=engine)
    naive2 = query(exprs=[expr.op("derivative", "u", axis=1)],
                   store=store, engine=engine)
    w_naive = naive.values[0].cpu().numpy() - naive2.values[0].cpu().numpy()
    print(f"naive compose: {naive.n_dispatches + naive2.n_dispatches} "
          f"dispatches, max |delta| vs expression "
          f"{np.abs(w - w_naive).max():.2e}")

    # several derived quantities in one program: leaves decode once each
    batch = query(exprs=[vort,
                         expr.laplacian("u") + expr.laplacian("v"),
                         2.0 * expr.mean("u") - expr.std("v")],
                  store=store, engine=engine)
    print(f"3 derived roots over 2 leaves: {batch.n_dispatches} dispatch(es), "
          f"stages {[s.name for s in batch.stages]}")


if __name__ == "__main__":
    main()
