#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the root of a checkout: ``python3 chip_smoke.py [--seed N]``.  It
needs one CUDA device and the CUDA toolkit (``nvcc``); without a card it
exits non-zero before it prints any result.

Phases (any failure raises, so the exit code is non-zero):

1. the card: its name, power limit and the device count;
2. build the Hopper kernels from ``src/repro_torch/kernels/csrc`` and print
   ``ptxas``'s register, shared-memory and spill lines;
3. every kernel against its plain PyTorch version on the card, at the Ocean
   shape (2400 x 3600, blocks 16 x 16) and a padded one (2401 x 3599):
   bitwise, for every ``what`` and several unpack widths;
4. the main path: the two Ocean fields (u, v) through ``compress`` ->
   ``encode`` -> ``decompress`` and every feasible (op, stage) cell of
   ``hszp_nd`` and ``hszx_nd`` for ``Compressed`` and ``Encoded`` containers,
   each held against the port on the CPU; the launch counters, reset just
   before and read just after, must show every kernel site; then an A/B pass
   with the fused rules off;
5. times: each kernel and its plain version with CUDA events, the bound
   (bytes over 3.35 TB/s), launches per query, and end-to-end ms per query.

Per-cell detail goes to ``chiprun_out/chip_smoke.log``.  The last two lines
of standard output are a JSON object of per-kernel numbers and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import Stage, by_name, encode, error_analysis  # noqa: E402
from repro_torch.core import homomorphic as H  # noqa: E402
from repro_torch.data.scientific import dataset_dims, synth_field  # noqa: E402
from repro_torch.kernels import bitpack, build, fused, ops  # noqa: E402

#: published H100 SXM peaks (NVIDIA data sheet): device memory, and f32
#: outside the tensor cores (the table has no int32 rate; the kernels' few
#: integer operations per element are far below either bound)
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12

DEVICE = "cuda"
OCEAN = dataset_dims("Ocean")  # (2400, 3600), the dataset's full size
PADDED = (OCEAN[0] + 1, OCEAN[1] - 1)
BLOCK = (16, 16)
REL_EB = 1e-3
REPS = 50  # kernel launches per CUDA-event timing
SCHEMES = ("hszp_nd", "hszx_nd")
OPS = ("mean", "std", "deriv0", "deriv1", "gradient", "laplacian",
       "divergence", "curl")
STENCILS = ("deriv0", "deriv1", "gradient", "laplacian")
CSRC = "src/repro_torch/kernels/csrc"
#: kernel site -> (source in the repo, the Pallas call it replaces)
SITES = {
    "unpack": (f"{CSRC}/unpack.cu", "src/repro/kernels/bitpack.py:94"),
    "lorenzo_enc2d.edges": (f"{CSRC}/lorenzo_band.cu",
                            "src/repro/kernels/fused.py:288"),
    "lorenzo_enc2d.stencil": (f"{CSRC}/lorenzo_band.cu",
                              "src/repro/kernels/fused.py:302"),
    "blockmean_enc2d": (f"{CSRC}/blockmean_band.cu",
                        "src/repro/kernels/fused.py:464"),
    "lorenzo2d.edges": (f"{CSRC}/lorenzo_band.cu",
                        "src/repro/kernels/fused.py:250"),
    "lorenzo2d.stencil": (f"{CSRC}/lorenzo_band.cu",
                          "src/repro/kernels/fused.py:250"),
    "blockmean2d": (f"{CSRC}/blockmean_band.cu",
                    "src/repro/kernels/fused.py:412"),
}

LOG: list[str] = []


def say(line: str) -> None:
    print(line, flush=True)
    LOG.append(line)


def detail(line: str) -> None:
    LOG.append(line)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


# ===========================================================================
# comparisons
# ===========================================================================

def _tup(x):
    return x if isinstance(x, tuple) else (x,)


def bitwise_err(want, got, what: str) -> float:
    """Require bitwise equality; return the max absolute difference (0)."""
    err = 0.0
    for w, g in zip(_tup(want), _tup(got), strict=True):
        if w.dtype != g.dtype or w.shape != g.shape:
            fail(f"{what}: {g.dtype}{tuple(g.shape)} vs {w.dtype}{tuple(w.shape)}")
        if w.dtype == torch.float32:
            diff = (w.double() - g.double()).abs().max()
            same = torch.equal(w.view(torch.int32), g.view(torch.int32))
        else:
            diff = (w.to(torch.int64) - g.to(torch.int64)).abs().max()
            same = torch.equal(w, g)
        err = max(err, float(diff))
        if not same:
            fail(f"{what}: not bitwise equal (max |diff| {float(diff)})")
    return err


def close_vector(want, got, what: str) -> float:
    """divergence / curl: rtol 1e-6, atol 1e-6·max|want|."""
    err = 0.0
    for w, g in zip(_tup(want), _tup(got), strict=True):
        w, g = w.double(), g.double()
        diff = (w - g).abs()
        tol = 1e-6 * w.abs() + 1e-6 * float(w.abs().max())
        if bool((diff > tol).any()):
            fail(f"{what}: max |diff| {float(diff.max())} over tolerance")
        err = max(err, float(diff.max()))
    return err


def close_stat(want, got, field, stage, op: str, what: str) -> float:
    """mean / std: rtol 1e-5, or half of the paper's bias bound (1e-3 of it
    where the bound is eps): the f32 reductions run in another order."""
    w, g = float(want), float(got)
    eps = float(field.eps.item())
    bound = (error_analysis.mean_bias_bound if op == "mean"
             else error_analysis.std_bias_bound)(field, stage)
    tol = max(1e-5 * abs(w), (1e-3 if bound >= eps else 0.5) * bound)
    if not abs(g - w) <= tol:
        fail(f"{what}: |{g} - {w}| = {abs(g - w)} > {tol}")
    return abs(g - w)


# ===========================================================================
# phase 3: each kernel against its plain version on the card
# ===========================================================================

def check_kernels(shape, seed: int, errs: dict) -> dict:
    """Compress one field of ``shape`` on the card and hold every kernel
    against its plain version on the resulting residuals and payloads."""
    data = synth_field("Ocean", 0, shape, seed)
    out = {}
    tile = fused.lorenzo_tile()
    for scheme in SCHEMES:
        comp = by_name(scheme, BLOCK)
        c = comp.compress(data, rel_eb=REL_EB, device=DEVICE)
        e = comp.encode(c)
        if not 0 < e.bits < 32:
            fail(f"{scheme}: packed width {e.bits} takes no payload kernel")
        plane, payload, bits = c.residuals, e.payload, e.bits
        pshape = tuple(c.padded_shape)
        out[scheme] = (c, e)
        if scheme == "hszp_nd":
            for site, src, from_payload in (
                    ("lorenzo_enc2d", payload, True),
                    ("lorenzo2d", plane, False)):
                got = fused.lorenzo_edges(src, pshape, bits,
                                          from_payload=from_payload, site=site)
                want = fused.lorenzo_edges_plain(plane, tile)
                errs[f"{site}.edges"] = max(errs.get(f"{site}.edges", 0.0),
                                            bitwise_err(want, got, f"{site} edges"))
            for what in fused.LORENZO_WHATS:
                want = fused.lorenzo_core(plane, what)
                e1 = bitwise_err(want, fused.lorenzo2d(plane, what=what),
                                 f"lorenzo2d {what} {shape}")
                e2 = bitwise_err(
                    fused.lorenzo_enc2d_plain(payload, pshape, bits, what=what),
                    fused.lorenzo_enc2d(payload, pshape, bits, what=what),
                    f"lorenzo_enc2d {what} {shape}")
                for k, v in (("lorenzo2d.stencil", e1),
                             ("lorenzo_enc2d.stencil", e2)):
                    errs[k] = max(errs.get(k, 0.0), v)
        else:
            meta = c.metadata
            for what in fused.BLOCKMEAN_WHATS:
                want = fused.blockmean_core(plane, meta, BLOCK, what)
                e1 = bitwise_err(want, fused.blockmean2d(plane, meta, BLOCK,
                                                         what=what),
                                 f"blockmean2d {what} {shape}")
                e2 = bitwise_err(
                    fused.blockmean_enc2d_plain(payload, meta, pshape, BLOCK,
                                                bits, what=what),
                    fused.blockmean_enc2d(payload, meta, pshape, BLOCK, bits,
                                          what=what),
                    f"blockmean_enc2d {what} {shape}")
                for k, v in (("blockmean2d", e1), ("blockmean_enc2d", e2)):
                    errs[k] = max(errs.get(k, 0.0), v)
        # unpack: the field's own payload, then several widths, ragged tail
        n = pshape[0] * pshape[1]
        errs["unpack"] = max(errs.get("unpack", 0.0), bitwise_err(
            bitpack.unpack_plain(payload, n, bits),
            bitpack.unpack(payload, n, bits), f"unpack {scheme} bits={bits}"))
    rng = np.random.default_rng(seed)
    n = shape[0] * shape[1] - 3
    for bits in (1, 5, 13, 31):
        u = torch.as_tensor(rng.integers(0, 1 << bits, n, dtype=np.int64)
                            .astype(np.int32), device=DEVICE)
        words = encode.pack_uniform(u, bits)
        errs["unpack"] = max(errs["unpack"], bitwise_err(
            bitpack.unpack_plain(words, n, bits),
            bitpack.unpack(words, n, bits), f"unpack bits={bits} n={n}"))
    torch.cuda.synchronize()
    say(f"kernels == plain versions, bitwise, at {shape} "
        f"(bits {out['hszp_nd'][1].bits} / {out['hszx_nd'][1].bits})")
    return out


# ===========================================================================
# phase 4: the main path
# ===========================================================================

def feasible(scheme: str):
    cells = [("mean", Stage.M)] if scheme == "hszx_nd" else []
    for stage in (Stage.P, Stage.Q, Stage.F):
        cells += [(op, stage) for op in OPS]
    return cells


def run_cell(op: str, stage: Stage, fu, fv):
    if op == "mean":
        return H.mean(fu, stage)
    if op == "std":
        return H.std(fu, stage)
    if op.startswith("deriv"):
        return H.derivative(fu, stage, int(op[-1]))
    if op == "gradient":
        return H.gradient(fu, stage)
    if op == "laplacian":
        return H.laplacian(fu, stage)
    return getattr(H, op)([fu, fv], stage)


def main_path(u: np.ndarray, v: np.ndarray):
    """The user's calls, all on the card: compress -> encode -> decompress
    and every feasible cell.  Returns containers, decompressions and
    results; the caller reads the launch counters right after."""
    fields, decomp, results = {}, {}, {}
    for scheme in SCHEMES:
        comp = by_name(scheme, BLOCK)
        cu = comp.compress(u, rel_eb=REL_EB, device=DEVICE)
        cv = comp.compress(v, rel_eb=REL_EB, device=DEVICE)
        eu, ev = comp.encode(cu), comp.encode(cv)
        fields[scheme] = {"Compressed": (cu, cv), "Encoded": (eu, ev)}
        for stage in (Stage.P, Stage.Q, Stage.F):
            decomp[(scheme, stage)] = comp.decompress(eu, stage)
        for container, (fu, fv) in fields[scheme].items():
            for op, stage in feasible(scheme):
                results[(scheme, container, op, stage)] = run_cell(
                    op, stage, fu, fv)
    torch.cuda.synchronize()
    return fields, decomp, results


def to_cpu(x):
    return tuple(t.cpu() for t in x) if isinstance(x, tuple) else x.cpu()


def check_main_path(u, v, fields, decomp, results):
    """Hold the card's main path against the port on the CPU."""
    worst = {}
    for scheme in SCHEMES:
        comp = by_name(scheme, BLOCK)
        hu = comp.compress(u, rel_eb=REL_EB, device="cpu")
        hv = comp.compress(v, rel_eb=REL_EB, device="cpu")
        host = {"Compressed": (hu, hv),
                "Encoded": (comp.encode(hu), comp.encode(hv))}
        for container, pair in host.items():
            for cf, hf in zip(fields[scheme][container], pair):
                leaves = ("payload" if container == "Encoded" else "residuals",
                          "metadata", "bitwidths", "eps", "valid_counts")
                for leaf in leaves:
                    bitwise_err(getattr(hf, leaf), getattr(cf, leaf).cpu(),
                                f"{scheme} {container} {leaf}")
        eu = fields[scheme]["Encoded"][0]
        bound = error_analysis.reconstruction_bound(eu, float(np.abs(u).max()))
        for stage in (Stage.P, Stage.Q, Stage.F):
            bitwise_err(comp.decompress(host["Encoded"][0], stage),
                        decomp[(scheme, stage)].cpu(),
                        f"{scheme} decompress {stage.name}")
        err = float(np.abs(decomp[(scheme, Stage.F)].cpu().numpy() - u).max())
        if not err <= bound:
            fail(f"{scheme}: error bound broken, {err} > {bound}")
        say(f"{scheme}: bits {eu.bits}, max |decompress - data| {err:.6g} "
            f"<= {bound:.6g}; containers and decompress ②③④ == CPU, bitwise")
        for container, (fu, fv) in host.items():
            for op, stage in feasible(scheme):
                key = (scheme, container, op, stage)
                want = run_cell(op, stage, fu, fv)
                got = to_cpu(results[key])
                what = f"{scheme} {container} {op}@{stage.name}"
                if op in ("mean", "std"):
                    gap = close_stat(want, got, fu, stage, op, what)
                    kind = "stat"
                elif op in ("divergence", "curl"):
                    gap = close_vector(want, got, what)
                    kind = "vector"
                else:
                    gap = bitwise_err(want, got, what)
                    kind = "stencil"
                worst[kind] = max(worst.get(kind, 0.0), gap)
                detail(f"  {what}: card vs CPU max |diff| {gap:.3g}")
    say(f"main path == CPU port: stencils bitwise, max |diff| "
        f"div/curl {worst['vector']:.3g}, mean/std {worst['stat']:.3g}")


def check_ab(fields):
    """Covered cells with the fused rules off equal the fused results."""
    n = 0
    for scheme in SCHEMES:
        for container, (fu, fv) in fields[scheme].items():
            for op in STENCILS + ("divergence", "curl"):
                for stage in (Stage.P, Stage.Q, Stage.F):
                    got = run_cell(op, stage, fu, fv)
                    with ops.override_mode("off"):
                        want = run_cell(op, stage, fu, fv)
                    bitwise_err(want, got, f"A/B {scheme} {container} "
                                f"{op}@{stage.name}")
                    n += 1
    torch.cuda.synchronize()
    say(f"A/B: {n} cells with the fused rules off == fused, bitwise")


# ===========================================================================
# phase 5: times
# ===========================================================================

def cuda_ms(fn, reps: int) -> float:
    """ms per call from CUDA events over ``reps`` back-to-back calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: int, n_ops: int) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_kernels(cont: dict, reps: int, tag: str) -> dict:
    """Kernel and plain-version times at the Ocean shape (what = grad for
    the band kernels: the gradient query's call)."""
    c_lz, e_lz = cont["hszp_nd"]
    c_bm, e_bm = cont["hszx_nd"]
    n0, n1 = c_lz.padded_shape
    n = n0 * n1
    th, tw = fused.lorenzo_tile()
    n_rt, n_ct = -(-n0 // th), -(-n1 // tw)
    edge_bytes = 4 * (n0 * n_ct + n_rt * n1)
    meta_bytes = 4 * c_bm.metadata.numel()

    def pay(e):
        return 4 * e.payload.numel()

    lz_words, lz_bits, lz_plane = e_lz.payload, e_lz.bits, c_lz.residuals
    bm_words, bm_bits, bm_plane = e_bm.payload, e_bm.bits, c_bm.residuals
    meta = c_bm.metadata
    shape = (n0, n1)
    rowsum, colsum = fused.lorenzo_edges(lz_words, shape, lz_bits,
                                         from_payload=True, site="lorenzo_enc2d")
    rowedge = fused.exclusive_prefix(rowsum, 1)
    coledge = fused.exclusive_prefix(colsum, 0)
    plans = {
        # name: (kernel, plain version, bytes, operations)
        "unpack": (
            lambda: bitpack.unpack(lz_words, n, lz_bits),
            lambda: bitpack.unpack_plain(lz_words, n, lz_bits),
            pay(e_lz) + 4 * n, 10 * n),
        "lorenzo_enc2d.edges": (
            lambda: fused.lorenzo_edges(lz_words, shape, lz_bits,
                                        from_payload=True, site="lorenzo_enc2d"),
            lambda: fused.lorenzo_edges_plain(encode.unzigzag(
                bitpack.unpack_plain(lz_words, n, lz_bits)).reshape(shape),
                (th, tw)),
            pay(e_lz) + edge_bytes, 14 * n),
        "lorenzo_enc2d.stencil": (
            lambda: fused.lorenzo_stencil(lz_words, shape, lz_bits, rowedge,
                                          coledge, "grad", from_payload=True,
                                          site="lorenzo_enc2d"),
            lambda: fused.lorenzo_enc2d_plain(lz_words, shape, lz_bits,
                                              what="grad"),
            pay(e_lz) + edge_bytes + 8 * n, 18 * n),
        "blockmean_enc2d": (
            lambda: fused.blockmean_enc2d(bm_words, meta, shape, BLOCK,
                                          bm_bits, what="grad"),
            lambda: fused.blockmean_enc2d_plain(bm_words, meta, shape, BLOCK,
                                                bm_bits, what="grad"),
            pay(e_bm) + meta_bytes + 8 * n, 40 * n),
        "lorenzo2d.edges": (
            lambda: fused.lorenzo_edges(lz_plane, shape, 0,
                                        from_payload=False, site="lorenzo2d"),
            lambda: fused.lorenzo_edges_plain(lz_plane, (th, tw)),
            4 * n + edge_bytes, 2 * n),
        "lorenzo2d.stencil": (
            lambda: fused.lorenzo_stencil(lz_plane, shape, 0, rowedge, coledge,
                                          "grad", from_payload=False,
                                          site="lorenzo2d"),
            lambda: fused.lorenzo_core(lz_plane, "grad"),
            4 * n + edge_bytes + 8 * n, 6 * n),
        "blockmean2d": (
            lambda: fused.blockmean2d(bm_plane, meta, BLOCK, what="grad"),
            lambda: fused.blockmean_core(bm_plane, meta, BLOCK, "grad"),
            4 * n + meta_bytes + 8 * n, 12 * n),
    }
    out = {}
    for name, (kernel, plain, n_bytes, n_ops) in plans.items():
        k_ms = cuda_ms(kernel, reps)
        p_ms = cuda_ms(plain, max(5, reps // 5))
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        out[name] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "bytes": n_bytes}
        say(f"[{tag}] {name}: {k_ms:.4f} ms (plain {p_ms:.4f} ms, bound "
            f"{b_ms * 1e3:.1f} us by {b_by}, {n_bytes / 1e6:.1f} MB, "
            f"{n_bytes / (k_ms * 1e-3) / 1e9:.0f} GB/s)")
    return out


PER_QUERY = {
    # kernel site -> the query whose launches of it are counted
    "unpack": ("hszp_nd", "Encoded", "mean", Stage.Q),
    "lorenzo_enc2d.edges": ("hszp_nd", "Encoded", "gradient", Stage.Q),
    "lorenzo_enc2d.stencil": ("hszp_nd", "Encoded", "gradient", Stage.Q),
    "blockmean_enc2d": ("hszx_nd", "Encoded", "gradient", Stage.Q),
    "lorenzo2d.edges": ("hszp_nd", "Compressed", "gradient", Stage.Q),
    "lorenzo2d.stencil": ("hszp_nd", "Compressed", "gradient", Stage.Q),
    "blockmean2d": ("hszx_nd", "Compressed", "gradient", Stage.Q),
}

E2E = [
    ("hszp_nd", "Encoded", "mean", Stage.P),
    ("hszp_nd", "Encoded", "gradient", Stage.Q),
    ("hszp_nd", "Encoded", "laplacian", Stage.P),
    ("hszp_nd", "Encoded", "curl", Stage.Q),
    ("hszp_nd", "Compressed", "gradient", Stage.Q),
    ("hszx_nd", "Encoded", "mean", Stage.M),
    ("hszx_nd", "Encoded", "gradient", Stage.Q),
    ("hszx_nd", "Encoded", "laplacian", Stage.Q),
    ("hszx_nd", "Encoded", "divergence", Stage.F),
    ("hszx_nd", "Compressed", "gradient", Stage.Q),
]


def per_query_launches(fields, tag: str) -> dict:
    out = {}
    for site, (scheme, container, op, stage) in PER_QUERY.items():
        fu, fv = fields[scheme][container]
        ops.reset_launches()
        run_cell(op, stage, fu, fv)
        torch.cuda.synchronize()
        out[site] = ops.LAUNCHES[site]
        say(f"[{tag}] {site}: {out[site]} launch(es) per "
            f"{scheme} {container} {op}@{stage.name} query")
    return out


def host_ms(fn, reps: int) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def time_queries(fields, tag: str) -> None:
    for scheme, container, op, stage in E2E:
        fu, fv = fields[scheme][container]
        on = host_ms(lambda: run_cell(op, stage, fu, fv), 10)
        with ops.override_mode("off"):
            off = host_ms(lambda: run_cell(op, stage, fu, fv), 10)
        say(f"[{tag}] e2e {scheme} {container} {op}@{stage.name}: "
            f"{on:.3f} ms (fused rules off: {off:.3f} ms), median of 10")


# ===========================================================================

def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the synthetic Ocean fields")
    args = ap.parse_args()
    t_start = time.perf_counter()

    # 1. the card
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs the "
                         "port on the card only")
    card = nvidia_smi()
    tag = card
    say(card)
    say(f"devices: {torch.cuda.device_count()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    t0 = time.perf_counter()
    build.library()
    say(f"built {build.BUILD_DIR / 'libhsz.so'} in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in build.BUILD_LOG:
        if any(k in line for k in ("registers", "spill", "Compiling entry")):
            say(f"  {line}")

    # 3. kernels against plain versions
    errs: dict[str, float] = {}
    cont = check_kernels(OCEAN, args.seed, errs)
    check_kernels(PADDED, args.seed, errs)

    # 4. main path
    u = synth_field("Ocean", 0, OCEAN, args.seed)
    v = synth_field("Ocean", 1, OCEAN, args.seed)
    ops.reset_launches()
    fields, decomp, results = main_path(u, v)
    launches = dict(ops.LAUNCHES)
    say(f"main path launches: {json.dumps(launches)}")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        fail(f"kernel sites never launched on the main path: {missing}")
    check_main_path(u, v, fields, decomp, results)
    check_ab(fields)

    # 5. times
    times = time_kernels(cont, REPS, tag)
    per_query = per_query_launches(fields, tag)
    time_queries(fields, tag)

    kernels = []
    for name, (source, replaces) in SITES.items():
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "launches_per_query": per_query[name],
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None})
    say(f"total {time.perf_counter() - t_start:.1f} s; card: {card}")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.log").write_text("\n".join(LOG) + "\n")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
