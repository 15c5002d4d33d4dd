#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the root of a checkout: ``python3 chip_smoke.py [--seed N]``.  It
needs one CUDA device and the CUDA toolkit (``nvcc``); without a card it
exits non-zero before it prints any result.

Phases (any failure raises, so the exit code is non-zero):

1. the card: its name, power limit and the device count;
2. build the Hopper kernels from ``src/repro_torch/kernels/csrc`` and print
   ``ptxas``'s register, shared-memory and spill lines, and each band-kernel
   instantiation's shared memory, registers, blocks per SM and SASS count;
3. every kernel of the main path against its plain PyTorch version on the
   card, at the Ocean shape (2400 x 3600, blocks 16 x 16) and a padded one
   (2401 x 3599): bitwise, for every ``what``; both unpack instantiations
   (zigzag values and residuals) at several widths, a ragged length and a
   payload address that is not 16-byte aligned;
   then the block-mean kernels on random planes near Ocean's size at blocks
   (8, 8), (5, 7) and (4, 48), whose edges straddle the kernel's tiles;
4. the kernel entry point (``repro_torch.kernels``: quant_lorenzo2d, pack,
   unpack, block_stats, grad2d, laplacian2d, prefix_stats2d): each kernel
   against its plain version at both shapes (bitwise; prefix_stats2d rtol
   1e-5, bitwise between two launches and bitwise against the exact int64
   sums rounded once to f32; the same for prefix_stats2d on two planes
   wider than 4224 columns), then the entry point driven on
   the Ocean field u and held against the main path's containers and
   stage-③ results on the card;
5. the main path: the two Ocean fields (u, v) through ``compress`` ->
   ``encode`` -> ``decompress`` and every feasible (op, stage) cell of
   ``hszp_nd`` and ``hszx_nd`` for ``Compressed`` and ``Encoded`` containers,
   each held against the port on the CPU; then an A/B pass with the fused
   rules off;
   then the Lorenzo kernels on seeded full-range int32 planes and payloads
   at widths 1, 7, 13, 31 over six shapes (ragged tiles, n1 % 4 != 0, a
   tile row shorter than 32 rows), both passes and every ``what``;
5b. region queries on the same fields (``WINDOWS``: an unaligned sub-basin,
   a three-row transect, windows at the origin and the far corner; an
   aligned one for the stage-① mean): every feasible cell on the first two,
   the stencils and stage-② derivatives on the others, held against the
   port on the CPU; seeded queries (``materialize`` at ② and ③) and queries
   from pre-gathered payload words against the plain region queries,
   bitwise; an A/B pass with the fused rules off; every gathered sub-plane
   fed to ``lorenzo2d`` / ``blockmean2d`` against their plain versions;
5c. the engine path (``repro_torch.analytics``) on eight same-layout Ocean
   fields per scheme (u and v of ``synth_field`` seeds 0-3), ``Compressed``
   and ``Encoded``: (a) ``BatchedAnalytics().run`` of mean / std / gradient
   / laplacian at "auto" and each stage; (b) divergence and curl over four
   (u, v) pairs at ② and ③; (c) ``query(exprs=...)`` of curl, divergence,
   laplacian(u) - laplacian(v) and 2·mean(u) + std(v) over one pair, over a
   ``Compressed`` u beside an ``Encoded`` v, and the flat op set over a
   mixed batch; (d) a ``FieldStore`` holding the eight fields by id: the ③
   op set twice (8 misses, then 8 hits), the ② stencils twice (misses,
   then seeded).  Every result bitwise the per-field ``homomorphic`` calls
   on the card; (a) at "auto", (b) and (c) over the first (u, v) pair
   against the CPU port's same queries; an A/B pass with the fused rules
   off; every query's launches exactly what its plan implies under the
   reference's fused cells (``FUSED_CELLS``: one band-kernel set per field
   and covered op, on a stage-③ seed the stage-③ difference kernel or the
   block-mean kernel over its integers, at most one decode per ``Encoded``
   leaf, no unpack and
   no payload kernel in a seeded or store-hit run); ``n_batches`` /
   ``n_dispatches`` and the store's hits and misses as the reference's
   rules give;
5d. the stream path (``repro_torch.stream``): 64 Ocean timesteps
   (cos(ωt)·u + sin(ωt)·v + noise) appended in 8 slabs of 8 x 2400 x 3600
   to four ``TemporalField`` streams (both n-D schemes, ``Encoded`` and
   ``Compressed``), each in a ``StreamFieldStore`` whose two resident cells
   (full field, sub-basin) are built after the first slab and merged into
   on every later append: after every append the cells equal
   ``summary_from_q`` of the full decompression leaf for leaf and the five
   ops (tdelta, tmean, tmin, tmax, tstd) its postludes, bitwise, and after
   the last ``TemporalField.reference``; storeless queries at "auto", ②, ③
   and ④, a 256 MiB store that evicts and recomputes, and a store-backed
   temporal expression give the same bits; the CPU port on the same slabs
   cropped to 600 x 900 gives the same summaries bitwise; the unpack
   kernel on one slab's payload (69.1 M values) equals its plain version;
   every append and query launches exactly one ``unpack.residuals`` per
   full-field ``Encoded`` slab it summarizes and nothing else;
6. times: each kernel with CUDA events, as device time alone (a CUDA graph
   of the calls, taking turns over copies of the inputs so that they come
   from device memory, not the L2) and as host enqueue per call, its plain
   version, the bound (bytes over 3.35 TB/s or the operations the function
   needs over the card's int32 / f32 lane rates, the larger), launches per
   query, the device kernels of a Lorenzo gradient query, an ``Encoded``
   mean@② query (its decode one unpack kernel) and a ``prefix_stats2d``
   call (our four kernels only) from ``torch.profiler`` traces, and
   end-to-end ms per query and per decompress, and per region query beside
   the full-field one with the plan's closure fraction; the kernels of an
   ``Encoded`` sub-basin gradient@③ query (the gather-unpack's torch ops,
   then the three residual-plane Lorenzo kernels); the stats pass on a
   plane wider than 4224 columns; detail lines time the decode against
   unpack + torch unzigzag and the band kernels for every ``what``; the
   engine's host ms ((a) as one ``run`` against eight single-field
   ``compute`` calls, (c) against the sum of its single-op queries, (d) a
   store miss, and the ③ hit under the port's rule, the reference's rule
   (decode again, then the band kernels) and the torch rules, bitwise
   equal) and a ``torch.profiler`` trace of one (a) call
   per scheme: its kernels, their device µs and the device's busy share of
   the call's window; the stream path's host ms per append (with its two
   merges), per hot query (a resident hit of the five ops) and per cold
   storeless query over 8 slabs, ``torch.profiler`` traces of one append
   and one cold query, and the unpack kernel alone at slab size beside its
   bound.

Launch counters are reset just before each path (entry point, main path,
region path; on the engine and stream paths, each query and append) and
read just after it: each
path must launch every kernel site it runs, every site must be launched on
some path, and the region path must launch no payload kernel and no unpack
(it decodes no full field).

Per-cell detail goes to ``chiprun_out/chip_smoke.log``.  The last two lines
of standard output are a JSON object of per-kernel numbers and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import functools
import json
import pathlib
import re
import statistics
import subprocess
import sys
import time
import warnings

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import analytics  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.core import Stage, by_name, encode, error_analysis  # noqa: E402
from repro_torch.core import blocking, expr, oplib, quantize  # noqa: E402
from repro_torch.core import fused as rules  # noqa: E402
from repro_torch.core import homomorphic as H  # noqa: E402
from repro_torch.core import region as R  # noqa: E402
from repro_torch.data.scientific import dataset_dims, synth_field  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    bitpack, build, fused, ops, prefix_stats, quant_lorenzo, ref, stencil_dq)
from repro_torch.core.stages import LEAVES, Encoded, layout_key  # noqa: E402
from repro_torch.store import FieldStore, materialize  # noqa: E402
from repro_torch.core.oplib import map_summaries  # noqa: E402
from repro_torch.stream import StreamFieldStore, TemporalField  # noqa: E402
from repro_torch.stream.query import _cold_summary, query_temporal  # noqa: E402

#: published H100 SXM device-memory rate (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
#: 32-bit lanes per SM outside the tensor cores (Hopper architecture white
#: paper): 64 INT32, 128 FP32.  With the SM count and the card's maximum SM
#: clock they give the operation rates the bounds use (``card_rates``).
INT32_LANES, FP32_LANES = 64, 128
#: "int32" / "f32" operations per second of this card and its L2 bytes, set
#: by ``card_rates``
RATES: dict[str, float] = {}

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
    "unpack.residuals": (f"{CSRC}/unpack.cu", "src/repro/kernels/bitpack.py:94"),
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
    "pack": (f"{CSRC}/pack.cu", "src/repro/kernels/bitpack.py:67"),
    "quant_lorenzo2d": (f"{CSRC}/quant_lorenzo.cu",
                        "src/repro/kernels/quant_lorenzo.py:54"),
    "block_stats": (f"{CSRC}/block_stats.cu",
                    "src/repro/kernels/block_stats.py:37"),
    "grad2d": (f"{CSRC}/stencil_dq.cu", "src/repro/kernels/stencil_dq.py:66"),
    "laplacian2d": (f"{CSRC}/stencil_dq.cu",
                    "src/repro/kernels/stencil_dq.py:85"),
    "prefix_stats2d.edges": (f"{CSRC}/lorenzo_band.cu",
                             "src/repro/kernels/prefix_stats.py:56"),
    "prefix_stats2d.stats": (f"{CSRC}/lorenzo_band.cu",
                             "src/repro/kernels/prefix_stats.py:56"),
}
#: path -> the kernel sites it must launch
PATHS = {
    "entry point": ("pack", "unpack", "quant_lorenzo2d", "block_stats",
                    "grad2d", "laplacian2d", "prefix_stats2d.edges",
                    "prefix_stats2d.stats"),
    "main path": ("unpack.residuals", "lorenzo_enc2d.edges",
                  "lorenzo_enc2d.stencil",
                  "blockmean_enc2d", "lorenzo2d.edges", "lorenzo2d.stencil",
                  "blockmean2d"),
    "region path": ("lorenzo2d.edges", "lorenzo2d.stencil", "blockmean2d",
                    "grad2d"),
    "engine path": ("unpack.residuals", "lorenzo_enc2d.edges",
                    "lorenzo_enc2d.stencil", "blockmean_enc2d",
                    "lorenzo2d.edges", "lorenzo2d.stencil", "blockmean2d",
                    "grad2d"),
    "stream path": ("unpack.residuals",),
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


def stat_tol(want, field, stage, op: str) -> float:
    """mean / std: rtol 1e-5, or half of the paper's bias bound (1e-3 of it
    where the bound is eps): the f32 reductions run in another order."""
    eps = float(field.eps.item())
    bound = (error_analysis.mean_bias_bound if op == "mean"
             else error_analysis.std_bias_bound)(field, stage)
    return max(1e-5 * abs(float(want)),
               (1e-3 if bound >= eps else 0.5) * bound)


def close_stat(want, got, field, stage, op: str, what: str) -> float:
    """mean / std within :func:`stat_tol`; returns the gap."""
    w, g = float(want), float(got)
    tol = stat_tol(w, field, stage, op)
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
                want = fused.lorenzo_edge_prefixes_plain(plane, tile)
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
        check_unpack(payload, pshape[0] * pshape[1], bits, errs,
                     f"{scheme} payload")
    rng = np.random.default_rng(seed)
    n = shape[0] * shape[1] - 3
    for bits in (1, 5, 13, 16, 17, 31):
        u = torch.as_tensor(rng.integers(0, 1 << bits, n, dtype=np.int64)
                            .astype(np.int32), device=DEVICE)
        words = encode.pack_uniform(u, bits)
        check_unpack(words, n, bits, errs, "random values")
        # a payload address 4 bytes past a 16-byte boundary
        shifted = torch.empty((words.numel() + 1,), dtype=torch.int32,
                              device=DEVICE)
        shifted[1:] = words
        check_unpack(shifted[1:], n, bits, errs, "unaligned payload")
    torch.cuda.synchronize()
    say(f"kernels == plain versions, bitwise, at {shape} "
        f"(bits {out['hszp_nd'][1].bits} / {out['hszx_nd'][1].bits})")
    return out


def check_unpack(words: torch.Tensor, n: int, bits: int, errs: dict,
                 what: str) -> None:
    """Both unpack instantiations against their plain versions, bitwise."""
    _note(errs, "unpack", bitwise_err(
        bitpack.unpack_plain(words, n, bits), bitpack.unpack(words, n, bits),
        f"unpack {what} bits={bits} n={n}"))
    _note(errs, "unpack.residuals", bitwise_err(
        bitpack.unpack_residuals_plain(words, n, bits),
        bitpack.unpack_residuals(words, n, bits),
        f"unpack_residuals {what} bits={bits} n={n}"))


#: block -> (plane near Ocean's size, payload width) for the block-mean
#: tiling check: tile edges (32 x 128) do not line up with these blocks, the
#: last tile row and column are ragged, and n1 % 4 != 0 for (5, 7), so every
#: row takes the scalar-store edge there
BM_TILING = {(8, 8): ((2400, 3592), 13), (5, 7): ((2395, 3598), 31),
             (4, 48): ((2404, 3600), 5)}


def check_blockmean_tiling(seed: int, errs: dict) -> None:
    """Both block-mean kernels on seeded random residuals and block means
    (the full int32 range, so sums wrap) at the blocks of ``BM_TILING``:
    every ``what``, bitwise against the plain versions."""
    rng = np.random.default_rng(seed)
    for block, (shape, bits) in BM_TILING.items():
        lim = 1 << (bits - 1)
        p = torch.as_tensor(rng.integers(-lim, lim, shape, dtype=np.int64)
                            .astype(np.int32), device=DEVICE)
        grid = (shape[0] // block[0], shape[1] // block[1])
        meta = torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, grid,
                                            dtype=np.int64).astype(np.int32),
                               device=DEVICE)
        words = encode.pack_uniform(encode.zigzag(p.reshape(-1)), bits)
        for what in fused.BLOCKMEAN_WHATS:
            _note(errs, "blockmean2d", bitwise_err(
                fused.blockmean_core(p, meta, block, what),
                fused.blockmean2d(p, meta, block, what=what),
                f"blockmean2d {what} {shape} block {block}"))
            _note(errs, "blockmean_enc2d", bitwise_err(
                fused.blockmean_enc2d_plain(words, meta, shape, block, bits,
                                            what=what),
                fused.blockmean_enc2d(words, meta, shape, block, bits,
                                      what=what),
                f"blockmean_enc2d {what} {shape} block {block} bits={bits}"))
    torch.cuda.synchronize()
    say("block-mean kernels == plain versions, bitwise, every what, at "
        + ", ".join(f"{s} block {b} ({w} bits)"
                    for b, (s, w) in BM_TILING.items()))


#: the Lorenzo tiling check: Ocean, ragged tiles, n1 % 4 != 0 (every row on
#: the scalar-store edge) and tile rows shorter than 32 rows; payload widths
LZ_SHAPES = ((2400, 3600), (2401, 3599), (2400, 3598), (33, 129), (31, 127),
             (5, 4099))
LZ_WIDTHS = (1, 7, 13, 31)


def check_lorenzo_tiling(seed: int, errs: dict) -> None:
    """Both Lorenzo passes, both sources and every ``what`` at
    ``LZ_SHAPES``, bitwise against the plain versions: a seeded full-range
    int32 plane (so sums wrap) and payloads packed at ``LZ_WIDTHS``."""
    rng = np.random.default_rng(seed)
    tile = fused.lorenzo_tile()
    for shape in LZ_SHAPES:
        plane = torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, shape,
                                             dtype=np.int64).astype(np.int32),
                                device=DEVICE)
        _note(errs, "lorenzo2d.edges", bitwise_err(
            fused.lorenzo_edge_prefixes_plain(plane, tile),
            fused.lorenzo_edges(plane, shape, 0, from_payload=False,
                                site="lorenzo2d"), f"lorenzo2d edges {shape}"))
        for what in fused.LORENZO_WHATS:
            _note(errs, "lorenzo2d.stencil", bitwise_err(
                fused.lorenzo_core(plane, what),
                fused.lorenzo2d(plane, what=what),
                f"lorenzo2d {what} {shape}"))
        for bits in LZ_WIDTHS:
            lim = 1 << (bits - 1)
            p = torch.as_tensor(rng.integers(-lim, lim, shape, dtype=np.int64)
                                .astype(np.int32), device=DEVICE)
            words = encode.pack_uniform(encode.zigzag(p.reshape(-1)), bits)
            _note(errs, "lorenzo_enc2d.edges", bitwise_err(
                fused.lorenzo_edge_prefixes_plain(p, tile),
                fused.lorenzo_edges(words, shape, bits, from_payload=True,
                                    site="lorenzo_enc2d"),
                f"lorenzo_enc2d edges {shape} bits={bits}"))
            for what in fused.LORENZO_WHATS:
                _note(errs, "lorenzo_enc2d.stencil", bitwise_err(
                    fused.lorenzo_enc2d_plain(words, shape, bits, what=what),
                    fused.lorenzo_enc2d(words, shape, bits, what=what),
                    f"lorenzo_enc2d {what} {shape} bits={bits}"))
    torch.cuda.synchronize()
    say("Lorenzo kernels == plain versions, bitwise, both passes, every what, "
        f"full-range int32 planes and payloads at {LZ_WIDTHS} bits, at "
        + ", ".join(map(str, LZ_SHAPES)))


# ===========================================================================
# phase 4: the kernel entry point
# ===========================================================================

def _note(errs: dict, site: str, err: float) -> None:
    errs[site] = max(errs.get(site, 0.0), err)


def _blocked(q: torch.Tensor) -> torch.Tensor:
    """``(n_blocks, b0*b1)`` rows of the block-padded plane ``q``."""
    b = blocking.to_blocked(blocking.pad_to_blocks(q, BLOCK), BLOCK)
    return b.reshape(-1, BLOCK[0] * BLOCK[1]).contiguous()


def _bit_length(z: torch.Tensor) -> int:
    """Width of the largest zigzag value (int32 patterns read as unsigned)."""
    return int(encode.as_unsigned(z).max().item()).bit_length()


def stat_err(want, got, what: str) -> float:
    """prefix_stats2d: rtol 1e-5 per sum; returns the max absolute gap."""
    err = 0.0
    for w, g in zip(want, got, strict=True):
        w, g = float(w), float(g)
        if not abs(g - w) <= 1e-5 * abs(w):
            fail(f"{what}: {g} vs {w}, over rtol 1e-5")
        err = max(err, abs(g - w))
    return err


def exact_stats(p: torch.Tensor, got, what: str):
    """prefix_stats2d against the exact (Σq, Σq²), summed in int64 on the
    card and rounded once to f32: bitwise, where |q| < 2^26 and both totals
    are below 2^53 (the f64 sums are then exact).  Returns the exact sums."""
    q = torch.cumsum(torch.cumsum(p.to(torch.int64), 0), 1)
    exact = (q.sum(), (q * q).sum())
    if not (int(q.abs().max()) < 2 ** 26
            and max(abs(int(e)) for e in exact) < 2 ** 53):
        fail(f"{what}: |q| or the totals outside the exact range")
    bitwise_err(tuple(e.to(torch.float64).to(torch.float32) for e in exact),
                tuple(got), f"{what} vs exact (Σq, Σq²) rounded once")
    return exact


def check_entry_kernels(shape, seed: int, errs: dict) -> None:
    """Every kernel of the entry point against its plain version on the
    card, on the Ocean field u cut or padded to ``shape``."""
    x = torch.as_tensor(synth_field("Ocean", 0, shape, seed), device=DEVICE)
    eps = quantize.resolve_eps(x, rel_eb=REL_EB)
    p = K.quant_lorenzo2d(x, eps)
    _note(errs, "quant_lorenzo2d", bitwise_err(
        quant_lorenzo.quant_lorenzo2d_plain(x, eps), p,
        f"quant_lorenzo2d {shape}"))
    q = quantize.quantize(x, eps)
    flat = p.reshape(-1)
    odd = flat[:flat.numel() // 37 * 37].reshape(-1, 37)
    for rows in (_blocked(q), odd):
        _note(errs, "block_stats", bitwise_err(
            ref.block_stats(rows), K.block_stats(rows),
            f"block_stats {tuple(rows.shape)}"))
    z = encode.zigzag(flat)
    n = z.numel()
    rng = np.random.default_rng(seed)
    for bits in sorted({_bit_length(z), 1, 5, 13, 31}):
        # the field's own width on its zigzag residuals; other widths on
        # random 32-bit values, so the mask to ``bits`` is exercised
        vals = z if bits == _bit_length(z) else torch.as_tensor(
            rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
            .view(np.int32), device=DEVICE)
        words = K.pack(vals, bits)
        _note(errs, "pack", bitwise_err(bitpack.pack_plain(vals, bits), words,
                                        f"pack bits={bits} n={n}"))
        _note(errs, "unpack", bitwise_err(
            vals & ((1 << bits) - 1), K.unpack(words, n, bits),
            f"unpack(pack) bits={bits} n={n}"))
    _note(errs, "grad2d", bitwise_err(stencil_dq.grad2d_int_plain(q),
                                      stencil_dq.grad2d_int(q),
                                      f"grad2d int planes {shape}"))
    bitwise_err(stencil_dq.grad2d_plain(q, eps), K.grad2d(q, eps),
                f"grad2d {shape}")
    _note(errs, "laplacian2d", bitwise_err(
        stencil_dq.laplacian2d_int_plain(q), stencil_dq.laplacian2d_int(q),
        f"laplacian2d int plane {shape}"))
    bitwise_err(stencil_dq.laplacian2d_plain(q, eps), K.laplacian2d(q, eps),
                f"laplacian2d {shape}")
    th, tw = fused.lorenzo_tile()
    _note(errs, "prefix_stats2d.edges", bitwise_err(
        fused.lorenzo_edge_prefixes_plain(p, (th, tw)),
        fused.lorenzo_edges(p, tuple(p.shape), 0, from_payload=False,
                            site="prefix_stats2d"),
        f"prefix_stats2d edges {shape}"))
    rowedge, coledge, corners = prefix_stats.stats_edges(p)
    bitwise_err(prefix_stats.corner_sums_plain(coledge,
                                               prefix_stats.corner_cols()),
                corners,
                f"prefix_stats2d corner sums {shape}")
    first, again = K.prefix_stats2d(p), K.prefix_stats2d(p)
    bitwise_err(first, again, f"prefix_stats2d twice {shape}")
    _note(errs, "prefix_stats2d.stats", stat_err(
        prefix_stats.prefix_stats2d_plain(p), first,
        f"prefix_stats2d {shape}"))
    exact_stats(p, first, f"prefix_stats2d {shape}")
    torch.cuda.synchronize()
    say(f"entry-point kernels == plain versions at {shape}: bitwise "
        f"(prefix_stats2d within rtol 1e-5, repeatable bitwise, == the "
        f"exact int64 sums rounded once to f32)")


#: prefix_stats2d on planes wider than 33 tiles (4224 columns), where the
#: stats pass sums a tile's corner over more than one step of 128 corner sums
PS_WIDE = ((64, 8300), (2400, 8200))


def bounded_plane(shape, rng) -> torch.Tensor:
    """The Lorenzo residual plane, on the card, of a random q with |q| <
    2^12 (so |q| < 2^26 and the (Σq, Σq²) totals stay below 2^53)."""
    q0 = rng.integers(-2 ** 12, 2 ** 12, shape)
    d = np.diff(np.pad(q0, ((1, 0), (1, 0))), axis=0)
    return torch.as_tensor(np.diff(d, axis=1).astype(np.int32), device=DEVICE)


def check_prefix_stats_wide(seed: int, errs: dict) -> None:
    """prefix_stats2d at ``PS_WIDE``: the corner sums bitwise, the sums
    within rtol 1e-5 of the plain f32 version, bitwise on a second launch and
    bitwise against the exact int64 sums rounded once to f32.  p is the
    Lorenzo residual plane of a bounded q, so that |q| < 2^26 and both
    totals stay below 2^53."""
    rng = np.random.default_rng(seed)
    for shape in PS_WIDE:
        p = bounded_plane(shape, rng)
        _, coledge, corners = prefix_stats.stats_edges(p)
        bitwise_err(prefix_stats.corner_sums_plain(coledge,
                                                   prefix_stats.corner_cols()),
                    corners, f"prefix_stats2d corner sums {shape}")
        first, again = K.prefix_stats2d(p), K.prefix_stats2d(p)
        bitwise_err(first, again, f"prefix_stats2d twice {shape}")
        _note(errs, "prefix_stats2d.stats", stat_err(
            prefix_stats.prefix_stats2d_plain(p), first,
            f"prefix_stats2d {shape}"))
        exact_stats(p, first, f"prefix_stats2d {shape}")
    torch.cuda.synchronize()
    say("prefix_stats2d on wide planes "
        + ", ".join(map(str, PS_WIDE)) + ": == the exact int64 sums rounded "
        "once to f32, within rtol 1e-5 of the plain version, repeatable")


def entry_point_path(x: torch.Tensor, eps: torch.Tensor, bits: int) -> dict:
    """The user's calls of the kernel entry point on one Ocean field on the
    card: the caller resets the counters just before and reads them just
    after."""
    out = {"x": x, "eps": eps, "bits": bits}
    out["p"] = K.quant_lorenzo2d(x, eps)
    out["q"] = quantize.quantize(x, eps)
    out["blocked"] = _blocked(out["q"])
    out["means"], out["maxu"] = K.block_stats(out["blocked"])
    out["z"] = encode.zigzag(out["p"].reshape(-1))
    out["words"] = K.pack(out["z"], bits)
    out["back"] = K.unpack(out["words"], out["z"].numel(), bits)
    out["grad"] = K.grad2d(out["q"], eps)
    out["lap"] = K.laplacian2d(out["q"], eps)
    out["stats"] = K.prefix_stats2d(out["p"])
    torch.cuda.synchronize()
    return out


def check_entry_against_main(u: np.ndarray, r: dict) -> None:
    """The entry point's results against the main path's containers and
    stage-③ results, all on the card (Ocean: no padded blocks)."""
    comp_p, comp_x = by_name("hszp_nd", BLOCK), by_name("hszx_nd", BLOCK)
    cp = comp_p.compress(u, rel_eb=REL_EB, device=DEVICE)
    ep = comp_p.encode(cp)
    cx = comp_x.compress(u, rel_eb=REL_EB, device=DEVICE)
    if tuple(cp.padded_shape) != tuple(u.shape):
        fail(f"entry-point check needs an unpadded field, got {u.shape}")
    bitwise_err(cp.eps, r["eps"], "eps")
    bitwise_err(cp.residuals, r["p"], "quant_lorenzo2d vs hszp_nd residuals")
    bitwise_err(cx.metadata.reshape(-1), r["means"],
                "block_stats means vs hszx_nd metadata")
    zb = r["blocked"].cpu().numpy()
    zig = ((zb << 1) ^ (zb >> 31)).astype(np.uint32).max(axis=1)
    bitwise_err(torch.as_tensor(zig.view(np.int32)), r["maxu"].cpu(),
                "block_stats zigzag max vs numpy")
    if ep.bits != r["bits"]:
        fail(f"payload width {ep.bits} vs {r['bits']}")
    bitwise_err(ep.payload, r["words"], "pack vs Encoded payload")
    bitwise_err(r["z"], r["back"], "unpack(pack) vs zigzag residuals")
    q = comp_p.decompress(cp, Stage.Q)
    bitwise_err(q, r["q"], "stage-3 integers vs quantize")
    qmax = int(q.abs().max().item())
    for scheme, c in (("hszp_nd", cp), ("hszp_nd", ep), ("hszx_nd", cx)):
        kind = type(c).__name__
        bitwise_err(H.derivative(c, Stage.Q, 0), r["grad"][0],
                    f"grad2d d0 vs {scheme} {kind} deriv0@Q")
        bitwise_err(H.derivative(c, Stage.Q, 1), r["grad"][1],
                    f"grad2d d1 vs {scheme} {kind} deriv1@Q")
        bitwise_err(H.laplacian(c, Stage.Q), r["lap"],
                    f"laplacian2d vs {scheme} {kind} laplacian@Q")
    exact = exact_stats(r["p"], r["stats"], "prefix_stats2d on u")
    gap = stat_err(exact, r["stats"], "prefix_stats2d vs exact (Σq, Σq²)")
    torch.cuda.synchronize()
    say(f"entry point == main path at {tuple(u.shape)}: residuals, block "
        f"means, payload words ({ep.bits} bits), grad/laplacian@③ bitwise "
        f"(max |q| {qmax}); (Σq, Σq²) = ({float(r['stats'][0])!r}, "
        f"{float(r['stats'][1])!r}) vs exact ({int(exact[0])}, "
        f"{int(exact[1])}), max |gap| {gap:.6g}")


def require_launches(path: str, launches: dict) -> None:
    say(f"{path} launches: {json.dumps(launches)}")
    missing = [k for k in PATHS[path] if launches[k] == 0]
    if missing:
        fail(f"kernel sites never launched on the {path}: {missing}")


# ===========================================================================
# phase 5: the main path
# ===========================================================================

def feasible(scheme: str):
    cells = [("mean", Stage.M)] if scheme == "hszx_nd" else []
    for stage in (Stage.P, Stage.Q, Stage.F):
        cells += [(op, stage) for op in OPS]
    return cells


def run_cell(op: str, stage: Stage, fu, fv, region=None):
    if op == "mean":
        return H.mean(fu, stage, region=region)
    if op == "std":
        return H.std(fu, stage, region=region)
    if op.startswith("deriv"):
        return H.derivative(fu, stage, int(op[-1]), region=region)
    if op == "gradient":
        return H.gradient(fu, stage, region=region)
    if op == "laplacian":
        return H.laplacian(fu, stage, region=region)
    return getattr(H, op)([fu, fv], stage, region=region)


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


def check_main_path(u, v, fields, decomp, results) -> dict:
    """Hold the card's main path against the port on the CPU; returns the
    CPU containers (scheme -> container -> (u, v))."""
    worst = {}
    hosts = {}
    for scheme in SCHEMES:
        comp = by_name(scheme, BLOCK)
        hu = comp.compress(u, rel_eb=REL_EB, device="cpu")
        hv = comp.compress(v, rel_eb=REL_EB, device="cpu")
        host = {"Compressed": (hu, hv),
                "Encoded": (comp.encode(hu), comp.encode(hv))}
        hosts[scheme] = host
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
    return hosts


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
# phase 5b: region queries
# ===========================================================================

#: the region phase's windows of the Ocean fields: an unaligned interior
#: sub-basin (block-mean cover 1216 x 1808, Lorenzo hull 1808 x 2704), a
#: three-row transect (cover and stage-② axis-0 band 16 x 3600, hull 1216 x
#: 3600), an aligned window for the stage-① mean, a window near the origin
#: (hull 32 x 32) and one at the far corner (hull: the whole field)
R_BASIN = ((600, 1801), (900, 2703))
R_TRANSECT = ((1200, 1203), (0, 3600))
R_ALIGNED = ((800, 1600), (1600, 2400))
R_ORIGIN = ((5, 20), (7, 30))
R_CORNER = ((2390, 2400), (3590, 3600))
WINDOWS = {"basin": R_BASIN, "transect": R_TRANSECT, "origin": R_ORIGIN,
           "corner": R_CORNER}
#: the cells of the origin and corner windows: the stencils whose closures
#: reach the hull's edges, and the stage-② derivatives (bands)
EDGE_CELLS = ([(op, st) for st in (Stage.P, Stage.Q, Stage.F)
               for op in ("gradient", "laplacian")]
              + [("deriv0", Stage.P), ("deriv1", Stage.P)])
#: the op set the seeded and pre-gathered-word queries run
SEED_SET = ("mean", "std", "gradient", "laplacian")
#: kernel sites a region query must never launch: it decodes no full field
NOT_ON_REGIONS = ("lorenzo_enc2d.edges", "lorenzo_enc2d.stencil",
                  "blockmean_enc2d", "unpack.residuals")


def region_cells(scheme: str, name: str):
    if name in ("basin", "transect"):
        return [(op, st) for op, st in feasible(scheme) if st != Stage.M]
    return EDGE_CELLS


def _words(e, region, closure):
    """The region plan's gathered payload words of ``e``, on its device."""
    gi = R.plan_region(e, region, closure).device_gather(e.bits,
                                                         e.payload.device)
    return e.payload.index_select(0, gi.word_idx)


def region_path(fields) -> dict:
    """The user's region calls, all on the card: every cell of
    :func:`region_cells` on each window, the stage-① mean of the aligned
    window, then ``materialize`` at ② and ③ with seeded queries at ②③④, and
    the queries from pre-gathered payload words, on the sub-basin and the
    transect.  The caller reads the launch counters right after."""
    out = {"cells": {}, "plain": {}, "seeded": {}, "words": {}}
    for scheme in SCHEMES:
        for container, (fu, fv) in fields[scheme].items():
            for name, window in WINDOWS.items():
                for op, stage in region_cells(scheme, name):
                    out["cells"][(scheme, container, name, op, stage)] = \
                        run_cell(op, stage, fu, fv, window)
            if scheme == "hszx_nd":
                out["cells"][(scheme, container, "aligned", "mean",
                              Stage.M)] = H.mean(fu, Stage.M, region=R_ALIGNED)
            for name in ("basin", "transect"):
                window = WINDOWS[name]
                seeds = {}
                for stage in (Stage.P, Stage.Q):
                    cl = oplib.set_closure(SEED_SET, fu.scheme, stage)
                    seeds[stage] = materialize(fu, stage, region=window,
                                               closure=cl)
                for stage in (Stage.P, Stage.Q, Stage.F):
                    key = (scheme, container, name, stage)
                    out["plain"][key] = H.compute(fu, SEED_SET, stage,
                                                  region=window)
                    out["seeded"][key] = H.compute(
                        fu, SEED_SET, stage, region=window,
                        seed=seeds[min(stage, Stage.Q)])
                    if container == "Encoded":
                        cl = oplib.set_closure(SEED_SET, fu.scheme, stage)
                        out["words"][key] = H.compute(
                            fu, SEED_SET, stage, region=window,
                            payload_words=_words(fu, window, cl))
    torch.cuda.synchronize()
    return out


def _exact_stat(q_host: torch.Tensor, window, eps: float, op: str) -> float:
    w = q_host[tuple(slice(s, e) for s, e in window)].double()
    v = w.mean() if op == "mean" else w.std()
    return float(v) * 2.0 * eps


def check_region_path(fields, hosts, out) -> None:
    """Hold the card's region cells against the port on the CPU (op sets
    there: one prelude per window and stage), with the tolerances of
    :func:`check_main_path`; a statistic also passes when the card lies no
    farther than the CPU from the exact window statistic (float64 over the
    stage-③ integers).  Seeded and pre-gathered-word queries equal the
    plain region queries bitwise."""
    worst, n, by_exact = {}, 0, 0
    for scheme in SCHEMES:
        comp = by_name(scheme, BLOCK)
        q_host = comp.decompress(hosts[scheme]["Compressed"][0], Stage.Q)
        for container, (hu, hv) in hosts[scheme].items():
            eps = float(hu.eps.item())
            windows = dict(WINDOWS, aligned=R_ALIGNED)
            for name, window in windows.items():
                cells = [k for k in out["cells"]
                         if k[:3] == (scheme, container, name)]
                want = {}
                for stage in {k[4] for k in cells}:
                    if stage == Stage.M:
                        want[("mean", stage)] = H.mean(hu, stage, region=window)
                        continue
                    names = [o for o in ("mean", "std", "gradient", "laplacian")
                             if (scheme, container, name, o, stage) in out["cells"]]
                    if names:
                        got = H.compute(hu, names, stage, region=window)
                        want.update({(o, stage): got[o] for o in names})
                    for axis in (0, 1):
                        if (scheme, container, name, f"deriv{axis}",
                                stage) in out["cells"]:
                            want[(f"deriv{axis}", stage)] = H.derivative(
                                hu, stage, axis, region=window)
                    if (scheme, container, name, "curl", stage) in out["cells"]:
                        got = H.compute([hu, hv], ("divergence", "curl"), stage,
                                        region=window)
                        want[("divergence", stage)] = got["divergence"]
                        want[("curl", stage)] = got["curl"]
                for key in cells:
                    op, stage = key[3], key[4]
                    w, g = want[(op, stage)], to_cpu(out["cells"][key])
                    what = f"region {scheme} {container} {name} {op}@{stage.name}"
                    if op in ("mean", "std"):
                        kind = "stat"
                        try:
                            gap = close_stat(w, g, hu, stage, op, what)
                        except RuntimeError:
                            exact = _exact_stat(q_host, window, eps, op)
                            if abs(float(g) - exact) > abs(float(w) - exact):
                                raise
                            gap = abs(float(g) - float(w))
                            by_exact += 1
                    elif op in ("divergence", "curl"):
                        gap, kind = close_vector(w, g, what), "vector"
                    else:
                        gap, kind = bitwise_err(w, g, what), "stencil"
                    worst[kind] = max(worst.get(kind, 0.0), gap)
                    n += 1
                    detail(f"  {what}: card vs CPU max |diff| {gap:.3g}")
    for kind in ("seeded", "words"):
        for key, got in out[kind].items():
            for op in SEED_SET:
                bitwise_err(out["plain"][key][op], got[op],
                            f"{kind} {key} {op}")
    say(f"region path == CPU port: {n} cells on windows "
        f"{dict(WINDOWS, aligned=R_ALIGNED)}: stencils bitwise, max |diff| "
        f"div/curl {worst['vector']:.3g}, mean/std {worst['stat']:.3g} "
        f"({by_exact} statistics over the tolerance but no farther than the "
        f"CPU from the exact value); seeded ({len(out['seeded'])} at ②③④) and pre-gathered-word "
        f"({len(out['words'])}) op sets == plain region queries, bitwise")


def check_region_ab(fields) -> None:
    """Covered region cells with the fused rules off equal the fused
    results, bitwise."""
    n = 0
    for scheme in SCHEMES:
        for container, (fu, fv) in fields[scheme].items():
            for name, window in WINDOWS.items():
                for op, stage in region_cells(scheme, name):
                    if op in ("mean", "std"):
                        continue
                    got = run_cell(op, stage, fu, fv, window)
                    with ops.override_mode("off"):
                        want = run_cell(op, stage, fu, fv, window)
                    bitwise_err(want, got, f"A/B region {scheme} {container} "
                                f"{name} {op}@{stage.name}")
                    n += 1
    torch.cuda.synchronize()
    say(f"A/B: {n} region cells with the fused rules off == fused, bitwise")


def region_closures(scheme: str):
    return ("cover",) if scheme == "hszx_nd" else ("hull", ("band", 0),
                                                     ("band", 1))


def check_region_kernels(fields, errs: dict) -> None:
    """Every sub-plane the region path gathers (each window and closure),
    from both containers (equal, bitwise), fed to ``fused.lorenzo2d`` (both
    passes) or ``fused.blockmean2d`` for every ``what`` and held bitwise
    against their plain versions."""
    shapes = []
    tile = fused.lorenzo_tile()
    for scheme in SCHEMES:
        c, e = fields[scheme]["Compressed"][0], fields[scheme]["Encoded"][0]
        for name, window in WINDOWS.items():
            for closure in region_closures(scheme):
                plan = R.plan_region(c, window, closure)
                sub = R.extract(c, plan)
                bitwise_err(sub.residuals, R.extract(e, plan).residuals,
                            f"{scheme} {name} {closure} sub-plane: Encoded "
                            f"vs Compressed")
                p = sub.residuals
                shapes.append(f"{scheme} {name} {closure} {tuple(p.shape)}")
                if scheme == "hszx_nd":
                    for what in fused.BLOCKMEAN_WHATS:
                        _note(errs, "blockmean2d", bitwise_err(
                            fused.blockmean_core(p, sub.metadata, BLOCK, what),
                            fused.blockmean2d(p, sub.metadata, BLOCK, what=what),
                            f"blockmean2d {what} region {name} {tuple(p.shape)}"))
                    continue
                _note(errs, "lorenzo2d.edges", bitwise_err(
                    fused.lorenzo_edge_prefixes_plain(p, tile),
                    fused.lorenzo_edges(p, tuple(p.shape), 0, from_payload=False,
                                        site="lorenzo2d"),
                    f"lorenzo2d edges region {name} {tuple(p.shape)}"))
                for what in fused.LORENZO_WHATS:
                    _note(errs, "lorenzo2d.stencil", bitwise_err(
                        fused.lorenzo_core(p, what), fused.lorenzo2d(p, what=what),
                        f"lorenzo2d {what} region {name} {tuple(p.shape)}"))
    torch.cuda.synchronize()
    say("region sub-planes: lorenzo2d / blockmean2d == plain versions, "
        "bitwise, every what: " + "; ".join(shapes))


def time_region_queries(fields, tag: str) -> None:
    """Host-clock ms per region query (median and quartiles of
    ``E2E_REPS``), gradient@③ and mean@② on the sub-basin and the transect,
    beside the full-field query of the same cell and the plan's
    ``closure_fraction``."""
    for scheme in SCHEMES:
        for container, (fu, fv) in fields[scheme].items():
            for op, stage in (("gradient", Stage.Q), ("mean", Stage.P)):
                full = host_ms(lambda: run_cell(op, stage, fu, fv), E2E_REPS)
                parts = [f"full field {_spread(full)}"]
                for name in ("basin", "transect"):
                    window = WINDOWS[name]
                    t = host_ms(lambda: run_cell(op, stage, fu, fv, window),
                                E2E_REPS)
                    frac = R.closure_fraction(fu, op, stage, window)
                    parts.append(f"{name} {_spread(t)} (closure fraction "
                                 f"{frac:.4f})")
                say(f"[{tag}] e2e region {scheme} {container} {op}@{stage.name}: "
                    + "; ".join(parts) + f", median of {E2E_REPS}")


#: the Lorenzo kernels of a region gradient@③ query, in order (residual
#: plane instantiations: no payload kernel, no unpack)
REGION_LZ_KERNELS = ("lorenzo_edges_kernel<false>", "lorenzo_scan_kernel",
                     "lorenzo_stencil_kernel<false")


def region_query_kernels(fields, tag: str) -> None:
    """The device kernels of one ``Encoded`` sub-basin Lorenzo gradient@③
    query from a ``torch.profiler`` trace: the gather-unpack's torch ops,
    then the three residual-plane Lorenzo kernels, then the float tail."""
    eu, ev = fields["hszp_nd"]["Encoded"]
    names, events = traced_kernels(
        lambda: run_cell("gradient", Stage.Q, eu, ev, R_BASIN))
    first = next((i for i, k in enumerate(names)
                  if k.startswith("lorenzo_")), None)
    ours = names[first:first + 3] if first is not None else []
    if (len(ours) != 3
            or any(not k.startswith(w) for k, w in zip(ours, REGION_LZ_KERNELS))
            or any(k.startswith(("unpack_kernel", "blockmean_kernel"))
                   or "<true" in k for k in names)):
        fail(f"Encoded region gradient@Q: kernels {names}")
    say(f"[{tag}] hszp_nd Encoded gradient@Q on the sub-basin, device "
        f"kernels: {first} of the gather-unpack "
        f"({_listed(names[:first], events[:first])}); then "
        f"{_listed(names[first:first + 3], events[first:first + 3])}; then "
        f"{len(names) - first - 3} ({_listed(names[first + 3:], events[first + 3:])})")


# ===========================================================================
# phase 5c: the engine path — batched op sets, expression DAGs, the store
# ===========================================================================

#: synth_field seeds (added to --seed) of the engine phase's fields: u and v
#: of each, eight same-layout fields per scheme and container
ENGINE_SEEDS = (0, 1, 2, 3)
#: query (a)'s op set, at "auto" and at each of its feasible stages
ENGINE_SET = ("mean", "std", "gradient", "laplacian")
SET_STAGES = (Stage.P, Stage.Q, Stage.F)
#: query (b)'s op set over the four (u, v) pairs, and its stages
VECTOR_SET = ("divergence", "curl")
VECTOR_STAGES = (Stage.P, Stage.Q)
#: query (d)'s runs over the store, in order: (op set, stage)
STORE_RUNS = {"Q miss": (ENGINE_SET, Stage.Q), "Q hit": (ENGINE_SET, Stage.Q),
              "P miss": (("gradient", "laplacian"), Stage.P),
              "P seeded": (("gradient", "laplacian"), Stage.P)}
#: the store's budget: the eight fields' ③ and ② materializations fit
STORE_BYTES = 1 << 30
#: kernel sites a seeded or store-hit run must never launch
PAYLOAD_SITES = ("lorenzo_enc2d.edges", "lorenzo_enc2d.stencil",
                 "blockmean_enc2d", "unpack.residuals")


def engine_fields(seed: int) -> dict:
    """scheme -> container -> eight fields ``[u0, v0, u1, v1, ...]`` on the
    card (``synth_field`` seeds ``seed + ENGINE_SEEDS``), the ``Encoded``
    ones packed at the widest of their eight widths so that all eight share
    one layout."""
    data = [synth_field("Ocean", f, OCEAN, seed + s)
            for s in ENGINE_SEEDS for f in (0, 1)]
    out = {}
    for scheme in SCHEMES:
        comp = by_name(scheme, BLOCK)
        cs = [comp.compress(d, rel_eb=REL_EB, device=DEVICE) for d in data]
        bits = max(comp.max_bits(c) for c in cs)
        out[scheme] = {"Compressed": cs,
                       "Encoded": [comp.encode(c, bits=bits) for c in cs]}
    return out


def on_host(c):
    """A container's copy on the CPU, leaf for leaf."""
    return dataclasses.replace(c, **{n: getattr(c, n).cpu()
                                     for n in LEAVES[type(c).__name__]})


def engine_exprs(u, v) -> list:
    """Query (c)'s roots over one (u, v) pair."""
    return [expr.curl((u, v)), expr.divergence((u, v)),
            expr.laplacian(u) - expr.laplacian(v),
            expr.scale(expr.mean(u), 2.0) + expr.std(v)]


def composed(u, v, stage) -> list:
    """The per-field homomorphic calls query (c)'s roots compose, in the
    expressions' order of operations."""
    return [H.curl([u, v], stage), H.divergence([u, v], stage),
            H.laplacian(u, stage) - H.laplacian(v, stage),
            H.mean(u, stage) * 2.0 + H.std(v, stage)]


def flat_query(*args, **kw):
    """The flat form of ``query`` (op sets grouped by layout; deprecated in
    favour of expressions), its warning silenced."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return analytics.query(*args, **kw)


def counted(fn, *args, **kw):
    """``fn(*args, **kw)`` with the launch counters set to 0 just before it
    and read just after: ``(result, launches)``."""
    ops.reset_launches()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    return out, dict(ops.LAUNCHES)


def mixed_batch(fields, scheme) -> list:
    """The flat mixed-layout batch of query (c): Compressed and Encoded
    fields taking turns."""
    f = fields[scheme]
    return [f["Compressed"][0], f["Encoded"][1], f["Compressed"][2],
            f["Encoded"][3]]


def engine_path(fields, eng) -> dict:
    """The user's engine-layer calls on the card, each counted on its own:
    (a) the op set over the eight fields per scheme and container, at
    "auto" and at each explicit stage; (b) divergence and curl over the four
    ``Encoded`` (u, v) pairs at ② and ③; (c) the expression queries over
    one ``Encoded`` pair, then over a ``Compressed`` u beside an ``Encoded``
    v, and the flat op set over a mixed batch; (d) a ``FieldStore`` holding
    the eight ``Encoded`` fields by id: the ③ op set twice (misses, then
    hits), then the ② stencil set twice (misses, then the seeded run)."""
    out = {}
    for scheme in SCHEMES:
        enc, cmp_ = fields[scheme]["Encoded"], fields[scheme]["Compressed"]
        for container, fs in (("Encoded", enc), ("Compressed", cmp_)):
            for st in ("auto",) + SET_STAGES:
                out[("a", scheme, container, st)] = counted(
                    eng.run, fs, ENGINE_SET, st)
        pairs = list(zip(enc[0::2], enc[1::2]))
        for st in VECTOR_STAGES:
            out[("b", scheme, st)] = counted(eng.run, pairs, VECTOR_SET, st)
        for name, (u, v) in (("Encoded", (enc[0], enc[1])),
                             ("mixed", (cmp_[0], enc[1]))):
            out[("c", scheme, name)] = counted(
                analytics.query, exprs=engine_exprs(u, v), engine=eng)
        out[("c", scheme, "flat")] = counted(
            flat_query, mixed_batch(fields, scheme), ENGINE_SET, engine=eng)
        store = FieldStore(cache_bytes=STORE_BYTES)
        ids = [store.put(f"{scheme}/{i}", f) for i, f in enumerate(enc)]
        for run, (ops_, st) in STORE_RUNS.items():
            out[("d", scheme, run)] = counted(
                flat_query, ids, list(ops_), st, engine=eng, store=store)
    return out


# -- what the plans imply ---------------------------------------------------

#: the fused cells of the reference's Table I rules
#: (``src/repro/core/fused.py``, its DERIVATIVE / GRADIENT / LAPLACIAN
#: registries): op -> the (stage, family) cells a kernel serves on 2-D n-D
#: fields.  Written out here, not read from the port's registry, so that a
#: cell dropped from the port shows as a launch count off its plan.
FUSED_CELLS = {
    "derivative": {(s, f) for s in (Stage.P, Stage.Q, Stage.F)
                   for f in ("lorenzo", "blockmean")},
    "gradient": {(s, f) for s in (Stage.P, Stage.Q, Stage.F)
                 for f in ("lorenzo", "blockmean")},
    "laplacian": {(Stage.P, "lorenzo"), (Stage.P, "blockmean"),
                  (Stage.Q, "blockmean"), (Stage.F, "blockmean")},
}


def _band_sites(scheme: str, payload: bool) -> tuple[str, ...]:
    if scheme == "hszp_nd":
        site = "lorenzo_enc2d" if payload else "lorenzo2d"
        return (f"{site}.edges", f"{site}.stencil")
    return ("blockmean_enc2d",) if payload else ("blockmean2d",)


def _op_sites(op: str, container: str, scheme: str, stage: Stage,
              seed) -> tuple[str, ...]:
    """The kernel sites one application of ``op`` (a field op, or
    ``derivative`` for a vector op's component) launches once each; empty
    where its torch rule runs.  A covered cell runs the payload kernels on
    an unseeded ``Encoded`` field and the plane kernels on residuals
    otherwise; on a stage-③ seed, the derivatives and gradients run the
    stage-③ difference kernel on the resident integers and the (block-mean)
    laplacian the block-mean kernel over them (``core/fused.py``)."""
    family = "lorenzo" if scheme == "hszp_nd" else "blockmean"
    if (Stage(stage), family) not in FUSED_CELLS.get(op, ()):
        return ()
    if seed == Stage.Q:
        return ("blockmean2d",) if op == "laplacian" else ("grad2d",)
    return _band_sites(scheme, container == "Encoded" and seed is None)


def expected_launches(contexts) -> dict:
    """Launches per site that a list of stage contexts implies.  A context
    ``(container, scheme, stage, seed, ops)`` (``seed`` None or the seed's
    stage; ``ops`` its op applications, a vector op as one ``derivative``
    per differentiated axis) launches :func:`_op_sites` per application,
    and decodes its payload once when an op whose torch rule runs reads
    the residuals or integers (every torch rule but the stage-① mean) and
    no seed holds them."""
    want = dict.fromkeys(PATHS["engine path"], 0)
    for container, scheme, stage, seed, ops_ in contexts:
        for op in ops_:
            for site in _op_sites(op, container, scheme, stage, seed):
                want[site] += 1
        if container == "Encoded" and seed is None and any(
                not _op_sites(op, container, scheme, stage, seed)
                and not (op == "mean" and stage == Stage.M) for op in ops_):
            want["unpack.residuals"] += 1
    return want


def _component_ops(ops_, n: int = 2) -> list[list[str]]:
    """A vector op set's derivative applications on each component."""
    per = [[] for _ in range(n)]
    for op in ops_:
        for i, axes in enumerate(oplib.OPS[op].component_axes(n)):
            per[i] += ["derivative"] * len(axes)
    return per


def plan_contexts(key, res, fields) -> list:
    """The stage contexts a query's plan implies (see
    :func:`expected_launches`)."""
    kind, scheme = key[0], key[1]
    if kind == "a":
        stage = analytics.plan_stages(scheme, ENGINE_SET, key[3]).fused
        return [(key[2], scheme, stage, None, ENGINE_SET)] * 8
    if kind == "b":
        return [("Encoded", scheme, key[2], None, ops_)
                for _ in range(4) for ops_ in _component_ops(VECTOR_SET)]
    if kind == "c" and key[2] == "flat":
        return [(type(f).__name__, scheme, res.stages[i]["mean"], None,
                 ENGINE_SET) for i, f in enumerate(mixed_batch(fields, scheme))]
    if kind == "c":
        program = expr.analyze(res.exprs)
        bindings = [lf.source for lf in program.leaves]
        stages = analytics.plan_expr(program, bindings).stages
        out = []
        for slot, b in enumerate(bindings):
            stage = stages[program.leaf_component[slot]]
            names = [n for n, _ in program.leaf_consumers(slot)]
            if isinstance(b, tuple):
                out += [(type(c).__name__, scheme, stage, None, o)
                        for c, o in zip(b, _component_ops(names, len(b)))]
            else:
                out.append((type(b).__name__, scheme, stage, None, names))
        return out
    ops_, stage = STORE_RUNS[key[2]]
    seeded = [("Encoded", scheme, stage, min(stage, Stage.Q), ops_)] * 8
    if key[2].endswith("miss"):
        # each miss materializes the field once: one decode, no band kernel
        return [("Encoded", scheme, stage, None, ["std"])] * 8 + seeded
    return seeded


def check_engine_launches(fields, out) -> dict:
    """Every query's launches against what its plan implies; returns the
    engine path's launches per site (summed over its queries)."""
    total = dict.fromkeys(ops.LAUNCHES, 0)
    for key, (res, got) in out.items():
        want = expected_launches(plan_contexts(key, res, fields))
        bad = {k: (got[k], want.get(k, 0)) for k in got
               if got[k] != want.get(k, 0)}
        if bad:
            fail(f"engine {key}: launches (got, plan) {bad}")
        if key[0] == "d" and not key[2].endswith("miss"):
            stray = [k for k in PAYLOAD_SITES if got[k]]
            if stray:
                fail(f"engine {key}: a seeded run launched {stray}")
        if key[0] == "c" and key[2] != "flat":
            leaves = [lf.source for lf in expr.analyze(res.exprs).leaves]
            n_enc = sum(isinstance(c, Encoded) for b in leaves
                        for c in (b if isinstance(b, tuple) else (b,)))
            if got["unpack.residuals"] > n_enc:
                fail(f"engine {key}: {got['unpack.residuals']} decodes for "
                     f"{n_enc} Encoded leaf contexts")
        for k, n in got.items():
            total[k] += n
        detail(f"  engine {key}: launches "
               f"{json.dumps({k: n for k, n in got.items() if n})}")
    say(f"engine path: the launches of its {len(out)} queries == their "
        f"plans' (one band-kernel set per field and covered op, at most one "
        f"decode per Encoded leaf, no unpack and no payload kernel in the "
        f"seeded and store-hit runs)")
    return total


def expected_counts(items, ops_, store_backed: bool) -> tuple[int, int]:
    """``(n_batches, n_dispatches)`` of a flat query by the reference's
    rules: one batch per (layout, store-backed) group, and per batch one
    dispatch when the op set has a shared feasible stage, else one per op."""
    scheme = items[0].scheme
    shared = set.intersection(*(set(analytics.feasible_stages(scheme, o))
                                for o in ops_))
    groups = {(layout_key(i), store_backed) for i in items}
    return len(groups), len(groups) * (1 if shared else len(ops_))


# -- values -------------------------------------------------------------------

def _per_field_set(f, stage) -> dict:
    """The homomorphic calls (a) batches, one field at a time."""
    return {"mean": H.mean(f, stage), "std": H.std(f, stage),
            "gradient": H.gradient(f, stage),
            "laplacian": H.laplacian(f, stage)}


def _item(batched, i):
    return (tuple(x[i] for x in batched) if isinstance(batched, tuple)
            else batched[i])


def check_engine_values(fields, out) -> None:
    """Every engine-path result bitwise the per-field homomorphic calls on
    the card (query (d) against (a)'s results at its stage); the counts and
    the store's hits and misses those of the reference's rules."""
    n = 0
    for scheme in SCHEMES:
        for container in ("Encoded", "Compressed"):
            for st in ("auto",) + SET_STAGES:
                got = out[("a", scheme, container, st)][0]
                stage = analytics.plan_stages(scheme, ENGINE_SET, st).fused
                for i, f in enumerate(fields[scheme][container]):
                    want = _per_field_set(f, stage)
                    for op in ENGINE_SET:
                        n += 1
                        bitwise_err(want[op], _item(got[op], i),
                                    f"(a) {scheme} {container} {st} {op} {i}")
        enc, cmp_ = fields[scheme]["Encoded"], fields[scheme]["Compressed"]
        for st in VECTOR_STAGES:
            got = out[("b", scheme, st)][0]
            for i, (u, v) in enumerate(zip(enc[0::2], enc[1::2])):
                for op in VECTOR_SET:
                    n += 1
                    bitwise_err(getattr(H, op)([u, v], st), got[op][i],
                                f"(b) {scheme} {op}@{st.name} pair {i}")
        for name, (u, v) in (("Encoded", (enc[0], enc[1])),
                             ("mixed", (cmp_[0], enc[1]))):
            res = out[("c", scheme, name)][0]
            if (res.n_batches, res.n_dispatches) != (1, 1):
                fail(f"(c) {scheme} {name}: counts {res.n_batches}, "
                     f"{res.n_dispatches}, the reference's rules give 1, 1")
            for i, (w, g) in enumerate(zip(composed(u, v, res.stages[0]),
                                           res.values, strict=True)):
                n += 1
                bitwise_err(w, g, f"(c) {scheme} {name} root {i}")
        res = out[("c", scheme, "flat")][0]
        batch = mixed_batch(fields, scheme)
        if (res.n_batches, res.n_dispatches) != expected_counts(
                batch, ENGINE_SET, False):
            fail(f"(c) {scheme} flat mixed: counts {res.n_batches}, "
                 f"{res.n_dispatches}")
        for i, f in enumerate(batch):
            want = _per_field_set(f, res.stages[i]["mean"])
            for op in ENGINE_SET:
                n += 1
                bitwise_err(want[op], res.values[i][op],
                            f"(c) {scheme} flat mixed {op} {i}")
        for run, (ops_, st) in STORE_RUNS.items():
            res = out[("d", scheme, run)][0]
            hits = 0 if run.endswith("miss") else 8
            if ((res.store_hits, res.store_misses) != (hits, 8 - hits)
                    or (res.n_batches, res.n_dispatches) != expected_counts(
                        enc, ops_, True)):
                fail(f"(d) {scheme} {run}: hits {res.store_hits}, misses "
                     f"{res.store_misses}, counts {res.n_batches}, "
                     f"{res.n_dispatches}")
            ref = out[("a", scheme, "Encoded", st)][0]
            for i in range(8):
                for op in ops_:
                    n += 1
                    bitwise_err(_item(ref[op], i), res.values[i][op],
                                f"(d) {scheme} {run} {op} {i}")
    torch.cuda.synchronize()
    say(f"engine path == per-field homomorphic calls on the card, bitwise "
        f"({n} results); counts and store hits/misses as the reference's "
        f"rules give")


#: fields of each engine batch that the CPU port recomputes: the first
#: (u, v) pair.  All eight are held bitwise to the per-field calls on the
#: card, which the main path holds to the CPU port cell by cell.
CPU_FIELDS = 2


def check_engine_cpu(fields, out) -> None:
    """The CPU port's same queries over the first (u, v) pair of each
    batch: (a) at "auto", (b) at ② and ③, (c); stencils bitwise, div/curl
    and combinations rtol 1e-6, statistics the slice tolerances.  (a)'s
    other stages are held to the per-field calls on the card."""
    hosts = {s: {c: [on_host(f) for f in fs[:CPU_FIELDS]]
                 for c, fs in d.items()} for s, d in fields.items()}
    cpu = analytics.BatchedAnalytics()
    worst = {"stat": 0.0, "vector": 0.0}
    for scheme in SCHEMES:
        for container, hs in hosts[scheme].items():
            got = out[("a", scheme, container, "auto")][0]
            stage = analytics.plan_stages(scheme, ENGINE_SET, "auto").fused
            want = cpu.run(hs, ENGINE_SET, "auto")
            for op in ENGINE_SET:
                for i, h in enumerate(hs):
                    what = f"(a) CPU {scheme} {container} auto {op} {i}"
                    if op in ("mean", "std"):
                        worst["stat"] = max(worst["stat"], close_stat(
                            want[op][i], got[op][i].cpu(), h, stage, op,
                            what))
                    else:
                        bitwise_err(_item(want[op], i),
                                    to_cpu(_item(got[op], i)), what)
        henc, hcmp = hosts[scheme]["Encoded"], hosts[scheme]["Compressed"]
        for st in VECTOR_STAGES:
            got = out[("b", scheme, st)][0]
            want = cpu.run(list(zip(henc[0::2], henc[1::2])), VECTOR_SET, st)
            for op in VECTOR_SET:
                for i in range(CPU_FIELDS // 2):
                    worst["vector"] = max(worst["vector"], close_vector(
                        want[op][i], got[op][i].cpu(),
                        f"(b) CPU {scheme} {op}@{st.name} pair {i}"))
        for name, (hu, hv) in (("Encoded", (henc[0], henc[1])),
                               ("mixed", (hcmp[0], henc[1]))):
            res = out[("c", scheme, name)][0]
            stage = res.stages[0]
            cres = analytics.query(exprs=engine_exprs(hu, hv), engine=cpu)
            for i, (g, c) in enumerate(zip(res.values, cres.values,
                                           strict=True)):
                what = f"(c) CPU {scheme} {name} root {i}"
                if i < 3:
                    worst["vector"] = max(worst["vector"],
                                          close_vector(c, g.cpu(), what))
                    continue
                # 2·mean(u) + std(v): the two statistics' tolerances
                tol = (2 * stat_tol(H.mean(hu, stage), hu, stage, "mean")
                       + stat_tol(H.std(hv, stage), hv, stage, "std"))
                gap = abs(float(g) - float(c))
                if not gap <= tol:
                    fail(f"{what}: |{float(g)} - {float(c)}| > {tol}")
                worst["stat"] = max(worst["stat"], gap)
    say(f"engine path == the CPU port's same queries: stencils bitwise, max "
        f"|diff| div/curl and combinations {worst['vector']:.3g}, mean/std "
        f"{worst['stat']:.3g}")


def check_engine_ab(fields, out) -> None:
    """Queries (a)-(c) with the fused rules off (a fresh engine: the kernel
    mode is in the program key) equal the fused results, bitwise."""
    n = 0
    with ops.override_mode("off"):
        eng = analytics.BatchedAnalytics()
        for key, (res, _) in out.items():
            if key[0] == "a":
                f = fields[key[1]][key[2]]
                got = eng.run(f, ENGINE_SET, key[3])
                for op in ("gradient", "laplacian"):
                    bitwise_err(got[op], res[op], f"A/B engine {key} {op}")
            elif key[0] == "b":
                enc = fields[key[1]]["Encoded"]
                got = eng.run(list(zip(enc[0::2], enc[1::2])), VECTOR_SET,
                              key[2])
                for op in VECTOR_SET:
                    bitwise_err(got[op], res[op], f"A/B engine {key} {op}")
            elif key[0] == "c" and key[2] != "flat":
                got = analytics.query(exprs=list(res.exprs), engine=eng)
                for i, (g, w) in enumerate(zip(got.values, res.values)):
                    bitwise_err(g, w, f"A/B engine {key} root {i}")
            else:
                continue
            n += 1
    torch.cuda.synchronize()
    say(f"A/B: {n} engine queries with the fused rules off == fused, bitwise")


# -- times --------------------------------------------------------------------

def _compute_each(fields, ops_, stage) -> list:
    """One ``oplib.compute`` call per field: the loop a batch replaces."""
    return [oplib.compute(f, ops_, stage) for f in fields]


def _store_query(fields, ops_, stage, eng, store=None):
    """The flat op set by id over ``fields`` through ``store``; with no
    store, through a fresh one holding them, so that every field misses."""
    if store is None:
        store = FieldStore(cache_bytes=STORE_BYTES)
        for i, f in enumerate(fields):
            store.put(f"f{i}", f)
    return flat_query([f"f{i}" for i in range(len(fields))], list(ops_),
                      stage, engine=eng, store=store)


def time_engine(fields, tag: str) -> None:
    """Host ms (median and quartiles of ``E2E_REPS``): (a) as one ``run``
    against eight single-field ``compute`` calls; (c) against the sum of its
    single-op queries; (d) a store miss (fresh store) against a hit."""
    eng = analytics.BatchedAnalytics()
    part = functools.partial
    for scheme in SCHEMES:
        for container in ("Encoded", "Compressed"):
            fs = fields[scheme][container]
            batch = host_ms(part(eng.run, fs, ENGINE_SET, "auto"), E2E_REPS)
            single = host_ms(part(_compute_each, fs, ENGINE_SET, Stage.P),
                             E2E_REPS)
            one = host_ms(part(oplib.compute, fs[0], ENGINE_SET, Stage.P),
                          E2E_REPS)
            say(f"[{tag}] engine (a) {scheme} {container} {list(ENGINE_SET)}"
                f"@auto(②) over 8 fields: one run {_spread(batch)}; 8 "
                f"compute calls {_spread(single)}; one compute call "
                f"{_spread(one)}; median of {E2E_REPS}")
        enc = fields[scheme]["Encoded"]
        u, v = enc[0], enc[1]
        whole = host_ms(part(analytics.query, exprs=engine_exprs(u, v),
                             engine=eng), E2E_REPS)
        parts = [host_ms(fn, E2E_REPS) for fn in (
            part(H.curl, [u, v], Stage.P), part(H.divergence, [u, v], Stage.P),
            part(H.laplacian, u, Stage.P), part(H.laplacian, v, Stage.P),
            part(H.mean, u, Stage.P), part(H.std, v, Stage.P))]
        total = sum(statistics.median(t) for t in parts)
        say(f"[{tag}] engine (c) {scheme} Encoded 4 roots @auto(②): one "
            f"query {_spread(whole)}; its 6 single-op queries, summed "
            f"medians {total:.3f} ms; median of {E2E_REPS}")
        hot = FieldStore(cache_bytes=STORE_BYTES)
        for i, f in enumerate(enc):
            hot.put(f"f{i}", f)
        t_miss = host_ms(part(_store_query, enc, ENGINE_SET, Stage.Q, eng),
                         E2E_REPS)
        say(f"[{tag}] engine (d) {scheme} Encoded ③ op set by id over 8 "
            f"fields: miss (fresh store) {_spread(t_miss)}; median of "
            f"{E2E_REPS}")
        time_q_hit(enc, hot, eng, scheme, tag)


@contextlib.contextmanager
def reference_rule():
    """The reference's rule for a stage-③ seed: every covered stencil
    decodes the field again for its residuals and runs the residual-plane
    band kernels."""
    real = rules._q_seeded
    rules._q_seeded = lambda ctx: False
    try:
        yield
    finally:
        rules._q_seeded = real


def time_q_hit(enc, store, eng, scheme: str, tag: str) -> None:
    """The ③ store hit of query (d) under three rules, in one process:
    the stage-③ difference kernel on the resident integers (the port's),
    the reference's rule, and the torch rules (``override_mode("off")``).
    Each rule's results equal the port's bitwise; host ms, median and
    quartiles of ``E2E_REPS``, and the launches of one hit beside them."""
    want = _store_query(enc, ENGINE_SET, Stage.Q, eng, store).values
    parts = []
    for name, mode in (("resident-integer kernels", contextlib.nullcontext),
                       ("reference's rule", reference_rule),
                       ("torch rules", functools.partial(ops.override_mode,
                                                         "off"))):
        with mode():
            res, got = counted(_store_query, enc, ENGINE_SET, Stage.Q, eng,
                               store)
            if res.store_hits != 8:
                fail(f"(d) {scheme} ③ hit under the {name}: "
                     f"{res.store_hits} hits")
            for i in range(8):
                for op in ENGINE_SET:
                    bitwise_err(want[i][op], res.values[i][op],
                                f"(d) {scheme} ③ hit, {name}, {op} {i}")
            t = host_ms(functools.partial(_store_query, enc, ENGINE_SET,
                                          Stage.Q, eng, store), E2E_REPS)
        parts.append(f"{name} {_spread(t)}, launches "
                     f"{json.dumps({k: n for k, n in got.items() if n})}")
    say(f"[{tag}] engine (d) {scheme} Encoded ③ hit over 8 fields, results "
        f"equal bitwise: " + "; ".join(parts) + f"; median of {E2E_REPS}")


def trace_window(fn, label: str) -> tuple[list, float, float]:
    """``fn()`` and a synchronize under one ``record_function`` in a
    ``torch.profiler`` trace: ``(device kernels, busy µs, window µs)``,
    busy being the union of the kernels' spans inside the window."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(label):
            fn()
            torch.cuda.synchronize()
    events = prof.events()
    window = next(e for e in events if e.name == label
                  and e.device_type == torch.autograd.DeviceType.CPU)
    w0, w1 = window.time_range.start, window.time_range.end
    kernels = [e for e in events if e.name != label
               and e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        fail(f"torch.profiler recorded no device kernel for {label}")
    spans = sorted((max(e.time_range.start, w0), min(e.time_range.end, w1))
                   for e in kernels)
    busy, end = 0.0, w0
    for s, e in spans:  # the union of the kernels' spans
        s = max(s, end)
        if e > s:
            busy += e - s
            end = e
    return kernels, busy, w1 - w0


def engine_trace(fields, tag: str) -> None:
    """A ``torch.profiler`` trace of one (a) call per scheme (``Encoded``,
    "auto") and of one (d) ③ hit: the device kernels by name with their
    count and device µs, and the device's busy share of the call's
    window."""
    eng = analytics.BatchedAnalytics()
    for scheme in SCHEMES:
        fs = fields[scheme]["Encoded"]
        hot = FieldStore(cache_bytes=STORE_BYTES)
        for i, f in enumerate(fs):
            hot.put(f"f{i}", f)
        calls = {"(a) {} Encoded @auto(②)": functools.partial(
                     eng.run, fs, ENGINE_SET, "auto"),
                 "(d) {} Encoded ③ hit": functools.partial(
                     _store_query, fs, ENGINE_SET, Stage.Q, eng, hot)}
        for what, fn in calls.items():
            for _ in range(2):
                fn()
            torch.cuda.synchronize()
            kernels, busy, span = trace_window(fn, "engine.query")
            say(f"[{tag}] engine {what.format(scheme)} trace: "
                + trace_lines(kernels, busy, span))


# ===========================================================================
# phase 5d: the stream path — TemporalField, StreamFieldStore, query_temporal
# ===========================================================================

#: 64 Ocean timesteps in 8 slabs of k = 8 (the 3-D block's time extent, so
#: the time axis has no padding).  Timestep t is cos(ωt)·u + sin(ωt)·v plus
#: noise N(0, (0.01·std u)²) from numpy's generator seeded with --seed.
STREAM_SLABS, STREAM_K = 8, 8
STREAM_OMEGA = 2 * np.pi / (STREAM_SLABS * STREAM_K)
TOPS = ("tdelta", "tmean", "tmin", "tmax", "tstd")
#: the ingest store's two cells per stream: the full field and the sub-basin
STREAM_CELLS = {"full": None, "basin": R_BASIN}
#: container -> the stream's payload policy
STREAM_BITS = {"Encoded": "auto", "Compressed": None}
#: the ingest store's budget: one stream's full-field cell (6 int32 planes
#: of 2400 x 3600, 207.36 MB) and its sub-basin cell (51.97 MB)
STREAM_STORE_BYTES = 512 << 20
#: the eviction check's budget: the store's default, 256 MiB, holds one
#: stream's two cells (259.3 MB) but not two streams' four
EVICT_BYTES = 256 << 20
#: the CPU parity check: the same slabs cropped to 8 x 600 x 900, and a
#: window of the crop
STREAM_CROP = (600, 900)
CROP_WINDOW = ((150, 451), (225, 676))
#: repetitions of the hot (resident) and cold (storeless) query timings
HOT_REPS, COLD_REPS = 30, 10


def stream_slabs(u: np.ndarray, v: np.ndarray, seed: int):
    """The 8 slabs, made on the card one at a time: (STREAM_K, *OCEAN) f32.
    One worker thread draws the next slab's noise while the card works on
    this one (one generator, drawn in order: the same numbers every run)."""
    rng = np.random.default_rng(seed)
    ud = torch.as_tensor(u, device=DEVICE)
    vd = torch.as_tensor(v, device=DEVICE)
    sigma = np.float32(0.01 * np.std(u, dtype=np.float64))

    def draw():
        return rng.standard_normal((STREAM_K,) + OCEAN, dtype=np.float32)

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        pending = pool.submit(draw)
        for i in range(STREAM_SLABS):
            noise = torch.as_tensor(pending.result(), device=DEVICE)
            if i + 1 < STREAM_SLABS:
                pending = pool.submit(draw)
            t = STREAM_OMEGA * np.arange(i * STREAM_K, (i + 1) * STREAM_K)
            c = torch.as_tensor(np.cos(t), dtype=torch.float32, device=DEVICE)
            s = torch.as_tensor(np.sin(t), dtype=torch.float32, device=DEVICE)
            yield (c[:, None, None] * ud + s[:, None, None] * vd
                   + sigma * noise)


def stream_query(store, fid: str, region=None, stage="auto"):
    """The five temporal ops by id through ``store`` (the flat form)."""
    return flat_query([fid], list(TOPS), stage, store=store,
                      region=region).values[0]


def stream_expected(container: str, full_slabs: int) -> dict:
    """Launches of a stream call that summarizes ``full_slabs`` slabs over
    the full field: one ``unpack.residuals`` each for an ``Encoded``
    stream; a region cell gathers its words with torch ops, a
    ``Compressed`` slab has nothing to decode, no band kernel runs."""
    want = dict.fromkeys(ops.LAUNCHES, 0)
    if container == "Encoded":
        want["unpack.residuals"] = full_slabs
    return want


def check_stream_launches(what: str, got: dict, want: dict) -> None:
    if got != want:
        diff = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
        fail(f"{what}: launches (got, want) {diff}")


def _window(region) -> tuple:
    return (slice(None),) + tuple(slice(s, e) for s, e in region)


def oracle_summaries(tf) -> dict:
    """cell -> ``summary_from_q`` of the stream's full decompression on the
    card (± the window): what the merged summaries must equal bitwise."""
    q = tf.decompress_q()
    return {cell: oplib.summary_from_q(q if region is None
                                       else q[_window(region)])
            for cell, region in STREAM_CELLS.items()}


def same_summary(want, got, what: str) -> None:
    for name in ("count", "q_sum", "q_sumsq", "q_min", "q_max", "last2"):
        bitwise_err(getattr(want, name), getattr(got, name), f"{what} {name}")


def same_ops(want: dict, got: dict, what: str) -> None:
    for op in TOPS:
        bitwise_err(want[op], got[op], f"{what} {op}")


def stream_path(u, v, seed: int) -> dict:
    """Ingest the 64 timesteps into four streams (both n-D schemes,
    ``Encoded`` and ``Compressed``), each in its own ``StreamFieldStore``:
    after the first slab the five ops over the full field and the sub-basin
    build the two resident cells; each later append merges the new slab
    into both, and the same queries hit them.  Every append and query is
    counted on its own and held to its plan's launches; after every append
    the resident summaries equal, leaf for leaf and bitwise, the reduction
    over the stream's full decompression, and the served ops its postludes.
    """
    eng = analytics.BatchedAnalytics()
    keys = [(s, c) for s in SCHEMES for c in STREAM_BITS]
    out = {"eng": eng, "streams": {}, "stores": {}, "served": {},
           "append_ms": {k: [] for k in keys}, "crops": [],
           "launches": dict.fromkeys(ops.LAUNCHES, 0)}
    for scheme, container in keys:
        tf = TemporalField(scheme, rel_eb=REL_EB, bits=STREAM_BITS[container],
                           device=DEVICE)
        store = StreamFieldStore(STREAM_STORE_BYTES, engine=eng)
        store.put_temporal(f"{scheme}/{container}", tf)
        out["streams"][(scheme, container)] = tf
        out["stores"][(scheme, container)] = store

    def count(what, want, fn, *args, **kw):
        res, got = counted(fn, *args, **kw)
        check_stream_launches(what, got, want)
        for k, n in got.items():
            out["launches"][k] += n
        return res

    for i, slab in enumerate(stream_slabs(u, v, seed)):
        out["crops"].append(slab[:, :STREAM_CROP[0], :STREAM_CROP[1]].cpu()
                            .numpy())
        for key in keys:
            scheme, container = key
            tf, store = out["streams"][key], out["stores"][key]
            fid = f"{scheme}/{container}"
            merges0 = store.incremental_merges
            t0 = time.perf_counter()
            count(f"5d {fid} append {i}",
                  stream_expected(container, 1 if i else 0),
                  store.append, fid, slab)
            if i:
                out["append_ms"][key].append((time.perf_counter() - t0) * 1e3)
            if store.incremental_merges - merges0 != (2 if i else 0):
                fail(f"5d {fid} append {i}: {store.incremental_merges - merges0}"
                     " incremental merges, want 2 per append after the first")
            for cell, region in STREAM_CELLS.items():
                full = 1 if i == 0 and region is None else 0
                out["served"][(key, cell)] = count(
                    f"5d {fid} {cell} query after append {i}",
                    stream_expected(container, full),
                    stream_query, store, fid, region)
            if store.summary_rebuilds != 2:
                fail(f"5d {fid}: {store.summary_rebuilds} summary rebuilds "
                     "after the first queries, want 2")
            oracle = oracle_summaries(tf)
            for cell, region in STREAM_CELLS.items():
                what = f"5d {fid} {cell} after append {i}"
                same_summary(oracle[cell],
                             store.temporal_summary(fid, region=region), what)
                same_ops(oplib.temporal_postlude(TOPS, oracle[cell], tf.eps),
                         out["served"][(key, cell)], what)
            del oracle
    for key, tf in out["streams"].items():
        if tf.n_steps != STREAM_SLABS * STREAM_K or tf.n_slabs != STREAM_SLABS:
            fail(f"5d {key}: {tf.n_slabs} slabs, {tf.n_steps} steps")
        for cell, region in STREAM_CELLS.items():
            same_ops(tf.reference(TOPS, region=region),
                     out["served"][(key, cell)],
                     f"5d {key} {cell} served == TemporalField.reference")
    widths = {k: [s.bits for s in tf.slabs] for k, tf in out["streams"].items()
              if k[1] == "Encoded"}
    say(f"stream path: 4 streams x {STREAM_SLABS} slabs of {STREAM_K} x "
        f"{OCEAN[0]} x {OCEAN[1]}; after every append both resident cells == "
        f"summary_from_q of the full decompression leaf for leaf and the five "
        f"ops == its postludes, bitwise; after the last == "
        f"TemporalField.reference, bitwise; eps "
        + ", ".join(f"{k[0]} {float(tf.eps):.6g}"
                    for k, tf in out["streams"].items() if k[1] == "Encoded")
        + f"; Encoded slab widths {json.dumps({k[0]: w for k, w in widths.items()})}"
        + f"; |q| <= {max(tf._q_abs_max for tf in out['streams'].values())}")
    return out


def check_stream_storeless(out) -> None:
    """Storeless ``query_temporal`` at "auto" and explicit ②, ③, ④ give the
    served bits for every stream and cell, each with its plan's launches
    (eight decodes for a full-field ``Encoded`` query, none otherwise)."""
    eng = out["eng"]
    n = 0
    for key, tf in out["streams"].items():
        for cell, region in STREAM_CELLS.items():
            for stage in ("auto", Stage.P, Stage.Q, Stage.F):
                res, got = counted(query_temporal, [tf], list(TOPS), stage,
                                   region=region, engine=eng)
                check_stream_launches(
                    f"5d storeless {key} {cell} @{stage}", got,
                    stream_expected(key[1], STREAM_SLABS if region is None
                                    else 0))
                same_ops(out["served"][(key, cell)], res.values[0],
                         f"5d storeless {key} {cell} @{stage}")
                n += 1
    say(f"stream path: {n} storeless queries (auto, ②, ③, ④) == the served "
        "results, bitwise, with their plans' launches")


def check_stream_eviction(out) -> None:
    """A store at the default 256 MiB holding both ``Encoded`` streams: the
    four cells (518.7 MB) do not fit, so each query of two rounds evicts and
    the next recomputes — to the served bits."""
    store = StreamFieldStore(EVICT_BYTES, engine=out["eng"])
    keys = [(s, "Encoded") for s in SCHEMES]
    for key in keys:
        store.put_temporal(f"{key[0]}/x", out["streams"][key])
    for rnd in range(2):
        for key in keys:
            for cell, region in STREAM_CELLS.items():
                fid = f"{key[0]}/x"
                res = flat_query([fid], list(TOPS), store=store,
                                 region=region)
                if rnd and res.store_misses != 1:
                    fail(f"5d eviction {fid} {cell}: not recomputed")
                same_ops(out["served"][(key, cell)], res.values[0],
                         f"5d eviction {fid} {cell} round {rnd}")
    if store.stats.evictions == 0:
        fail("5d eviction: the 256 MiB store evicted nothing")
    say(f"stream path: 256 MiB store, 2 streams x 2 cells, 2 rounds: "
        f"{store.summary_rebuilds} rebuilds, {store.stats.evictions} "
        f"evictions, every recomputed result == served, bitwise")


def check_stream_exprs(out) -> None:
    """``query(exprs=[tmean("a") - tmean("b"), tdelta(stream)])``, a and b
    by id in a store, the stream a raw ``Compressed`` one: equal to the
    served values composed by hand, bitwise; its launches: the two
    ``Encoded`` ids' summaries (8 decodes each), nothing for the raw
    ``Compressed`` stream."""
    store = StreamFieldStore(1 << 30, engine=out["eng"])
    a, b = ("hszp_nd", "Encoded"), ("hszx_nd", "Encoded")
    c = ("hszp_nd", "Compressed")
    store.put_temporal("a", out["streams"][a])
    store.put_temporal("b", out["streams"][b])
    res, got = counted(analytics.query, exprs=[
        expr.tmean("a") - expr.tmean("b"),
        expr.tdelta(out["streams"][c])], store=store, engine=out["eng"])
    check_stream_launches("5d expressions", got,
                          stream_expected("Encoded", 2 * STREAM_SLABS))
    sa, sb = out["served"][(a, "full")], out["served"][(b, "full")]
    bitwise_err(sa["tmean"] - sb["tmean"], res.values[0],
                "5d tmean(a) - tmean(b)")
    bitwise_err(out["served"][(c, "full")]["tdelta"], res.values[1],
                "5d tdelta(stream)")
    say(f"stream path: query(exprs=[tmean(a) - tmean(b), tdelta(stream)]) "
        f"store-backed == composed by hand, bitwise; {res.n_dispatches} "
        "program calls")


def check_stream_cpu(out) -> None:
    """The crop streams (8 slabs of 8 x 600 x 900) on the card and in the
    CPU port from the same numpy slabs: summaries bitwise (full crop and a
    window), the five ops within ``error_analysis.temporal_round_bound``."""
    worst = 0.0
    eng_cpu = analytics.BatchedAnalytics()
    for scheme in SCHEMES:
        for container, bits in STREAM_BITS.items():
            card = TemporalField(scheme, rel_eb=REL_EB, bits=bits,
                                 device=DEVICE)
            cpu = TemporalField(scheme, rel_eb=REL_EB, bits=bits,
                                device="cpu")
            for crop in out["crops"]:
                card.append(crop)
                cpu.append(crop)
            for region in (None, CROP_WINDOW):
                what = f"5d CPU {scheme} {container} crop {region}"
                stage = analytics.plan_stage(card.scheme, "tmean", "auto")
                s_card = _cold_summary(card, stage, region, out["eng"])[0]
                s_cpu = _cold_summary(cpu, stage, region, eng_cpu)[0]
                same_summary(s_cpu, map_summaries(lambda x: x.cpu(), s_card),
                             what)
                v_card = out["eng"].run_temporal(TOPS, s_card, card.eps)
                v_cpu = eng_cpu.run_temporal(TOPS, s_cpu, cpu.eps)
                for op in TOPS:
                    tol = error_analysis.temporal_round_bound(op, s_cpu,
                                                              cpu.eps)
                    diff = (v_card[op].cpu().double()
                            - v_cpu[op].double()).abs()
                    if bool((diff > tol).any()):
                        fail(f"{what} {op}: max |diff| {float(diff.max())}")
                    worst = max(worst, float(diff.max()))
    say(f"stream path == the CPU port on the same numpy slabs cropped to "
        f"{STREAM_SLABS} x {STREAM_K} x {STREAM_CROP[0]} x {STREAM_CROP[1]}: "
        f"summaries bitwise, max |diff| of the five ops {worst:.3g}")


def check_stream_unpack(out, errs: dict) -> dict:
    """``unpack_kernel<true>`` on one full slab's payload (69.1 M values) at
    the slab's width, against its plain version; returns the slab's
    payload for the timing."""
    e = out["streams"][("hszp_nd", "Encoded")].slabs[-1]
    n = int(np.prod(e.padded_shape))
    got = bitpack.unpack_residuals(e.payload, n, e.bits)
    want = bitpack.unpack_residuals_plain(e.payload, n, e.bits)
    _note(errs, "unpack.residuals",
          bitwise_err(want, got, f"unpack.residuals slab ({n} values, "
                                 f"{e.bits} bits)"))
    say(f"unpack.residuals on one slab payload ({n} values at {e.bits} bits)"
        " == its plain version, bitwise")
    return {"payload": e.payload, "n": n, "bits": e.bits}


def time_stream(out, slab: dict, tag: str) -> dict:
    """Host ms of the appends (7 per stream), the hot query (resident hit)
    of the five ops and the cold storeless query over 8 slabs; the unpack
    kernel alone at slab size beside its bound.  Returns the slab-size
    kernel row."""
    for key, tf in out["streams"].items():
        fid = f"{key[0]}/{key[1]}"
        store = out["stores"][key]
        t = sorted(out["append_ms"][key])
        parts = [f"append with its 2 merges {_spread(t)} over "
                 f"{len(t)} appends"]
        for cell, region in STREAM_CELLS.items():
            hot = host_ms(functools.partial(stream_query, store, fid, region),
                          HOT_REPS)
            parts.append(f"hot {cell} query {_spread(hot)} of {HOT_REPS}")
        cold = host_ms(functools.partial(query_temporal, [tf], list(TOPS),
                                         engine=out["eng"]), COLD_REPS)
        parts.append(f"cold storeless full-field query over {STREAM_SLABS} "
                     f"slabs {_spread(cold)} of {COLD_REPS}")
        say(f"[{tag}] stream {fid}: " + "; ".join(parts))
    w, n, bits = slab["payload"], slab["n"], slab["bits"]
    fn = functools.partial(bitpack.unpack_residuals, w, n, bits)
    k_ms = cuda_ms(fn, REPS)
    g_ms = graph_ms(lambda x: bitpack.unpack_residuals(x, n, bits), REPS, (w,))
    p_ms = cuda_ms(functools.partial(bitpack.unpack_residuals_plain, w, n,
                                     bits), 3)
    n_bytes = 4 * w.numel() + 4 * n
    b_ms, b_by = bound_ms(n_bytes, 5 * n)  # take out 2, unzigzag 3
    say(f"[{tag}] unpack.residuals at slab size ({n} values, {bits} bits): "
        f"{k_ms * 1e3:.1f} us by events, device alone {g_ms * 1e3:.1f} us "
        f"(plain {p_ms * 1e3:.1f} us, bound {b_ms * 1e3:.1f} us by {b_by}, "
        f"{n_bytes / 1e6:.1f} MB, {n_bytes / (g_ms * 1e-3) / 1e9:.0f} GB/s "
        "device alone)")
    return {"values": n, "bits": bits, "ms": k_ms, "graph_ms": g_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "bytes": n_bytes}


def trace_lines(kernels, busy: float, span: float, top_n: int = 10) -> str:
    """One trace's kernels by name with count and device µs, and the
    device's busy share of its window."""
    by_name_ = {}
    for e in kernels:
        name = re.sub(r"^void |\(anonymous namespace\)::|\(.*$", "", e.name)
        cnt, us = by_name_.get(name, (0, 0.0))
        by_name_[name] = (cnt + 1, us + e.device_time)
    top = sorted(by_name_.items(), key=lambda kv: -kv[1][1])
    return (f"{len(kernels)} kernels, device busy {busy:.1f} of {span:.1f} us "
            f"({busy / span:.1%}); by device time: "
            + ", ".join(f"{k} x{c} {us:.1f} us" for k, (c, us) in top[:top_n])
            + (f"; {len(top) - top_n} more names" if len(top) > top_n else ""))


def stream_trace(out, tag: str) -> None:
    """``torch.profiler`` traces of one append (both cells resident, so two
    merges) and of one cold storeless query over 8 slabs, per ``Encoded``
    stream: the device ops by name and the device's busy share."""
    for scheme in SCHEMES:
        tf = out["streams"][(scheme, "Encoded")]
        # a scratch stream on the last slab's data: the traced append must
        # not change the checked streams
        slab = tf.compressor.decompress(tf.slabs[-1], Stage.F)
        scratch = TemporalField(scheme, eps=tf.eps, bits=tf._bits,
                                device=DEVICE)
        store = StreamFieldStore(STREAM_STORE_BYTES, engine=out["eng"])
        store.put_temporal("s", scratch)
        store.append("s", slab)
        for region in STREAM_CELLS.values():
            stream_query(store, "s", region)
        store.append("s", slab)
        torch.cuda.synchronize()
        kernels, busy, span = trace_window(
            functools.partial(store.append, "s", slab), "stream.append")
        say(f"[{tag}] stream {scheme} Encoded append trace: "
            + trace_lines(kernels, busy, span))
        kernels, busy, span = trace_window(
            functools.partial(query_temporal, [tf], list(TOPS),
                              engine=out["eng"]), "stream.cold")
        say(f"[{tag}] stream {scheme} Encoded cold query trace: "
            + trace_lines(kernels, busy, span))
        del slab, scratch, store


# ===========================================================================
# phase 6: times
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


def graph_ms(fn, reps: int, args: tuple = (), *, cold: bool = True) -> float:
    """ms per call of the device work alone: ``reps`` calls of ``fn(*args)``
    captured in one CUDA graph and replayed, so no host dispatch sits
    between launches.  With ``cold`` the calls take turns over copies of the
    tensors in ``args``, so many that the copies read between two reads of
    one copy exceed twice the L2: each call reads its inputs from device
    memory, as a query does (one 35 MB plane replayed would stay in the
    H100's 50 MB L2)."""
    sets = [args]
    in_bytes = sum(a.numel() * a.element_size() for a in args
                   if isinstance(a, torch.Tensor))
    if cold and in_bytes:
        k = min(reps, 1 + -(-2 * RATES["l2_bytes"] // in_bytes))
        sets += [tuple(a.clone() if isinstance(a, torch.Tensor) else a
                       for a in args) for _ in range(k - 1)]
    fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for r in range(reps):
            fn(*sets[r % len(sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def enqueue_ms(fn, reps: int) -> float:
    """Host ms per call to enqueue ``fn`` (the wrapper's dispatch); when it
    exceeds the kernel's time, ``cuda_ms`` measures the host."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / reps


def card_rates() -> dict[str, float]:
    """int32 and f32 operations per second of card 0: lanes per SM x SMs x
    the maximum SM clock that ``nvidia-smi`` reports; and its L2 bytes."""
    out = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    hz = float(out.stdout.strip()) * 1e6
    props = torch.cuda.get_device_properties(0)
    sms = props.multi_processor_count
    return {"int32": INT32_LANES * sms * hz, "f32": FP32_LANES * sms * hz,
            "sms": sms, "clock_hz": hz, "l2_bytes": props.L2_cache_size}


def bound_ms(n_bytes: int, int_ops: int, f32_ops: int = 0) -> tuple[float, str]:
    """The least time for the work: bytes over the memory rate, or int32 and
    f32 lane operations over the card's lane rates, the larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = (int_ops / RATES["int32"] + f32_ops / RATES["f32"]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


#: time_kernels' name for the stats pass at ``PS_WIDE[1]``
WIDE_STATS = "prefix_stats2d.stats (2400 x 8200)"


def time_kernels(cont: dict, entry: dict, reps: int, tag: str) -> dict:
    """Kernel and plain-version times at the Ocean shape (what = grad for
    the band kernels: the gradient query's call; the entry point's kernels
    on the inputs of its run)."""
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
    rowedge, coledge = fused.lorenzo_edges(lz_words, shape, lz_bits,
                                           from_payload=True,
                                           site="lorenzo_enc2d")
    x, eps, bits = entry["x"], entry["eps"], entry["bits"]
    inv = (1.0 / (2.0 * eps)).reshape(())
    z, q, p, blocked = entry["z"], entry["q"], entry["p"], entry["blocked"]
    nb, s_len = blocked.shape
    m = (n0 - 2) * (n1 - 2)
    ps_edges = prefix_stats.stats_edges(p)
    corner_bytes = 4 * ps_edges[2].numel()
    # the stats pass on a plane wider than 4224 columns launches
    # prefix_stats_tile_kernel<true>
    pw = bounded_plane(PS_WIDE[1], np.random.default_rng(0))
    nw = pw.numel()
    pw_edges = prefix_stats.stats_edges(pw)
    # Operations are those the function needs per element, not what an
    # implementation adds (64-bit bit offsets, edge masks, index math):
    # taking a value out of staged payload words is a shift and a mask (2;
    # the funnel shifts that build a 64-bit window serve several values);
    # unzigzag (z >> 1) ^ -(z & 1) is a shift, the low bit sign-extended
    # (one bfe.s32) and an xor (3); a prefix or a sum adds 1 per element.
    # Integer operations run on the int32 lanes.
    plans = {
        # name: (kernel, its tensor arguments, plain version, bytes, int32
        # operations[, f32 operations])
        "unpack": (  # take out: 2
            lambda w: bitpack.unpack(w, n, lz_bits), (lz_words,),
            lambda: bitpack.unpack_plain(lz_words, n, lz_bits),
            pay(e_lz) + 4 * n, 2 * n),
        "unpack.residuals": (  # take out 2, unzigzag 3
            lambda w: bitpack.unpack_residuals(w, n, lz_bits), (lz_words,),
            lambda: bitpack.unpack_residuals_plain(lz_words, n, lz_bits),
            pay(e_lz) + 4 * n, 5 * n),
        "lorenzo_enc2d.edges": (  # take out 2, unzigzag 3, row and column sums 2
            lambda w: fused.lorenzo_edges(w, shape, lz_bits, from_payload=True,
                                          site="lorenzo_enc2d"), (lz_words,),
            lambda: fused.lorenzo_edge_prefixes_plain(encode.unzigzag(
                bitpack.unpack_plain(lz_words, n, lz_bits)).reshape(shape),
                (th, tw)),
            pay(e_lz) + edge_bytes, 7 * n),
        "lorenzo_enc2d.stencil": (  # take out 2, unzigzag 3, D0 and D1 2,
            # deriv0 and deriv1 2
            lambda w, r, c: fused.lorenzo_stencil(
                w, shape, lz_bits, r, c, "grad", from_payload=True,
                site="lorenzo_enc2d"), (lz_words, rowedge, coledge),
            lambda: fused.lorenzo_enc2d_plain(lz_words, shape, lz_bits,
                                              what="grad"),
            pay(e_lz) + edge_bytes + 8 * n, 9 * n),
        "blockmean_enc2d": (  # take out 2, unzigzag 3, two differences of p
            # and of the means and their sums 6
            lambda w, m: fused.blockmean_enc2d(w, m, shape, BLOCK, bm_bits,
                                               what="grad"), (bm_words, meta),
            lambda: fused.blockmean_enc2d_plain(bm_words, meta, shape, BLOCK,
                                                bm_bits, what="grad"),
            pay(e_bm) + meta_bytes + 8 * n, 11 * n),
        "lorenzo2d.edges": (  # row and column sums 2
            lambda x: fused.lorenzo_edges(x, shape, 0, from_payload=False,
                                          site="lorenzo2d"), (lz_plane,),
            lambda: fused.lorenzo_edge_prefixes_plain(lz_plane, (th, tw)),
            4 * n + edge_bytes, 2 * n),
        "lorenzo2d.stencil": (  # D0 and D1 2, deriv0 and deriv1 2
            lambda x, r, c: fused.lorenzo_stencil(
                x, shape, 0, r, c, "grad", from_payload=False,
                site="lorenzo2d"), (lz_plane, rowedge, coledge),
            lambda: fused.lorenzo_core(lz_plane, "grad"),
            4 * n + edge_bytes + 8 * n, 4 * n),
        "blockmean2d": (  # two differences of p and of the means, sums 6
            lambda x, m: fused.blockmean2d(x, m, BLOCK, what="grad"),
            (bm_plane, meta),
            lambda: fused.blockmean_core(bm_plane, meta, BLOCK, "grad"),
            4 * n + meta_bytes + 8 * n, 6 * n),
        "pack": (  # mask, shift into place, or into the word 3
            lambda v: K.pack(v, bits), (z,),
            lambda: bitpack.pack_plain(z, bits),
            4 * n + 4 * encode.words_for(n, bits), 3 * n),
        "quant_lorenzo2d": (  # q - q_up - q_left + q_upleft 3; f32 multiply
            # and round-to-int 2
            quant_lorenzo.quant_lorenzo_kernel, (x, inv),
            lambda: quant_lorenzo.quant_lorenzo2d_plain(x, eps),
            4 * n + 4 + 4 * n, 3 * n, 2 * n),
        "block_stats": (  # sum 1, zigzag 3, unsigned max 1
            K.block_stats, (blocked,),
            lambda: ref.block_stats(blocked),
            4 * nb * s_len + 8 * nb, 5 * nb * s_len),
        "grad2d": (  # two differences
            stencil_dq.grad2d_int, (q,),
            lambda: stencil_dq.grad2d_int_plain(q),
            4 * n + 8 * m, 2 * m),
        "laplacian2d": (  # three sums, 4q as a shift, one difference
            stencil_dq.laplacian2d_int, (q,),
            lambda: stencil_dq.laplacian2d_int_plain(q),
            4 * n + 4 * m, 5 * m),
        "prefix_stats2d.edges": (  # row and column sums 2
            lambda v: prefix_stats.stats_edges(v), (p,),
            lambda: fused.lorenzo_edge_prefixes_plain(p, (th, tw)),
            4 * n + edge_bytes + corner_bytes, 2 * n),
        "prefix_stats2d.stats": (  # q from two prefixes 2; f32 cast, q², two
            # sums 4
            prefix_stats.prefix_stats_tiles, (p, *ps_edges),
            lambda: prefix_stats.prefix_stats2d_plain(p),
            4 * n + edge_bytes + corner_bytes + 8, 2 * n, 4 * n),
        WIDE_STATS: (  # as above, at PS_WIDE[1]
            prefix_stats.prefix_stats_tiles, (pw, *pw_edges),
            lambda: prefix_stats.prefix_stats2d_plain(pw),
            4 * nw + 4 * sum(t.numel() for t in pw_edges) + 8, 2 * nw, 4 * nw),
    }
    out = {}
    for name, (fn, args, plain, n_bytes, *n_ops) in plans.items():
        kernel = functools.partial(fn, *args)
        k_ms = cuda_ms(kernel, reps)
        g_ms = graph_ms(fn, reps, args)
        w_ms = graph_ms(fn, reps, args, cold=False)
        h_ms = enqueue_ms(kernel, reps)
        p_ms = cuda_ms(plain, max(5, reps // 5))
        b_ms, b_by = bound_ms(n_bytes, *n_ops)
        out[name] = {"ms": k_ms, "graph_ms": g_ms, "enqueue_ms": h_ms,
                     "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "bytes": n_bytes}
        say(f"[{tag}] {name}: {k_ms * 1e3:.1f} us by events, device alone "
            f"{g_ms * 1e3:.1f} us (L2-warm {w_ms * 1e3:.1f} us), enqueue "
            f"{h_ms * 1e3:.1f} us (plain {p_ms * 1e3:.1f} us, bound "
            f"{b_ms * 1e3:.1f} us by {b_by}, {n_bytes / 1e6:.1f} MB, "
            f"{n_bytes / (g_ms * 1e-3) / 1e9:.0f} GB/s device alone)")
    time_decode(e_lz, reps, tag)
    time_blockmean_whats(bm_words, bm_bits, bm_plane, meta, reps, tag)
    time_lorenzo_whats(lz_words, lz_bits, lz_plane, reps, tag)
    return out


def time_decode(e, reps: int, tag: str) -> None:
    """Detail line: one ``decode_device`` of an ``Encoded`` field as a whole
    (one ``unpack_residuals`` launch), against the decode it replaced — the
    zigzag unpack followed by the torch ``unzigzag``, four elementwise
    kernels that read and write the plane — and those four alone; device
    time alone (cold) and enqueue per call."""
    n = e.padded_shape[0] * e.padded_shape[1]
    z = bitpack.unpack(e.payload, n, e.bits)

    def before(w):
        return encode.unzigzag(bitpack.unpack(w, n, e.bits))

    rows = (("decode_device", lambda w: encode.decode_device(
                 dataclasses.replace(e, payload=w)), (e.payload,)),
            ("unpack + torch unzigzag", before, (e.payload,)),
            ("torch unzigzag alone", encode.unzigzag, (z,)))
    parts = []
    for name, fn, args in rows:
        g_ms = graph_ms(fn, reps, args)
        h_ms = enqueue_ms(functools.partial(fn, *args), reps)
        parts.append(f"{name} {g_ms * 1e3:.1f} us (enqueue {h_ms * 1e3:.1f} us)")
    say(f"[{tag}] decode at {tuple(e.padded_shape)}, {e.bits} bits, device "
        f"alone: " + "; ".join(parts))


def time_blockmean_whats(words, bits, plane, meta, reps: int, tag: str) -> None:
    """Detail lines: both block-mean kernels for every ``what`` at the Ocean
    shape (the kernels line keeps ``grad``): CUDA events over back-to-back
    calls as ``time_kernels`` times them, the device time alone (CUDA
    graph), the host's enqueue time per call, and the card's own time for
    writing the same output planes (``fill_``)."""
    shape = tuple(plane.shape)
    n = plane.numel()
    for what in fused.BLOCKMEAN_WHATS:
        n_out = 2 if what == "grad" else 1
        fill = torch.empty((n_out, n), dtype=torch.int32, device=plane.device)
        fill_ms = cuda_ms(lambda: fill.fill_(1), reps)
        for site, src, from_payload, kernel in (
                ("blockmean_enc2d", words, True,
                 lambda w, m: fused.blockmean_enc2d(w, m, shape, BLOCK, bits,
                                                    what=what)),
                ("blockmean2d", plane, False,
                 lambda x, m: fused.blockmean2d(x, m, BLOCK, what=what))):
            k_ms = cuda_ms(lambda: kernel(src, meta), reps)
            g_ms = graph_ms(kernel, reps, (src, meta))
            h_ms = enqueue_ms(lambda: kernel(src, meta), reps)
            n_bytes = (4 * src.numel() + 4 * meta.numel() + 4 * n * n_out)
            b_ms, _ = bound_ms(n_bytes, 0)
            smem, per_sm = fused.blockmean_launch_config(from_payload, what)
            # (bytes only: at its few integer operations per element the
            # block-mean kernel is bound by bytes for every what)
            say(f"[{tag}] {site} {what}: {k_ms * 1e3:.1f} us, device alone "
                f"{g_ms * 1e3:.1f} us, enqueue {h_ms * 1e3:.1f} us (bound "
                f"{b_ms * 1e3:.1f} us; fill_ of the {n_out} output plane(s) "
                f"{fill_ms * 1e3:.1f} us; {smem} B shared memory, {per_sm} "
                f"blocks/SM)")


#: int32 operations per element of the Lorenzo stencil pass for each what
#: from the residuals: prefixes D0 / D1 1 each, then a sum (deriv0,
#: deriv1), two sums (grad) or two differences and a sum (lap)
LZ_OPS = {"deriv0": 2, "deriv1": 2, "grad": 4, "lap": 5}


def time_lorenzo_whats(words, bits, plane, reps: int, tag: str) -> None:
    """Detail lines: both Lorenzo wrappers (edge pass + stencil pass) for
    every ``what`` at the Ocean shape, and the stencil pass alone, as
    ``time_blockmean_whats`` times the block-mean kernels."""
    shape = tuple(plane.shape)
    n = plane.numel()
    edges = {True: fused.lorenzo_edges(words, shape, bits, from_payload=True,
                                       site="lorenzo_enc2d"),
             False: fused.lorenzo_edges(plane, shape, 0, from_payload=False,
                                        site="lorenzo2d")}
    for what in fused.LORENZO_WHATS:
        n_out = 2 if what == "grad" else 1
        fill = torch.empty((n_out, n), dtype=torch.int32, device=plane.device)
        fill_ms = cuda_ms(lambda: fill.fill_(1), reps)
        for site, src, from_payload, wrapper in (
                ("lorenzo_enc2d", words, True,
                 lambda w: fused.lorenzo_enc2d(w, shape, bits, what=what)),
                ("lorenzo2d", plane, False,
                 lambda x: fused.lorenzo2d(x, what=what))):
            w_bits = bits if from_payload else 0

            def stencil(x, r, c):
                return fused.lorenzo_stencil(x, shape, w_bits, r, c, what,
                                             from_payload=from_payload,
                                             site=site)

            k_ms = cuda_ms(lambda: wrapper(src), reps)
            g_ms = graph_ms(wrapper, reps, (src,))
            h_ms = enqueue_ms(lambda: wrapper(src), reps)
            s_ms = graph_ms(stencil, reps, (src, *edges[from_payload]))
            edge_bytes = 4 * sum(e.numel() for e in edges[from_payload])
            # take out and unzigzag 5 (payload), then as in time_kernels
            b_ms, b_by = bound_ms(4 * src.numel() + edge_bytes + 4 * n * n_out,
                                  (5 * from_payload + LZ_OPS[what]) * n)
            smem, regs, per_sm = fused.lorenzo_launch_config(from_payload, what)
            say(f"[{tag}] {site} {what}: wrapper {k_ms * 1e3:.1f} us by events, "
                f"device alone {g_ms * 1e3:.1f} us, enqueue {h_ms * 1e3:.1f} us; "
                f"stencil pass alone {s_ms * 1e3:.1f} us (bound {b_ms * 1e3:.1f} "
                f"us by {b_by}; fill_ of the {n_out} output plane(s) "
                f"{fill_ms * 1e3:.1f} us; {smem} B shared memory, {regs} "
                f"registers, {per_sm} blocks/SM)")


def traced_kernels(fn) -> tuple[list[str], list]:
    """The device kernels that one call of ``fn`` runs, in order, from a
    ``torch.profiler`` trace (after two untraced calls): short names and
    the profiler's events (``device_time`` in us)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    if not events:
        fail("torch.profiler recorded no device kernel")
    names = [re.sub(r"^void |\(anonymous namespace\)::|\(.*$", "", e.name)
             for e in events]
    return names, events


def _listed(names, events) -> str:
    return ", ".join(f"{k} {e.device_time:.1f} us"
                     for k, e in zip(names, events))


def query_kernels(fields, tag: str) -> dict:
    """The device kernels of one Lorenzo gradient@③ query per container, in
    order, from a ``torch.profiler`` trace: the Lorenzo kernels before the
    float tail (at most three, and no other kernel between them) and the
    float tail's kernels, each with its device time."""
    out = {}
    for container in ("Encoded", "Compressed"):
        fu, fv = fields["hszp_nd"][container]
        names, events = traced_kernels(
            lambda: run_cell("gradient", Stage.Q, fu, fv))
        ours = 0
        while ours < len(names) and names[ours].startswith("lorenzo_"):
            ours += 1
        if not 0 < ours <= 3 or any(k.startswith("lorenzo_")
                                    for k in names[ours:]):
            fail(f"Lorenzo gradient query ({container}): kernels {names}")
        out[container] = {"before_tail": ours, "total": len(names)}
        say(f"[{tag}] hszp_nd {container} gradient@Q device kernels: {ours} "
            f"before the float tail ({_listed(names[:ours], events[:ours])}), "
            f"then {len(names) - ours} ({_listed(names[ours:], events[ours:])})")
    return out


#: the torch unzigzag's elementwise kernels ((u >> 1) ^ -(u & 1))
UNZIGZAG_KERNELS = re.compile(r"rshift|bitwise_and|bitwise_xor|neg_kernel")
#: the kernels of one prefix_stats2d call, in order
PREFIX_STATS_KERNELS = ("lorenzo_edges_kernel<false>", "corner_scan_kernel",
                        "prefix_stats_tile_kernel<false>",
                        "prefix_stats_reduce_kernel")


def decode_and_stats_kernels(fields, entry: dict, tag: str) -> None:
    """Traces of one ``hszp_nd`` ``Encoded`` mean@② query, whose decode must
    be one unpack kernel (``unpack_kernel<true>``) followed directly by the
    op, with none of the torch unzigzag's elementwise kernels; and of one
    ``prefix_stats2d`` call, which must be our four kernels and nothing
    else."""
    fu, fv = fields["hszp_nd"]["Encoded"]
    names, events = traced_kernels(lambda: run_cell("mean", Stage.P, fu, fv))
    unpacks = [k for k in names if k.startswith("unpack_kernel")]
    if (unpacks != ["unpack_kernel<true>"]
            or any(UNZIGZAG_KERNELS.search(k) for k in names)):
        fail(f"Encoded mean@P: kernels {names}")
    say(f"[{tag}] hszp_nd Encoded mean@P device kernels: "
        f"{_listed(names, events)}")
    names, events = traced_kernels(lambda: K.prefix_stats2d(entry["p"]))
    if tuple(names) != PREFIX_STATS_KERNELS:
        fail(f"prefix_stats2d: kernels {names}")
    say(f"[{tag}] prefix_stats2d device kernels: {_listed(names, events)}")


PER_QUERY = {
    # kernel site -> the query whose launches of it are counted
    "unpack.residuals": ("hszp_nd", "Encoded", "mean", Stage.Q),
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


def per_call_launches(entry: dict, tag: str) -> dict:
    """Launches of each entry-point site per call of its wrapper."""
    calls = {
        "unpack": lambda: K.unpack(entry["words"], entry["z"].numel(),
                                   entry["bits"]),
        "pack": lambda: K.pack(entry["z"], entry["bits"]),
        "quant_lorenzo2d": lambda: K.quant_lorenzo2d(entry["x"], entry["eps"]),
        "block_stats": lambda: K.block_stats(entry["blocked"]),
        "grad2d": lambda: K.grad2d(entry["q"], entry["eps"]),
        "laplacian2d": lambda: K.laplacian2d(entry["q"], entry["eps"]),
        "prefix_stats2d.edges": lambda: K.prefix_stats2d(entry["p"]),
        "prefix_stats2d.stats": lambda: K.prefix_stats2d(entry["p"]),
    }
    out = {}
    for site, call in calls.items():
        ops.reset_launches()
        call()
        torch.cuda.synchronize()
        out[site] = ops.LAUNCHES[site]
        say(f"[{tag}] {site}: {out[site]} launch(es) per entry-point call")
    return out


#: host-clock repetitions of each end-to-end reading
E2E_REPS = 30


def host_ms(fn, reps: int) -> list[float]:
    """Host ms of ``reps`` calls, each ending in a synchronize, sorted."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)


def _spread(times: list[float]) -> str:
    q1, med, q3 = statistics.quantiles(times, n=4)
    return f"{med:.3f} ms (quartiles {q1:.3f}-{q3:.3f})"


def time_queries(fields, tag: str) -> None:
    for scheme, container, op, stage in E2E:
        fu, fv = fields[scheme][container]
        on = host_ms(lambda: run_cell(op, stage, fu, fv), E2E_REPS)
        with ops.override_mode("off"):
            off = host_ms(lambda: run_cell(op, stage, fu, fv), E2E_REPS)
        say(f"[{tag}] e2e {scheme} {container} {op}@{stage.name}: "
            f"{_spread(on)} (fused rules off: {_spread(off)}), median of "
            f"{E2E_REPS}")
    for scheme in SCHEMES:
        comp = by_name(scheme, BLOCK)
        eu = fields[scheme]["Encoded"][0]
        for stage in (Stage.P, Stage.F):
            t = host_ms(lambda: comp.decompress(eu, stage), E2E_REPS)
            say(f"[{tag}] e2e {scheme} Encoded decompress to {stage.name}: "
                f"{_spread(t)}, median of {E2E_REPS}")


# ===========================================================================

def sass_counts(obj) -> dict[str, int]:
    """SASS instructions per kernel of a compiled object (``cuobjdump -sass``
    beside ``nvcc``; {} when the toolkit has none), by demangled name."""
    cuobjdump = pathlib.Path(build._nvcc()).parent / "cuobjdump"
    if not cuobjdump.exists():
        return {}
    out = subprocess.run([str(cuobjdump), "-sass", str(obj)], capture_output=True,
                         text=True, check=True, timeout=120).stdout
    counts: dict[str, int] = {}
    name = None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name and re.match(r"\s*/\*[0-9a-f]{4}\*/", line):
            counts[name] += 1
    names = list(counts)
    demangled = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True,
                               timeout=60).stdout.splitlines()
    if len(demangled) != len(names):
        demangled = names
    return {d: counts[n] for d, n in zip(demangled, names)}


def blockmean_build_lines() -> list[str]:
    """Dynamic shared memory, blocks per SM and SASS instructions of each
    block-mean instantiation (``ptxas -v`` prints its registers)."""
    sass = sass_counts(build.BUILD_DIR / "blockmean_band.o")
    lines = []
    for from_payload, src in ((True, "payload"), (False, "plane")):
        for code, what in enumerate(fused.BLOCKMEAN_WHATS):
            smem, per_sm = fused.blockmean_launch_config(from_payload, what)
            key = f"blockmean_kernel<{str(from_payload).lower()}, {code}>"
            n_sass = [v for k, v in sass.items() if key in k]
            lines.append(f"  blockmean_band.cu {src} {what}: {smem} B dynamic "
                         f"shared memory, {per_sm} blocks/SM, SASS "
                         f"instructions {n_sass or 'not read'}")
    return lines


def lorenzo_build_lines() -> list[str]:
    """Static shared memory, registers, blocks per SM and SASS instructions
    of each Lorenzo pass's instantiation."""
    sass = sass_counts(build.BUILD_DIR / "lorenzo_band.o")
    lines = []
    for from_payload, src in ((True, "payload"), (False, "plane")):
        flag = str(from_payload).lower()
        for what in (None,) + fused.LORENZO_WHATS:
            smem, regs, per_sm = fused.lorenzo_launch_config(from_payload, what)
            key = (f"lorenzo_edges_kernel<{flag}>" if what is None else
                   f"lorenzo_stencil_kernel<{flag}, {fused._LZ_CODE[what]}>")
            n_sass = [v for k, v in sass.items() if key in k]
            lines.append(f"  lorenzo_band.cu {src} {what or 'edges'}: {smem} B "
                         f"shared memory, {regs} registers, {per_sm} blocks/SM, "
                         f"SASS instructions {n_sass or 'not read'}")
    for kernel, use in (("lorenzo_scan_kernel", "Lorenzo"),
                        ("corner_scan_kernel", "prefix_stats2d")):
        n_scan = [v for k, v in sass.items() if kernel in k]
        lines.append(f"  lorenzo_band.cu edge scan ({use}): SASS instructions "
                     f"{n_scan or 'not read'}")
    smem, regs, per_sm = prefix_stats.stats_launch_config()
    n_sass = {wide: [v for k, v in sass.items()
                     if f"prefix_stats_tile_kernel<{wide}>" in k]
              for wide in ("false", "true")}
    lines.append(f"  lorenzo_band.cu prefix_stats2d stats: {smem} B shared "
                 f"memory, {regs} registers, {per_sm} blocks/SM, SASS "
                 f"instructions {n_sass['false'] or 'not read'}; planes wider "
                 f"than 4224 columns: SASS instructions "
                 f"{n_sass['true'] or 'not read'}")
    return lines


def unpack_build_lines() -> list[str]:
    """Shared memory, registers, blocks per SM and SASS instructions of the
    two unpack instantiations."""
    sass = sass_counts(build.BUILD_DIR / "unpack.o")
    lines = []
    for residuals in (False, True):
        smem, regs, per_sm = bitpack.unpack_config(residuals)
        key = f"unpack_kernel<{str(residuals).lower()}>"
        n_sass = [v for k, v in sass.items() if key in k]
        lines.append(f"  unpack.cu {key}: {smem} B shared memory at 31 bits, "
                     f"{regs} registers, {per_sm} blocks/SM, SASS "
                     f"instructions {n_sass or 'not read'}")
    return lines


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
    phase_s: dict[str, float] = {"1-2": t_start}

    if set(SITES) != set(ops.LAUNCHES) or set(SITES) != {
            k for sites in PATHS.values() for k in sites}:
        fail("SITES, PATHS and kernels.ops.LAUNCHES name different sites")

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
    RATES.update(card_rates())
    say(f"int32 {RATES['int32'] / 1e12:.2f} Tops/s, f32 "
        f"{RATES['f32'] / 1e12:.2f} Tops/s ({INT32_LANES} / {FP32_LANES} lanes "
        f"x {RATES['sms']} SMs x {RATES['clock_hz'] / 1e6:.0f} MHz max SM "
        f"clock); memory {HBM_BYTES_PER_S / 1e12:.2f} TB/s; L2 "
        f"{RATES['l2_bytes'] / 2 ** 20:.0f} MiB")

    # 2. build
    t0 = time.perf_counter()
    build.library()
    say(f"built {build.BUILD_DIR / 'libhsz.so'} in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in build.BUILD_LOG:
        if any(k in line for k in ("registers", "spill", "Compiling entry")):
            say(f"  {line}")
    for line in (blockmean_build_lines() + lorenzo_build_lines()
                 + unpack_build_lines()):
        say(line)

    phase_s["3"] = time.perf_counter()
    # 3. main-path kernels against plain versions
    errs: dict[str, float] = {}
    cont = check_kernels(OCEAN, args.seed, errs)
    check_kernels(PADDED, args.seed, errs)
    check_blockmean_tiling(args.seed, errs)
    check_lorenzo_tiling(args.seed, errs)

    phase_s["4"] = time.perf_counter()
    # 4. the kernel entry point: against plain versions, then driven on u
    # and held against the main path's containers and stage-3 results
    check_entry_kernels(OCEAN, args.seed, errs)
    check_entry_kernels(PADDED, args.seed, errs)
    check_prefix_stats_wide(args.seed, errs)
    u = synth_field("Ocean", 0, OCEAN, args.seed)
    v = synth_field("Ocean", 1, OCEAN, args.seed)
    x = torch.as_tensor(u, device=DEVICE)
    eps = quantize.resolve_eps(x, rel_eb=REL_EB)
    path_launches = {}
    ops.reset_launches()
    entry = entry_point_path(x, eps, cont["hszp_nd"][1].bits)
    path_launches["entry point"] = dict(ops.LAUNCHES)
    require_launches("entry point", path_launches["entry point"])
    check_entry_against_main(u, entry)

    phase_s["5"] = time.perf_counter()
    # 5. main path
    ops.reset_launches()
    fields, decomp, results = main_path(u, v)
    path_launches["main path"] = dict(ops.LAUNCHES)
    require_launches("main path", path_launches["main path"])
    hosts = check_main_path(u, v, fields, decomp, results)
    check_ab(fields)

    phase_s["5b"] = time.perf_counter()
    # 5b. region queries: no full-field decode, the residual-plane kernels
    # on the gathered sub-planes
    ops.reset_launches()
    region_out = region_path(fields)
    path_launches["region path"] = dict(ops.LAUNCHES)
    require_launches("region path", path_launches["region path"])
    stray = [k for k in NOT_ON_REGIONS if path_launches["region path"][k]]
    if stray:
        fail(f"the region path launched full-field kernels: {stray}")
    never = [k for k in ops.LAUNCHES
             if all(counts[k] == 0 for counts in path_launches.values())]
    if never:
        fail(f"kernel sites launched on no path: {never}")
    # each site's launches on its path (unpack runs on both: the main path's)
    launches = {k: path_launches["main path" if k in PATHS["main path"]
                                 else "entry point"][k] for k in SITES}
    check_region_path(fields, hosts, region_out)
    check_region_ab(fields)
    check_region_kernels(fields, errs)

    phase_s["5c fields"] = time.perf_counter()
    # 5c. the engine path: batched op sets, expressions, the store; each
    # query counted on its own and held against its plan
    efields = engine_fields(args.seed)
    phase_s["5c path"] = time.perf_counter()
    engine_out = engine_path(efields, analytics.BatchedAnalytics())
    path_launches["engine path"] = check_engine_launches(efields, engine_out)
    require_launches("engine path", path_launches["engine path"])
    check_engine_values(efields, engine_out)
    check_engine_ab(efields, engine_out)
    phase_s["5c CPU"] = time.perf_counter()
    check_engine_cpu(efields, engine_out)
    del engine_out

    phase_s["5d"] = time.perf_counter()
    # 5d. the stream path: 64 Ocean timesteps appended to four streams, each
    # append and query counted on its own and held against its plan
    stream_out = stream_path(u, v, args.seed)
    path_launches["stream path"] = stream_out["launches"]
    require_launches("stream path", path_launches["stream path"])
    check_stream_storeless(stream_out)
    check_stream_eviction(stream_out)
    check_stream_exprs(stream_out)
    phase_s["5d CPU"] = time.perf_counter()
    check_stream_cpu(stream_out)
    slab_payload = check_stream_unpack(stream_out, errs)
    phase_s["5d times"] = time.perf_counter()
    slab_times = time_stream(stream_out, slab_payload, tag)
    stream_trace(stream_out, tag)
    del stream_out, slab_payload

    phase_s["6"] = time.perf_counter()
    # 6. times
    times = time_kernels(cont, entry, REPS, tag)
    per_query = per_query_launches(fields, tag)
    per_query.update(per_call_launches(entry, tag))
    query_kernels(fields, tag)
    decode_and_stats_kernels(fields, entry, tag)
    region_query_kernels(fields, tag)
    time_queries(fields, tag)
    time_region_queries(fields, tag)
    time_engine(efields, tag)
    engine_trace(efields, tag)

    kernels = []
    for name, (source, replaces) in SITES.items():
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "launches_per_query": per_query[name],
            "max_abs_err": errs[name], "ms": t["ms"],
            "graph_ms": t["graph_ms"], "enqueue_ms": t["enqueue_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "region_launches": path_launches["region path"][name],
            "engine_launches": path_launches["engine path"][name],
            "stream_launches": path_launches["stream path"][name]})
        if name == "unpack.residuals":
            kernels[-1]["slab"] = slab_times
        if name == "prefix_stats2d.stats":
            kernels[-1]["wide"] = dict(times[WIDE_STATS],
                                       shape=list(PS_WIDE[1]))
    phase_s["end"] = time.perf_counter()
    names = list(phase_s)
    say("seconds per phase: " + ", ".join(
        f"{a} {phase_s[b] - phase_s[a]:.1f}" for a, b in zip(names, names[1:])))
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
