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
3b. the batched kernels (the decode's unpack, both band-kernel families
   and the stage-③ difference kernel ``grad2d`` with a leading batch axis,
   one launch a batch: the engine's batches): every ``what`` against the
   batched plain versions, bitwise, at Ocean x 8 (7-bit payloads), at
   batches of 1, 2 and 3 fields on planes whose payload rows are not
   16-byte multiples (``grad2d`` also on odd planes, one past MAX_GRID_Y
   interior rows among them), and on two fields of many tiles whose first
   holds full-range residuals and second zeros (no sum may cross a field:
   the second's outputs stay zero);
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
   then the warm full-field and region cells once more under
   ``torch.cuda.set_sync_debug_mode("warn")``: every distinct host sync is
   printed with the port's frames that raised it, and any sync fails;
   then (after 5c's fields are made) the batches: the sub-basin, the
   transect and the far corner over 5c's eight fields per scheme and
   container as one ``BatchedAnalytics().run`` each (the op set at ② and
   ③, divergence / curl at ② over four pairs), and seeded with each
   field's ② and ③ ``materialize`` (the op set at ②, ③, ④): each run one
   stage context per component (every kernel pass one launch for the
   batch, no decode in a seeded run) and bitwise the per-field
   ``compute`` calls;
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
   reference's fused cells (``FUSED_CELLS``: a full-field batch — (a), (b)
   and the flat op set's layout groups — one decode and one band-kernel
   set per covered op for the whole batch, each pass one launch; a
   seeded or store-hit batch of the eight fields, its seeds stacked, one
   set for the batch; an expression leaf one set; on a stage-③ seed the
   stage-③ difference kernel or the block-mean kernel over its integers,
   at most one decode per ``Encoded`` leaf, no unpack and
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
   layout group of full-field ``Encoded`` slabs it summarizes (the group's
   slabs stacked into one summarize) and nothing else;
5e. the serve path (``repro_torch.serve``, ``repro_torch.shard``): the
   ``Encoded`` (u, v) of both schemes by id in a ``ShardedFieldStore`` (8
   shards on one card, then 1 shard; one shard per card where the machine
   has several) and under ``local/`` ids in a ``StreamFieldStore``, each
   with a temporal id, behind one ``StoreRouter`` and one
   ``AnalyticsFrontend``: one step of 50 requests (two appends of phase
   5d's slabs per temporal id; mean / std at auto, ②, ③; gradient and
   laplacian at ③, ④; derivative on axis 1; an op set; divergence and curl
   over vector ids; two expressions; a sub-basin and a transect; requests
   on local ids; tmean / tstd / tdelta; four malformed requests) equals the
   same step over one single-device store request by request, bitwise and
   at the same stages; the malformed requests alone are rejected, with the
   reference's exception types; each group issues its dispatch (one per
   spatial group, one per temporal stream); every request replayed as its
   own ``query()`` on fresh stores launches what the single-device query
   launches and gives its bits; in a warm step each flat group query
   launches what its first request launches alone (one launch of each
   kernel pass per group); a per-shard budget evicts a region cell on
   its home shard only and the cell recomputes bitwise; the word merge
   launches none of the port's kernels; it prints host ms per warm step
   beside the single-device store's, the merge's device µs and a profiler
   trace of a warm step.  It runs last, after phase 6's traces and
   phase 7;
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
   equal) and ``torch.profiler`` traces of one (a) call per scheme and
   container, as one batched run and as eight per-field ``compute`` calls:
   their kernels, device µs and the device's busy share of the call's
   window; the ③ hit also as eight seeded ``compute`` calls; the batched
   kernels at Ocean x 8 (events, device alone, plain version, bound, beside
   8 x one field's device-alone time); 5b's batches on the sub-basin (the
   op set at ③, unseeded and ③-seeded) as one run against eight
   ``compute`` calls, host ms and busy share; the stream path's host ms per
   append (with its two merges), per hot query (a resident hit of the five
   ops) and per cold storeless query over 8 slabs beside the same
   summaries one slab at a time, with their peak device memory,
   ``torch.profiler`` traces of one append, one cold query and its
   per-slab loop, and the unpack kernel alone at slab size beside its
   bound;
7. the static audit on the card (``repro_torch.audit``): (a) ``run_audit()``
   clean, no error and no warning, with the fused rules on and under
   ``override_mode("off")``; (b) every kernel instantiation's static and
   dynamic shared memory, registers and blocks per SM as the library
   reports them (``hsz_func_attrs``) against its spec
   (``kernels/specs.py``), within 48 KiB static and the card's opt-in limit
   per block (``hsz_smem_optin``), and against the ``hsz_*_info``
   launchers; (c) every instantiation launched through ``build.call`` into
   guarded windows (guard words around each, the window filled with a
   sentinel, two launches with two sentinels) at the edge shapes of every
   tiling limit (rows 1, 31, 32, 33 x columns 1, 127, 128, 129, 4224, 4225;
   65 537 and 65 539 rows; unpack and pack at 2048·k ± 1 values and widths
   1, 7, 16, 17, 31; Ocean; batches of 3 fields whose payload rows are not
   16-byte multiples for the batched kernels): every window cell written,
   no guard word
   touched, the two launches bitwise equal and equal to the plain
   versions (``prefix_stats2d``: to the exact sums rounded once);
8. (a) the science store (``repro_torch.data.ScientificStore``) at scale 1,
   Ocean at full size, ``hszp_nd`` and ``hszx_nd``, ``rel_eb`` 1e-3, on the
   card: it synthesizes, compresses and writes the ``.hsz`` files; then
   ``tests/test_system.py``'s pipeline (mean@① within 2·eps of the
   decompressed mean, laplacian at ②③ and divergence at ③ within 1e-4 of
   ④), ``stats``, ``derivative_features`` and ``raw``, held against the CPU
   port reading the same bytes (integer-rounded outputs bitwise, statistics
   and divergence with the slice tolerances); the path must launch the
   ``lorenzo2d`` kernels and ``blockmean2d`` (the ``hszx_nd`` store's
   gradient@③); host ms per ``stats`` / ``derivative_features``.
   (b) LM serving at ``smollm-360m``'s published widths and depth (32
   layers, d_model 960, 15 heads / kv 5, head_dim 64, d_ff 2560, vocab
   49152), f32 params from a seeded generator on the card, bf16 compute:
   ``Engine(slots=4, max_len=128)`` with ``launch/serve.py``'s defaults (8
   requests, prompt 8, 16 new tokens), ``kv_quant`` off and on, every
   request drained; one request's tokens == a manual greedy loop; at f32
   compute, 8 teacher-forced decode steps against ``full_logits`` (top-1
   ≥ 0.9, rtol 0.1 / atol 0.15) and prefill -> decode against step-by-step
   decode; tokens per second, ms per warm decode step, KV bytes per slot,
   and a profiler trace of one step with the layers' weight casts
   (``cast_tree``) timed on their own; then the reduced ``qwen3-4b``,
   ``granite-moe-3b-a800m``, ``deepseek-v3-671b`` and ``paligemma-3b`` at
   f32 compute on the card against the CPU port with the same params
   (logits rtol / atol 1e-4, greedy engine tokens equal).
   (c) the same at the ssm, hybrid and audio families' published widths:
   ``falcon-mamba-7b`` at full depth (64 layers, d_model 4096, d_inner
   8192, state 16, vocab 65024), ``recurrentgemma-9b`` cut to one period
   (3 of 38 layers; head_dim 256, MQA, lru 4096, d_ff 12288, vocab 256000,
   window 2048) and ``whisper-base`` at full size (6 + 6 layers, 1500
   frames of seeded normals): the engine drains 8 requests (``kv_quant``
   off and on for whisper's self K/V; once for the state caches), one
   request == manual greedy decode, 8 f32 decode steps against
   ``full_logits`` (whisper: ``encode`` runs and fills the cross cache),
   prefill -> decode (whisper: prefill returns a fresh cache, as the
   reference's); tokens per second, ms per warm step, cache bytes per
   slot, peak memory and a profiler trace of one step with ``cast_tree``
   timed on its own; then the three reduced archs on the card against the
   CPU port (recurrentgemma decoding 24 steps, past its window of 16).
   Phase 8 runs after phase 7 and before 5e.
9. training (``repro_torch.train``, ``repro_torch.comm``): (a) 8 ``gspmd``
   steps of ``smollm-360m`` at its published widths and depth, f32 params
   from a seeded generator on the card, bf16 compute, ``remat="full"``,
   the token pipeline at 8 x 512 tokens, AdamW with warmup 5: losses and
   grad norms finite, ``lr`` the host's schedule (within 2 ulps);
   ``microbatch=2`` against the full batch (loss rtol 1e-5, grad norm rtol
   1e-3); ms per warm step (median of 5), tokens/s, peak memory and a
   profiler trace of one step; (b) the same model in ``hom`` mode over
   ``make_host_mesh(devices=["cuda:0"] * 4)``: on one batch every leaf's
   compressed mean within the per-worker eps bound of the exact mean, the
   largest |Σq| at most ``worst_case_psum(4)`` with the int16 sums exact,
   then 2 hom steps, every worker's residual finite; (c) at its widths cut
   to 2 layers, a lossless checkpoint of the whole ``TrainState`` and the
   pipeline restored bitwise, 2 steps after it == 2 uninterrupted steps
   (rtol 1e-6), an HSZ checkpoint of the params at ``rel_eb`` 1e-4
   restored through the integrity check within ``rel_eb·range``, MB/s and
   the codec; (d) the collectives path: ``packed_allgather`` of the
   embedding (49152 x 960) over 4 workers at 8 and 12 bits, its words ==
   ``pack_plain``'s and their values == ``unpack_plain``'s on the card,
   the gathered values == the CPU port's bitwise, ``stage1_stats`` of the
   params against float64 numpy (rtol 1e-4); (e) the ten reduced archs at
   f32 compute, card against the CPU port: loss and every gradient leaf,
   then one gspmd step's params (rtol / atol 1e-4).  Phase 9 runs after 8
   and before 5e.
10. the mesh layer (``repro_torch.launch.{mesh,dryrun,op_analysis,
   roofline}``, ``models/ffn.moe_manual_ep``, ``comm.exchange``): (a) one
   MoE layer at full width with manual expert parallelism over
   ``make_host_mesh((1, 4))`` and ``(2, 4)`` peers on the one card:
   ``granite-moe-3b-a800m`` (40 experts, d 1536, d_ff 512, top-8) at f32
   and its configured capacity against the CPU port on the same inputs
   (rtol / atol 1e-4), ``deepseek-v3-671b`` (256 experts, d 7168, d_ff
   2048, sigmoid, 1 shared; f32 weights, 45.1 GB, where the card has room,
   else bf16 at rtol / atol 2e-2) against the port's ``moe`` on the card
   at a capacity that drops nothing (checked from the routing); (b)
   ``granite-moe-3b-a800m`` at full width and depth served by
   ``Engine(slots=4, max_len=128)`` with the (1, 4) mesh active, 8 requests
   drained at f32 compute: at a capacity that drops nothing its greedy
   tokens equal the unmeshed engine's; at the config's capacity the tokens
   that differ are counted; tokens/s and ms per warm step; (c) the dry run
   of ``smollm-360m`` on a (1, 1) mesh at phase 9a's shape (8 x 512, remat)
   and a decode shape (8 x 4096) against the real step: its predicted peak
   over ``torch.cuda.max_memory_allocated`` within 0.5-2, and its FLOPs
   over the step's time; (d) two gspmd steps of the reduced MoE archs at
   f32 compute under a (2, 2) mesh, card against the CPU port (rtol / atol
   1e-4); (e) the dry run of every ``smollm-360m`` and
   ``deepseek-v3-671b`` cell on both production meshes, in host processes
   started at (a) (no card): every status is what ``cell_supported``
   says.  Phase 10 runs after 9 and before 5e.

Launch counters are reset just before each path (entry point, main path,
region path, the serve path's step, the science store's path, the
collectives' all-gathers; on the engine
and stream paths and the serve path's replay, each query and append) and
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
import gc
import json
import math
import os
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import time
import warnings

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import analytics, audit, convert  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.core import Stage, by_name, encode, error_analysis  # noqa: E402
from repro_torch.core import blocking, expr, oplib, quantize  # noqa: E402
from repro_torch.core import fused as rules  # noqa: E402
from repro_torch.core import homomorphic as H  # noqa: E402
from repro_torch.core import region as R  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    ARCHS, SHAPES, ShapeConfig, cell_supported, reduced)
from repro_torch.data import ScientificStore  # noqa: E402
from repro_torch.data.scientific import dataset_dims, synth_field  # noqa: E402
from repro_torch.models import (  # noqa: E402
    ffn, get_model, make_batch, transformer, whisper)
from repro_torch.models.common import (  # noqa: E402
    Builder, tree_flatten_with_paths, tree_leaves, tree_map)
from repro_torch.kernels import (  # noqa: E402
    bitpack, build, fused, ops, prefix_stats, quant_lorenzo, ref, specs,
    stencil_dq)
from repro_torch.core.stages import LEAVES, Encoded, layout_key  # noqa: E402
from repro_torch.store import (  # noqa: E402
    FieldStore, materialize, materialized_nbytes)
from repro_torch.core.oplib import map_summaries  # noqa: E402
from repro_torch.comm import hom_collectives as hom  # noqa: E402
from repro_torch.data.tokens import (  # noqa: E402
    TokenPipeline, TokenPipelineConfig)
from repro_torch.comm import exchange  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    make_analytics_mesh, make_host_mesh)
from repro_torch.train import checkpoint as train_ckpt  # noqa: E402
from repro_torch.train import optimizer as train_opt  # noqa: E402
from repro_torch.train import train_step  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    AnalyticsFrontend, AnalyticsRequest, AppendRequest, Engine, Request,
    StoreRouter)
from repro_torch.shard import ShardedFieldStore  # noqa: E402
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
    "lorenzo_moments.edges": (f"{CSRC}/lorenzo_band.cu",
                              "src/repro/kernels/prefix_stats.py:56"),
    "lorenzo_moments.stats": (f"{CSRC}/lorenzo_band.cu",
                              "src/repro/kernels/prefix_stats.py:56"),
    # no Pallas site: the reference declines rank 3
    "lorenzo_enc3d.edges": (f"{CSRC}/lorenzo3d.cu", "none"),
    "lorenzo_enc3d.stencil": (f"{CSRC}/lorenzo3d.cu", "none"),
}
#: path -> the kernel sites it must launch
PATHS = {
    "entry point": ("pack", "unpack", "quant_lorenzo2d", "block_stats",
                    "grad2d", "laplacian2d", "prefix_stats2d.edges",
                    "prefix_stats2d.stats"),
    "main path": ("unpack.residuals", "lorenzo_enc2d.edges",
                  "lorenzo_enc2d.stencil",
                  "blockmean_enc2d", "lorenzo2d.edges", "lorenzo2d.stencil",
                  "blockmean2d", "lorenzo_moments.edges",
                  "lorenzo_moments.stats"),
    "region path": ("lorenzo2d.edges", "lorenzo2d.stencil", "blockmean2d",
                    "grad2d"),
    "engine path": ("unpack.residuals", "lorenzo_enc2d.edges",
                    "lorenzo_enc2d.stencil", "blockmean_enc2d",
                    "lorenzo2d.edges", "lorenzo2d.stencil", "blockmean2d",
                    "grad2d", "lorenzo_moments.edges",
                    "lorenzo_moments.stats"),
    "region batches": ("lorenzo2d.edges", "lorenzo2d.stencil", "blockmean2d",
                       "grad2d"),
    "stream path": ("unpack.residuals",),
    "serve path": ("unpack.residuals", "lorenzo2d.edges", "lorenzo2d.stencil",
                   "blockmean2d", "grad2d"),
    "science store": ("lorenzo2d.edges", "lorenzo2d.stencil", "blockmean2d"),
    "collectives": ("pack", "unpack"),
    "rank-3 path": ("lorenzo_enc3d.edges", "lorenzo_enc3d.stencil"),
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


def check_f32_modes(errs: dict, site: str, run, plain, eps, label: str,
                    rng) -> None:
    """The stencil pass's f32 modes of one source (``run(what, **kw)`` its
    wrapper, ``plain(what)`` its int32 plain version) against the plain
    epilogue, bitwise: write for every ``what`` (noted under ``site``), add
    and sub of the derivatives onto random values (under ``site.add`` /
    ``site.sub``)."""
    for what in fused.LORENZO_WHATS:
        _note(errs, site, bitwise_err(
            fused.lorenzo_scale_plain(plain(what), eps), run(what, eps=eps),
            f"{label} {what} f32 write"))
    for what in ("deriv0", "deriv1"):
        d = plain(what)
        for mode in ("add", "sub"):
            prior = torch.as_tensor(rng.standard_normal(tuple(d.shape))
                                    .astype(np.float32) * 100.0, device=DEVICE)
            _note(errs, f"{site}.{mode}", bitwise_err(
                fused.lorenzo_scale_plain(d, eps, mode, prior.clone()),
                run(what, eps=eps, mode=mode, out=prior.clone()),
                f"{label} {what} f32 {mode}"))


def check_lorenzo_tiling(seed: int, errs: dict) -> None:
    """Both Lorenzo passes, both sources and every ``what`` at
    ``LZ_SHAPES``, bitwise against the plain versions: a seeded full-range
    int32 plane (so sums wrap) and payloads packed at ``LZ_WIDTHS``; the
    stencil pass in every mode (:func:`check_f32_modes`)."""
    rng = np.random.default_rng(seed)
    tile = fused.lorenzo_tile()
    eps = torch.tensor(0.37, dtype=torch.float32, device=DEVICE)
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
        check_f32_modes(
            errs, "lorenzo2d.stencil",
            lambda w, **kw: fused.lorenzo2d(plane, what=w, **kw),
            lambda w: fused.lorenzo_core(plane, w), eps,
            f"lorenzo2d {shape}", rng)
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
            check_f32_modes(
                errs, "lorenzo_enc2d.stencil",
                lambda w, **kw: fused.lorenzo_enc2d(words, shape, bits, what=w,
                                                    **kw),
                lambda w: fused.lorenzo_enc2d_plain(words, shape, bits, what=w),
                eps, f"lorenzo_enc2d {shape} bits={bits}", rng)
    torch.cuda.synchronize()
    say("Lorenzo kernels == plain versions, bitwise, both passes, every what, "
        f"full-range int32 planes and payloads at {LZ_WIDTHS} bits, at "
        + ", ".join(map(str, LZ_SHAPES)))


# ===========================================================================
# phase 3b: the batched kernels (a leading batch axis, one launch a batch)
# ===========================================================================

#: the engine's batch: eight Ocean fields, payloads at 7 bits
BATCH, BATCH_BITS = 8, 7
#: the sites that take a batch (the decode, the band kernels and the
#: stage-③ difference kernel), each listed again in the kernels line as
#: "<site> x8"
BATCHED_SITES = ("unpack.residuals", "lorenzo_enc2d.edges",
                 "lorenzo_enc2d.stencil", "blockmean_enc2d", "lorenzo2d.edges",
                 "lorenzo2d.stencil", "blockmean2d", "grad2d",
                 "lorenzo_moments.edges", "lorenzo_moments.stats")
#: ragged batches: (Lorenzo plane, width) and (block-mean plane, block,
#: width) whose payloads have n_words % 4 != 0, so fields past the first do
#: not start on 16 bytes; and the cross-field case (field 0 full-range
#: residuals at 31 bits, field 1 zeros) on planes of many tiles
BATCH_RAGGED_LZ = (((2401, 3599), 7), ((33, 129), 13))
BATCH_RAGGED_BM = (((2395, 3598), (5, 7), 7), ((44, 126), (4, 6), 13))
BATCH_SIZES = (1, 2, 3)
LEAK_LZ, LEAK_BM = (2401, 3599), ((2395, 3598), (5, 7))
#: the batched grad2d at odd shapes besides the Lorenzo ones: the smallest
#: plane, odd planes of one and 257 interior columns, and a plane past
#: MAX_GRID_Y interior rows (the grid-stride loop under blockIdx.z)
BATCH_GRAD_ODD = ((3, 3), (5, 259), (1201, 1803), (65539, 4))


def _rand_i32(shape, lo: int, hi: int, gen) -> torch.Tensor:
    """Seeded int32 values in [lo, hi), drawn on the card."""
    return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int64,
                         device=DEVICE).to(torch.int32)


def _payloads(p: torch.Tensor, bits: int) -> torch.Tensor:
    """One payload row per plane of ``p`` (the torch packer)."""
    return torch.stack([encode.pack_uniform(encode.zigzag(x.reshape(-1)), bits)
                        for x in p])


def batched_inputs(shape, bits: int, batch: int, gen, block=BLOCK,
                   leak: bool = False) -> dict:
    """A batch's inputs: full-range int32 planes (sums wrap), residuals
    within ``bits`` and their payload rows, block means; ``leak``: field 0
    full-range (31-bit payload), every other field zeros."""
    full = (batch,) + tuple(shape)
    grid = (batch, shape[0] // block[0], shape[1] // block[1])
    if leak:
        bits = 31
    lim = 1 << (bits - 1)
    out = {"plane": _rand_i32(full, -2 ** 31, 2 ** 31, gen),
           "p": _rand_i32(full, -lim, lim, gen),
           "meta": _rand_i32(grid, -2 ** 31, 2 ** 31, gen),
           "bits": bits, "shape": tuple(shape), "block": block}
    if leak:
        for k in ("plane", "p", "meta"):
            out[k][1:] = 0
    out["words"] = _payloads(out["p"], bits)
    return out


def check_batch(inp: dict, errs: dict, what_tag: str, lorenzo: bool = True,
                blockmean: bool = True) -> None:
    """Every batched kernel on one batch's inputs against its batched
    plain version, bitwise (errors noted under "<site> x8")."""
    label = f" x{BATCH}"
    shape, bits, block = inp["shape"], inp["bits"], inp["block"]
    plane, p, words, meta = inp["plane"], inp["p"], inp["words"], inp["meta"]
    n = shape[0] * shape[1]
    tile = fused.lorenzo_tile()
    _note(errs, f"unpack.residuals{label}", bitwise_err(
        bitpack.unpack_residuals_plain(words, n, bits),
        bitpack.unpack_residuals(words, n, bits),
        f"batched unpack_residuals {what_tag}"))
    if lorenzo:
        _note(errs, f"grad2d{label}", bitwise_err(
            stencil_dq.grad2d_int_plain(plane), stencil_dq.grad2d_int(plane),
            f"batched grad2d {what_tag}"))
        _note(errs, f"lorenzo2d.edges{label}", bitwise_err(
            fused.lorenzo_edge_prefixes_plain(plane, tile),
            fused.lorenzo_edges(plane, shape, 0, from_payload=False,
                                site="lorenzo2d"),
            f"batched lorenzo2d edges {what_tag}"))
        _note(errs, f"lorenzo_enc2d.edges{label}", bitwise_err(
            fused.lorenzo_edge_prefixes_plain(p, tile),
            fused.lorenzo_edges(words, shape, bits, from_payload=True,
                                site="lorenzo_enc2d"),
            f"batched lorenzo_enc2d edges {what_tag}"))
        for what in fused.LORENZO_WHATS:
            _note(errs, f"lorenzo2d.stencil{label}", bitwise_err(
                fused.lorenzo_core(plane, what),
                fused.lorenzo2d(plane, what=what),
                f"batched lorenzo2d {what} {what_tag}"))
            _note(errs, f"lorenzo_enc2d.stencil{label}", bitwise_err(
                fused.lorenzo_enc2d_plain(words, shape, bits, what=what),
                fused.lorenzo_enc2d(words, shape, bits, what=what),
                f"batched lorenzo_enc2d {what} {what_tag}"))
        # the f32 modes, each field its own eps (write noted under the
        # sites, add and sub under "<site>.add x8" / ".sub x8")
        eps = torch.linspace(1e-3, 0.5, plane.shape[0], dtype=torch.float32,
                             device=DEVICE)
        rng = np.random.default_rng(plane.shape[0])
        sub = {}
        check_f32_modes(
            sub, "lorenzo2d.stencil",
            lambda w, **kw: fused.lorenzo2d(plane, what=w, **kw),
            lambda w: fused.lorenzo_core(plane, w), eps,
            f"batched lorenzo2d {what_tag}", rng)
        check_f32_modes(
            sub, "lorenzo_enc2d.stencil",
            lambda w, **kw: fused.lorenzo_enc2d(words, shape, bits, what=w,
                                                **kw),
            lambda w: fused.lorenzo_enc2d_plain(words, shape, bits, what=w),
            eps, f"batched lorenzo_enc2d {what_tag}", rng)
        for k, err in sub.items():
            _note(errs, f"{k}{label}", err)
    if blockmean:
        for what in fused.BLOCKMEAN_WHATS:
            _note(errs, f"blockmean2d{label}", bitwise_err(
                fused.blockmean_core(plane, meta, block, what),
                fused.blockmean2d(plane, meta, block, what=what),
                f"batched blockmean2d {what} {what_tag}"))
            _note(errs, f"blockmean_enc2d{label}", bitwise_err(
                fused.blockmean_enc2d_plain(words, meta, shape, block, bits,
                                            what=what),
                fused.blockmean_enc2d(words, meta, shape, block, bits,
                                      what=what),
                f"batched blockmean_enc2d {what} {what_tag}"))


def check_leak(inp: dict, what_tag: str, lorenzo: bool) -> None:
    """The cross-field case: every output of field 1 (all zeros) is zero,
    so nothing of field 0 (full-range sums) reached it, and field 0's is
    not."""
    shape, bits, block = inp["shape"], inp["bits"], inp["block"]
    outs = []
    if lorenzo:
        outs.append(("grad2d", stencil_dq.grad2d_int(inp["plane"])))
        outs.append(("lorenzo2d edges", fused.lorenzo_edges(
            inp["plane"], shape, 0, from_payload=False, site="lorenzo2d")))
        outs.append(("lorenzo_enc2d edges", fused.lorenzo_edges(
            inp["words"], shape, bits, from_payload=True,
            site="lorenzo_enc2d")))
        for what in fused.LORENZO_WHATS:
            outs.append((f"lorenzo2d {what}",
                         fused.lorenzo2d(inp["plane"], what=what)))
            outs.append((f"lorenzo_enc2d {what}", fused.lorenzo_enc2d(
                inp["words"], shape, bits, what=what)))
    else:
        for what in fused.BLOCKMEAN_WHATS:
            outs.append((f"blockmean2d {what}", fused.blockmean2d(
                inp["plane"], inp["meta"], block, what=what)))
            outs.append((f"blockmean_enc2d {what}", fused.blockmean_enc2d(
                inp["words"], inp["meta"], shape, block, bits, what=what)))
    outs.append(("unpack_residuals", bitpack.unpack_residuals(
        inp["words"], shape[0] * shape[1], bits)))
    for name, out in outs:
        for o in _tup(out):
            if bool(o[1].any()) or not bool(o[0].any()):
                fail(f"{name} {what_tag}: field 1 (zeros) is not zero, or "
                     "field 0 is: a sum reached across fields")


def check_batched_kernels(seed: int, errs: dict) -> dict:
    """Each batched kernel bitwise against its batched plain version: at
    Ocean x ``BATCH`` (``BATCH_BITS``-bit payloads), at the ragged batches
    of ``BATCH_SIZES`` fields, and on the cross-field case.  Returns the
    Ocean batch's inputs (the times of phase 6)."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    ocean = batched_inputs(OCEAN, BATCH_BITS, BATCH, gen)
    if ocean["words"].shape[-1] % 4:
        fail("the Ocean batch's payload rows should be 16-byte multiples")
    check_batch(ocean, errs, f"{BATCH} x {OCEAN}")
    for batch in BATCH_SIZES:
        for shape, bits in BATCH_RAGGED_LZ:
            inp = batched_inputs(shape, bits, batch, gen)
            if inp["words"].shape[-1] % 4 == 0:
                fail(f"{shape} at {bits} bits: payload rows not ragged")
            check_batch(inp, errs, f"{batch} x {shape} {bits} bits",
                        blockmean=False)
        for shape, block, bits in BATCH_RAGGED_BM:
            inp = batched_inputs(shape, bits, batch, gen, block=block)
            if inp["words"].shape[-1] % 4 == 0:
                fail(f"{shape} at {bits} bits: payload rows not ragged")
            check_batch(inp, errs, f"{batch} x {shape} block {block} {bits} "
                        "bits", lorenzo=False)
        for shape in BATCH_GRAD_ODD:
            plane = _rand_i32((batch,) + shape, -2 ** 31, 2 ** 31, gen)
            _note(errs, f"grad2d x{BATCH}", bitwise_err(
                stencil_dq.grad2d_int_plain(plane),
                stencil_dq.grad2d_int(plane),
                f"batched grad2d {batch} x {shape}"))
            del plane
    rng = np.random.default_rng(seed)
    ocean["ps"] = bounded_batch(OCEAN, BATCH, rng)
    check_prefix_stats_batch(ocean["ps"], errs, f"{BATCH} x {OCEAN}")
    for batch in BATCH_SIZES:
        for shape, _ in BATCH_RAGGED_LZ + ((PS_WIDE[0], None),):
            check_prefix_stats_batch(bounded_batch(shape, batch, rng), errs,
                                     f"{batch} x {shape}")
    ps = bounded_batch(LEAK_LZ, 2, rng)
    ps[1] = 0
    got = check_prefix_stats_batch(ps, errs, f"cross-field {LEAK_LZ}")
    if bool(got[1].any()) or not bool(got[0].all()):
        fail(f"batched prefix stats cross-field {LEAK_LZ}: field 1 (zeros) "
             "is not zero, or field 0 is: a sum reached across fields")
    leak = batched_inputs(LEAK_LZ, 31, 2, gen, leak=True)
    check_batch(leak, errs, f"cross-field {LEAK_LZ}", blockmean=False)
    check_leak(leak, f"cross-field {LEAK_LZ}", lorenzo=True)
    leak = batched_inputs(LEAK_BM[0], 31, 2, gen, block=LEAK_BM[1], leak=True)
    check_batch(leak, errs, f"cross-field {LEAK_BM}", lorenzo=False)
    check_leak(leak, f"cross-field {LEAK_BM}", lorenzo=False)
    del leak
    torch.cuda.synchronize()
    say(f"batched kernels == batched plain versions, bitwise, every what: "
        f"{BATCH} x {OCEAN} at {BATCH_BITS} bits; batches of {BATCH_SIZES} at "
        f"{BATCH_RAGGED_LZ} and {BATCH_RAGGED_BM} (payload rows of n_words % "
        f"4 != 0), grad2d also at {BATCH_GRAD_ODD}; the cross-field case at "
        f"{LEAK_LZ} and {LEAK_BM}: field 1 (zeros) stays zero beside field "
        f"0's full-range sums; the batched prefix stats on bounded planes at "
        f"{BATCH} x {OCEAN}, batches of {BATCH_SIZES} at the ragged Lorenzo "
        f"shapes and {PS_WIDE[0]}, and the cross-field case: each field "
        f"bitwise alone and its exact sums rounded once")
    return ocean


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


def bounded_batch(shape, batch: int, rng) -> torch.Tensor:
    """``batch`` planes of :func:`bounded_plane`, ``(batch, n0, n1)``."""
    return torch.stack([bounded_plane(shape, rng) for _ in range(batch)])


def check_prefix_stats_batch(p: torch.Tensor, errs: dict, what_tag: str):
    """The batched prefix stats (both passes, one launch each for the
    batch) on bounded planes: the edges and corner sums bitwise their
    plain versions; each field's sums bitwise the field alone and its exact
    sums rounded once, within rtol 1e-5 of the plain version; the batch
    bitwise on a second launch.  Errors noted under the
    ``lorenzo_moments`` sites, one field and "x8" alike."""
    want = fused.lorenzo_edge_prefixes_plain(p, fused.lorenzo_tile())
    want += (prefix_stats.corner_sums_plain(want[1],
                                            prefix_stats.corner_cols()),)
    gaps = {"edges": bitwise_err(want, prefix_stats.stats_edges(
        p, "lorenzo_moments"), f"batched prefix stats edges {what_tag}")}
    got = prefix_stats.prefix_stats_batch(p)
    bitwise_err(got, prefix_stats.prefix_stats_batch(p),
                f"batched prefix stats twice {what_tag}")
    gaps["stats"] = 0.0
    for b in range(p.shape[0]):
        what = f"batched prefix stats {what_tag} field {b}"
        bitwise_err(prefix_stats.prefix_stats_batch(p[b]), got[b],
                    f"{what} vs alone")
        gaps["stats"] = max(gaps["stats"], stat_err(
            prefix_stats.prefix_stats2d_plain(p[b]), tuple(got[b]), what))
        exact_stats(p[b], tuple(got[b]), what)
    for part, gap in gaps.items():
        for key in (f"lorenzo_moments.{part}", f"lorenzo_moments.{part} x{BATCH}"):
            _note(errs, key, gap)
    return got


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


#: the rank-3 path's fields: a padded layout (8^3 blocks) of three components
RANK3 = (40, 45, 70)


def rank3_path(seed: int) -> None:
    """Rank-3 HSZp-nd fields on the card through ``oplib.compute``: the
    derivative along each axis, the gradient, divergence and 3-D curl at ②
    ③ ④, one field and a batch of three, bitwise the torch rules (fused
    rules off) and the CPU port."""
    from repro_torch.core.stages import batch_stack
    comp = by_name("hszp_nd", (8, 8, 8))
    rng = np.random.default_rng(seed)
    raw = [np.cumsum(np.cumsum(rng.normal(0, 1, RANK3), 0), 2).astype(
        np.float32) for _ in range(3)]
    cs = [comp.compress(torch.as_tensor(x, device=DEVICE), rel_eb=REL_EB,
                        device=DEVICE) for x in raw]
    bits = max(comp.max_bits(c) for c in cs)
    es = [comp.encode(c, bits=bits) for c in cs]
    cpu = [convert.from_arrays(*convert.to_arrays(e), device="cpu")
           for e in es]
    for stage in (Stage.P, Stage.Q, Stage.F):
        cells = [(es[0], cpu[0], ("derivative",), a) for a in range(3)]
        cells += [(es[0], cpu[0], ("gradient",), 0),
                  (batch_stack(es), None, ("derivative",), 2),
                  (es, cpu, ("divergence", "curl"), 0)]
        for target, host, names, axis in cells:
            got = oplib.compute(target, list(names), stage, axis=axis)
            with ops.override_mode("off"):
                want = oplib.compute(target, list(names), stage, axis=axis)
            for n in names:
                bitwise_err(want[n], got[n], f"rank-3 {n} axis {axis} {stage}")
                if host is not None:
                    ref = oplib.compute(host, [n], stage, axis=axis)[n]
                    bitwise_err(tuple(x.to(DEVICE) for x in _tup(ref)),
                                got[n], f"rank-3 {n} axis {axis} {stage} "
                                "against the CPU port")
    say(f"rank-3 path: {RANK3} in 8^3 blocks at {bits} bits, every axis, "
        "② ③ ④, batched and not: bitwise the torch rules and the CPU port")


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
#: plane instantiations: no payload kernel, no unpack; the stencil pass
#: writes the f32 answer)
REGION_LZ_KERNELS = ("lorenzo_edges_kernel<false>", "lorenzo_scan_kernel",
                     "lorenzo_stencil_kernel<false, 2, 1>")


def region_query_kernels(fields, tag: str) -> None:
    """The device kernels of one ``Encoded`` sub-basin Lorenzo gradient@③
    query from a ``torch.profiler`` trace: the gather-unpack's torch ops,
    then the three residual-plane Lorenzo kernels, the last writing the f32
    answer: no float tail after them."""
    eu, ev = fields["hszp_nd"]["Encoded"]
    names, events = traced_kernels(
        lambda: run_cell("gradient", Stage.Q, eu, ev, R_BASIN))
    first = next((i for i, k in enumerate(names)
                  if k.startswith("lorenzo_")), None)
    ours = names[first:first + 3] if first is not None else []
    if (len(ours) != 3
            or any(not k.startswith(w) for k, w in zip(ours, REGION_LZ_KERNELS))
            or len(names) != first + 3
            or any(k.startswith(("unpack_kernel", "blockmean_kernel"))
                   or "<true" in k for k in names)):
        fail(f"Encoded region gradient@Q: kernels {names}")
    say(f"[{tag}] hszp_nd Encoded gradient@Q on the sub-basin, device "
        f"kernels: {first} of the gather-unpack "
        f"({_listed(names[:first], events[:first])}); then "
        f"{_listed(names[first:first + 3], events[first:first + 3])}; no "
        "float tail")


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


def _moment_sites(scheme: str, stage: Stage, ops_,
                  region: bool) -> tuple[str, ...]:
    """The prefix-stats passes that a full-field Lorenzo context at ②
    launches once, however many of ``mean`` / ``std`` it serves (the rules
    share ``StageContext.lorenzo_moments``; the fields here are 2-D and on
    the card); none on a region."""
    if (scheme == "hszp_nd" and Stage(stage) == Stage.P and not region
            and {"mean", "std"} & set(ops_)):
        return ("lorenzo_moments.edges", "lorenzo_moments.stats")
    return ()


def expected_launches(contexts, region: bool = False) -> dict:
    """Launches per site that a list of stage contexts implies.  A context
    ``(container, scheme, stage, seed, ops)`` (``seed`` None or the seed's
    stage; ``ops`` its op applications, a vector op as one ``derivative``
    per differentiated axis) launches :func:`_op_sites` per application
    and :func:`_moment_sites` once, and decodes its payload once when an op
    whose torch rule runs reads the residuals or integers (every torch rule
    but the stage-① mean) and no seed holds them.  ``region``: the
    contexts run on a region plan."""
    want = dict.fromkeys(PATHS["engine path"], 0)
    for container, scheme, stage, seed, ops_ in contexts:
        for op in ops_:
            for site in _op_sites(op, container, scheme, stage, seed):
                want[site] += 1
        for site in _moment_sites(scheme, stage, ops_, region):
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
    :func:`expected_launches`).  A batch is one context (one per component
    of a vector set): its fields stacked, and a seeded or store-hit batch's
    seeds stacked, every kernel launched once for the batch; a store miss
    materializes each field in a context of its own first; expression
    leaves are one context each."""
    kind, scheme = key[0], key[1]
    if kind == "a":
        stage = analytics.plan_stages(scheme, ENGINE_SET, key[3]).fused
        return [(key[2], scheme, stage, None, ENGINE_SET)]
    if kind == "b":
        return [("Encoded", scheme, key[2], None, ops_)
                for ops_ in _component_ops(VECTOR_SET)]
    if kind == "c" and key[2] == "flat":
        # one batch per layout: the Compressed pair, the Encoded pair
        groups = {}
        for i, f in enumerate(mixed_batch(fields, scheme)):
            groups.setdefault(type(f).__name__, res.stages[i]["mean"])
        return [(name, scheme, stage, None, ENGINE_SET)
                for name, stage in groups.items()]
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
    seeded = [("Encoded", scheme, stage, min(stage, Stage.Q), ops_)]
    if key[2].endswith("miss"):
        # each miss materializes the field once: one decode, no band kernel
        # and no statistic
        return [("Encoded", scheme, stage, None, ["materialize"])] * 8 + seeded
    return seeded


def batched_run(key) -> bool:
    """Is engine query ``key`` one batched run: (a), (b), or a seeded (d)
    run over the store's hits?"""
    return key[0] in ("a", "b") or (key[0] == "d"
                                    and not key[2].endswith("miss"))


def check_engine_launches(fields, out) -> tuple[dict, dict]:
    """Every query's launches against what its plan implies; returns the
    engine path's launches per site, summed over its queries and over its
    batched runs (:func:`batched_run`)."""
    total = dict.fromkeys(ops.LAUNCHES, 0)
    batched = dict.fromkeys(ops.LAUNCHES, 0)
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
            if batched_run(key):
                batched[k] += n
        detail(f"  engine {key}: launches "
               f"{json.dumps({k: n for k, n in got.items() if n})}")
    say(f"engine path: the launches of its {len(out)} queries == their "
        f"plans' (a batch, full-field or store-seeded: one decode and one "
        f"band-kernel set per covered op, or one stage-③ difference kernel, "
        f"for the whole batch, each pass one launch; expressions: at most "
        f"one decode per Encoded leaf; no unpack and no payload kernel in "
        f"the seeded and store-hit runs)")
    n_runs = sum(batched_run(key) for key in out)
    say(f"engine path: its {n_runs} batched runs ((a): 8 fields; (b): 4 "
        f"pairs; (d) hits: 8 seeds stacked) launched "
        f"{json.dumps({k: n for k, n in batched.items() if n})}")
    return total, batched


# -- phase 5b batches: region and store-seeded programs over 8 fields --------

#: the windows batched over the engine phase's eight fields: the sub-basin
#: (its stage-③ window 1201 x 1803 has an odd element count, so a stacked
#: seed's fields past the first start off 16 bytes), the transect and the
#: far corner
BATCH_WINDOWS = ("basin", "transect", "corner")
#: the unseeded runs on each window: (op set, stage, vector)
REGION_BATCH_RUNS = ((ENGINE_SET, Stage.P, False), (ENGINE_SET, Stage.Q, False),
                     (VECTOR_SET, Stage.P, True))


def _vector_contexts(container, scheme, stage, seed, ops_) -> list:
    return [(container, scheme, stage, seed, o) for o in _component_ops(ops_)]


def region_batch_contexts(container, scheme, stage, ops_, vector: bool,
                          seed=None) -> list:
    """The stage contexts of one batched region run: one per component.
    An unseeded region context gathers its closure's words with torch ops
    and runs the residual-plane kernels on the gathered sub-planes, as a
    ``Compressed`` context does."""
    if seed is None:
        container = "Compressed"
    if vector:
        return _vector_contexts(container, scheme, stage, seed, ops_)
    return [(container, scheme, stage, seed, ops_)]


def _same_items(batched: dict, singles: list, names, what: str) -> None:
    """A batched run's results, field by field, bitwise the per-field
    calls'."""
    for i, one in enumerate(singles):
        for op in names:
            bitwise_err(one[op], _item(batched[op], i), f"{what} {op} {i}")


def _region_seeds(fs, stage: Stage, window) -> list:
    cl = oplib.set_closure(ENGINE_SET, fs[0].scheme, stage)
    return [materialize(f, stage, region=window, closure=cl) for f in fs]


def region_batches(fields, eng) -> tuple[dict, int]:
    """Region and store-seeded programs as one batch (phase 5b batches): on
    each of :data:`BATCH_WINDOWS`, per scheme and container, the op set at
    ② and ③ over the eight fields and divergence / curl at ② over the four
    pairs, then ``materialize`` at ② and ③ of each field and the op set
    seeded at ②, ③ and ④.  Each run is counted on its own and held to one
    context per component (each kernel pass one launch for the batch), and
    its results bitwise the per-field ``compute`` calls (the seeded ones
    also the unseeded batch).  Returns the launches summed and the runs."""
    total = dict.fromkeys(ops.LAUNCHES, 0)
    n = 0

    def check(what, got, contexts):
        want = expected_launches(contexts, region=True)
        bad = {k: (got[k], want.get(k, 0)) for k in got
               if got[k] != want.get(k, 0)}
        if bad:
            fail(f"5b batch {what}: launches (got, plan) {bad}")
        for k, c in got.items():
            total[k] += c

    for scheme in SCHEMES:
        for container in ("Encoded", "Compressed"):
            fs = fields[scheme][container]
            pairs = list(zip(fs[0::2], fs[1::2]))
            for name in BATCH_WINDOWS:
                window = WINDOWS[name]
                cold = {}
                for names, stage, vector in REGION_BATCH_RUNS:
                    items = pairs if vector else fs
                    what = (f"{scheme} {container} {name} {list(names)}"
                            f"@{stage.name}")
                    res, got = counted(eng.run, items, names, stage,
                                       region=window)
                    check(what, got, region_batch_contexts(
                        container, scheme, stage, names, vector))
                    _same_items(res, [oplib.compute(
                        list(it) if vector else it, names, stage,
                        region=window) for it in items], names, what)
                    if not vector:
                        cold[stage] = res
                    n += 1
                seeds = {st: _region_seeds(fs, st, window)
                         for st in (Stage.P, Stage.Q)}
                for stage in SET_STAGES:
                    seed = min(stage, Stage.Q)
                    what = (f"{scheme} {container} {name} seeded at "
                            f"{Stage(seed).name} {list(ENGINE_SET)}"
                            f"@{stage.name}")
                    res, got = counted(eng.run, fs, ENGINE_SET, stage,
                                       region=window, seeds=seeds[seed])
                    check(what, got, region_batch_contexts(
                        container, scheme, stage, ENGINE_SET, False, seed))
                    if any(got[k] for k in PAYLOAD_SITES):
                        fail(f"5b batch {what}: a seeded run decoded")
                    _same_items(res, [oplib.compute(
                        f, ENGINE_SET, stage, region=window, seed=sd)
                        for f, sd in zip(fs, seeds[seed])], ENGINE_SET, what)
                    if stage in cold:
                        _same_items(res, [{op: _item(cold[stage][op], i)
                                           for op in ENGINE_SET}
                                          for i in range(len(fs))],
                                    ENGINE_SET, f"{what} vs unseeded")
                    n += 1
                del seeds, cold
    torch.cuda.synchronize()
    say(f"5b batches: {n} region and seeded runs over 8 fields (4 pairs) on "
        f"{list(BATCH_WINDOWS)}, each one context per component (every "
        f"kernel pass one launch for the batch, no decode in a seeded run), "
        f"bitwise the per-field compute calls (seeded: and the unseeded "
        f"batch); launches {json.dumps({k: c for k, c in total.items() if c})}")
    return total, n


def time_region_batches(fields, tag: str) -> None:
    """Host ms (median and quartiles of ``E2E_REPS``) of the op set over
    the sub-basin at ③ as one batched run against the 8 per-field
    ``compute`` calls, unseeded and seeded with each field's ③ window (the
    batch stacks the 8 seeds: a copy of 8 x 8.66 MB), and the device's busy
    share of each from a ``torch.profiler`` trace."""
    eng = analytics.BatchedAnalytics()
    part = functools.partial
    for scheme in SCHEMES:
        for container in ("Encoded", "Compressed"):
            fs = fields[scheme][container]
            seeds = _region_seeds(fs, Stage.Q, R_BASIN)
            forms = {
                "one run": part(eng.run, fs, ENGINE_SET, Stage.Q,
                                region=R_BASIN),
                "8 compute calls": lambda fs=fs: [
                    oplib.compute(f, ENGINE_SET, Stage.Q, region=R_BASIN)
                    for f in fs],
                "seeded, one run": part(eng.run, fs, ENGINE_SET, Stage.Q,
                                        region=R_BASIN, seeds=seeds),
                "seeded, 8 compute calls": lambda fs=fs, seeds=seeds: [
                    oplib.compute(f, ENGINE_SET, Stage.Q, region=R_BASIN,
                                  seed=sd) for f, sd in zip(fs, seeds)]}
            parts, traces = [], []
            for form, fn in forms.items():
                parts.append(f"{form} {_spread(host_ms(fn, E2E_REPS))}")
                # the profiler has dropped every device event of a short
                # call's trace: count a trace only when it holds them all
                kernels, busy, span = trace_window(fn, "region.batch",
                                                   whole=True)
                traces.append(f"{form}: device busy {busy:.1f} of "
                              f"{span:.1f} us ({busy / span:.1%}), "
                              f"{len(kernels)} kernels")
            say(f"[{tag}] 5b batch {scheme} {container} {list(ENGINE_SET)}@Q "
                f"on the sub-basin over 8 fields: " + "; ".join(parts)
                + f"; median of {E2E_REPS}; traces: " + "; ".join(traces))
            del seeds


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
    loop = functools.partial(_seeded_each, enc, store)
    for i, one in enumerate(loop()):
        for op in ENGINE_SET:
            bitwise_err(want[i][op], one[op], f"(d) {scheme} ③ seeded compute "
                        f"{op} {i}")
    parts.append(f"the 8 seeds one field at a time (8 seeded compute calls, "
                 f"no stack) {_spread(host_ms(loop, E2E_REPS))}")
    say(f"[{tag}] engine (d) {scheme} Encoded ③ hit over 8 fields, results "
        f"equal bitwise: " + "; ".join(parts) + f"; median of {E2E_REPS}")


def _seeded_each(fields, store) -> list:
    """The ③ op set over ``fields`` (held in ``store`` as ``f0``, ``f1``,
    ...) as one seeded ``compute`` call per field on its resident seed: the
    loop a seeded batch replaces."""
    return [oplib.compute(f, ENGINE_SET, Stage.Q,
                          seed=store.seed(f"f{i}", Stage.Q))
            for i, f in enumerate(fields)]


#: the marker kernel around a trace (``torch.cuda._sleep``, about 50 us),
#: launched ``SPINS_BEFORE`` times before the traced call and once after it
SPIN = re.compile(r"spin_kernel")
SPIN_CYCLES = 100_000
#: the profiler has dropped the first 4 device events of three traces in a
#: row (every leading marker when there were 4), so 8 lead the call
SPINS_BEFORE = 8
#: traces taken of one call before a trace without its markers fails
TRACE_TRIES = 5


def profiled(run, what: str, whole: bool = False) -> list:
    """The ``torch.profiler`` events (CPU and CUDA activity) of one
    ``run()`` between ``spin_kernel`` markers, each followed by a
    synchronize: ``SPINS_BEFORE`` before the call, one after it.  The
    profiler has dropped the first device events of a trace, once every
    kernel of one (PERF.md §7), so a trace counts only when it holds a
    device event of the call and, where ``whole``, its trailing marker and
    a leading one, i.e. every kernel of the call; it is taken again, up to
    ``TRACE_TRIES`` times, until one does.  The markers are taken out of
    the events returned."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.autograd.DeviceType.CUDA
    for attempt in range(1, TRACE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(SPINS_BEFORE):
                torch.cuda._sleep(SPIN_CYCLES)
                torch.cuda.synchronize()
            run()
            torch.cuda.synchronize()
            torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
        events = list(prof.events())
        device = sorted((e for e in events if e.device_type == cuda),
                        key=lambda e: e.time_range.start)
        spins = [i for i, e in enumerate(device) if SPIN.search(e.name)]
        if len(spins) < len(device) and (not whole or (
                len(spins) >= 2 and spins[-1] == len(device) - 1)):
            return [e for e in events if not SPIN.search(e.name)]
        say(f"[trace] {what}: trace {attempt} of {TRACE_TRIES} holds "
            f"markers at {spins} of {len(device)} device events")
    fail(f"torch.profiler dropped device events of {TRACE_TRIES} traces of "
         f"{what}")


def trace_window(fn, label: str,
                 whole: bool = False) -> tuple[list, float, float]:
    """``fn()`` and a synchronize under one ``record_function`` in a
    ``torch.profiler`` trace: ``(device kernels, busy µs, window µs)``,
    busy being the union of the kernels' spans inside the window; with
    ``whole``, a trace that holds every kernel of the call
    (:func:`profiled`)."""
    from torch.profiler import record_function

    def run():
        with record_function(label):
            fn()
            torch.cuda.synchronize()

    events = profiled(run, label, whole)
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
    """A ``torch.profiler`` trace of one (a) call per scheme and container
    at "auto" (one batched run) beside the same op set as eight per-field
    ``compute`` calls, and of one (d) ③ hit: the device kernels by name
    with their count and device µs, and the device's busy share of the
    call's window."""
    eng = analytics.BatchedAnalytics()
    for scheme in SCHEMES:
        stage = analytics.plan_stages(scheme, ENGINE_SET, "auto").fused
        calls = {}
        for container in ("Encoded", "Compressed"):
            fs = fields[scheme][container]
            calls[f"(a) {{}} {container} @auto({stage.name}), one batched "
                  "run"] = functools.partial(eng.run, fs, ENGINE_SET, "auto")
            calls[f"(a) {{}} {container} @{stage.name}, 8 per-field compute "
                  "calls"] = functools.partial(_compute_each, fs, ENGINE_SET,
                                               stage)
        fs = fields[scheme]["Encoded"]
        hot = FieldStore(cache_bytes=STORE_BYTES)
        for i, f in enumerate(fs):
            hot.put(f"f{i}", f)
        calls["(d) {} Encoded ③ hit"] = functools.partial(
            _store_query, fs, ENGINE_SET, Stage.Q, eng, hot)
        calls["(d) {} Encoded ③ hit as 8 seeded compute calls"] = \
            functools.partial(_seeded_each, fs, hot)
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
HOT_REPS, COLD_REPS = 30, 30


def stream_slabs(u: np.ndarray, v: np.ndarray, seed: int,
                 n: int = STREAM_SLABS):
    """The first ``n`` of the 8 slabs, made on the card one at a time:
    (STREAM_K, *OCEAN) f32.
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
        for i in range(n):
            noise = torch.as_tensor(pending.result(), device=DEVICE)
            if i + 1 < n:
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


def stream_expected(container: str, full_groups: int) -> dict:
    """Launches of a stream call that summarizes slabs in ``full_groups``
    batches over the full field: one ``unpack.residuals`` per batch (a
    layout group of slabs, stacked and decoded in one launch) for an
    ``Encoded`` stream; a region cell gathers its words with torch ops, a
    ``Compressed`` slab has nothing to decode, no band kernel runs."""
    want = dict.fromkeys(ops.LAUNCHES, 0)
    if container == "Encoded":
        want["unpack.residuals"] = full_groups
    return want


def n_layouts(tf) -> int:
    """The layout groups of a stream's slabs: one summarize (one batch)
    each in a cold query."""
    return len({layout_key(s) for s in tf.slabs})


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
    (one decode per layout group of slabs for a full-field ``Encoded``
    query, none otherwise)."""
    eng = out["eng"]
    n = 0
    for key, tf in out["streams"].items():
        for cell, region in STREAM_CELLS.items():
            for stage in ("auto", Stage.P, Stage.Q, Stage.F):
                res, got = counted(query_temporal, [tf], list(TOPS), stage,
                                   region=region, engine=eng)
                check_stream_launches(
                    f"5d storeless {key} {cell} @{stage}", got,
                    stream_expected(key[1], n_layouts(tf) if region is None
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
    ``Encoded`` ids' summaries (one decode per layout group of slabs each),
    nothing for the raw ``Compressed`` stream."""
    store = StreamFieldStore(1 << 30, engine=out["eng"])
    a, b = ("hszp_nd", "Encoded"), ("hszx_nd", "Encoded")
    c = ("hszp_nd", "Compressed")
    store.put_temporal("a", out["streams"][a])
    store.put_temporal("b", out["streams"][b])
    res, got = counted(analytics.query, exprs=[
        expr.tmean("a") - expr.tmean("b"),
        expr.tdelta(out["streams"][c])], store=store, engine=out["eng"])
    check_stream_launches("5d expressions", got, stream_expected(
        "Encoded", n_layouts(out["streams"][a]) + n_layouts(out["streams"][b])))
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
        batch = functools.partial(query_temporal, [tf], list(TOPS),
                                  engine=out["eng"])
        stage = analytics.plan_stage(tf.scheme, "tmean", "auto")
        loop = functools.partial(per_slab_summary, tf, stage)
        same_summary(_cold_summary(tf, stage, None, out["eng"])[0], loop(),
                     f"5d {fid} per-slab summaries vs the batches")
        for form, fn in (("cold storeless full-field query over "
                          f"{STREAM_SLABS} slabs ({n_layouts(tf)} layout "
                          "groups, one summarize each)", batch),
                         (f"its summaries one slab at a time ({STREAM_SLABS}"
                          f" summarize_slab calls at {stage.name}, merged)",
                          loop)):
            parts.append(f"{form} {_spread(host_ms(fn, COLD_REPS))} of "
                         f"{COLD_REPS}, peak {peak_mib(fn)}")
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


def per_slab_summary(tf, stage, region=None):
    """A stream's merged summary from one ``summarize_slab`` call per slab
    (no batch): the loop a cold query's batched summarize replaces."""
    return functools.reduce(oplib.merge_summaries, [
        oplib.summarize_slab(s, stage, region=region) for s in tf.slabs])


def peak_mib(fn) -> str:
    """The device memory ``fn()`` allocates at its peak, above what was
    allocated before it, and the allocator's peak in all."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return (f"+{(peak - base) / 2 ** 20:.0f} MiB over {base / 2 ** 20:.0f} "
            f"MiB allocated (max_memory_allocated {peak / 2 ** 30:.2f} GiB)")


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
        stage = analytics.plan_stage(tf.scheme, "tmean", "auto")
        kernels, busy, span = trace_window(
            functools.partial(per_slab_summary, tf, stage), "stream.loop")
        say(f"[{tag}] stream {scheme} Encoded summaries one slab at a time "
            f"({STREAM_SLABS} summarize_slab calls at {stage.name}) trace: "
            + trace_lines(kernels, busy, span))
        del slab, scratch, store


# ===========================================================================
# phase 5e: the serve path — AnalyticsFrontend over a StoreRouter of a
# ShardedFieldStore and a StreamFieldStore
# ===========================================================================

#: the sharded store's meshes, by label: 8 shards on one card, then 1 shard
#: (one shard per card is added where the machine has more than one)
SERVE_MESHES = {"8 shards on cuda:0": ["cuda:0"] * 8, "1 shard": ["cuda:0"]}
#: id prefix -> scheme of the Ocean (u, v) pair held by id
SERVE_SCHEMES = {"p": "hszp_nd", "x": "hszx_nd"}
#: budgets: every cell of the step stays resident in every store, so the
#: residency that "auto" plans read evolves alike in all of them
SERVE_SHARD_BYTES = 2 << 30
SERVE_SINGLE_BYTES = 16 << 30
#: appends per temporal id: phase 5d's first two slabs (8 timesteps each)
SERVE_APPENDS = 2
#: the temporal ids: sharded, local
SERVE_TEMPORAL = ("s/T", "local/T")
#: host-clock repetitions of a warm step
STEP_REPS = 30
#: the eviction check's region cells (hszx_nd u): block rows 0 and 1, homed
#: on shards 0 and 1, and block row 8, homed on shard 0 again
EVICT_ROWS = ((0, 16), (16, 32), (128, 144))
#: malformed request -> the exception type the reference rejects it with
#: (``tests/test_torch_serve.py`` holds the port's types equal to it)
MALFORMED = {"unknown id": "KeyError", "empty op set": "ValueError",
             "region out of bounds": "ValueError",
             "duplicate component ids": "ValueError"}


def _stage_name(st) -> str:
    return st if isinstance(st, str) else st.name


def serve_specs() -> list[tuple[str, dict]]:
    """The step's analytics requests as (label, ``AnalyticsRequest``
    fields): per scheme on sharded ids, mean and std at auto / ② / ③,
    gradient and laplacian at ③ / ④, derivative on axis 1, an op set,
    divergence and curl over vector ids, a sub-basin and a transect; two
    expressions; requests on local ids; four malformed ones; tmean / tstd /
    tdelta over each store's temporal id."""
    specs = []
    for k in SERVE_SCHEMES:
        u, v = f"{k}/u", f"{k}/v"
        for st in ("auto", Stage.P, Stage.Q):
            for op in ("mean", "std"):
                specs.append((f"{op}@{_stage_name(st)} {u}",
                              dict(fields=u, op=op, stage=st)))
        for op in ("gradient", "laplacian"):
            for st in (Stage.Q, Stage.F):
                specs.append((f"{op}@{st.name} {u}",
                              dict(fields=u, op=op, stage=st)))
        specs += [
            (f"derivative axis 1@Q {u}",
             dict(fields=u, op="derivative", stage=Stage.Q, axis=1)),
            (f"op set mean+std+laplacian@Q {v}",
             dict(fields=v, op=["mean", "std", "laplacian"], stage=Stage.Q)),
            (f"divergence@Q ({u}, {v})",
             dict(fields=(u, v), op="divergence", stage=Stage.Q)),
            (f"curl@P ({u}, {v})",
             dict(fields=(u, v), op="curl", stage=Stage.P)),
            (f"sub-basin mean@Q {u}",
             dict(fields=u, op="mean", stage=Stage.Q, region=R_BASIN)),
            (f"transect gradient@P {u}",
             dict(fields=u, op="gradient", stage=Stage.P,
                  region=R_TRANSECT))]
    specs += [("vorticity curl(p/u, p/v)",
               dict(exprs=expr.curl(("p/u", "p/v")))),
              ("mean(x/u) - mean(x/v)",
               dict(exprs=expr.mean("x/u") - expr.mean("x/v")))]
    for k in SERVE_SCHEMES:
        # gradient@Q on the local id joins gradient@Q on the sharded one in
        # one group: two seeds stacked, one kernel launch for both
        specs += [(f"mean@Q local/{k}/u",
                   dict(fields=f"local/{k}/u", op="mean", stage=Stage.Q)),
                  (f"gradient@P local/{k}/u",
                   dict(fields=f"local/{k}/u", op="gradient",
                        stage=Stage.P)),
                  (f"gradient@Q local/{k}/u",
                   dict(fields=f"local/{k}/u", op="gradient",
                        stage=Stage.Q))]
    specs += [("unknown id", dict(fields="ghost", op="mean")),
              ("empty op set", dict(fields="p/u", op=[])),
              ("region out of bounds",
               dict(fields="p/u", op="mean", region=((0, 5000), (0, 10)))),
              ("duplicate component ids",
               dict(fields=("p/u", "p/u"), op="curl"))]
    for fid in SERVE_TEMPORAL:
        specs.append((f"tmean+tstd+tdelta {fid}",
                      dict(fields=fid, op=["tmean", "tstd", "tdelta"])))
    return specs


def serve_requests(slabs, appends: bool = True) -> list:
    """Fresh request objects of one step: the appends (two slabs into each
    temporal id), then the analytics requests of :func:`serve_specs`."""
    pairs = [(slab, fid) for slab in slabs for fid in SERVE_TEMPORAL]
    reqs = [AppendRequest(uid=i, field_id=fid, data=slab)
            for i, (slab, fid) in enumerate(pairs if appends else ())]
    n = len(reqs)
    return reqs + [AnalyticsRequest(uid=n + i, **kw)
                   for i, (_, kw) in enumerate(serve_specs())]


def serve_temporal() -> TemporalField:
    """A temporal id's stream: ``hszx_nd``, ``Compressed`` slabs (a banded
    summary's region decode of an ``Encoded`` slab gathers its words with
    host-built plans, one per band: 300 bands at Ocean size)."""
    return TemporalField("hszx_nd", rel_eb=REL_EB, bits=None, device=DEVICE)


def serve_stores(fields, devices, eng):
    """A ``ShardedFieldStore`` over ``devices`` holding the ``Encoded`` (u,
    v) of both schemes and ``s/T``, and a local ``StreamFieldStore`` holding
    the same containers under ``local/`` ids and ``local/T``."""
    sharded = ShardedFieldStore(make_analytics_mesh(devices=devices),
                                SERVE_SHARD_BYTES, engine=eng)
    local = StreamFieldStore(SERVE_SINGLE_BYTES, engine=eng)
    for k, scheme in SERVE_SCHEMES.items():
        for name, e in zip("uv", fields[scheme]["Encoded"]):
            sharded.put(f"{k}/{name}", e)
            local.put(f"local/{k}/{name}", e)
    sharded.put_temporal(SERVE_TEMPORAL[0], serve_temporal())
    local.put_temporal(SERVE_TEMPORAL[1], serve_temporal())
    return sharded, local


def single_store(fields, eng) -> StreamFieldStore:
    """One single-device store holding every id of the step."""
    store = StreamFieldStore(SERVE_SINGLE_BYTES, engine=eng)
    for k, scheme in SERVE_SCHEMES.items():
        for name, e in zip("uv", fields[scheme]["Encoded"]):
            store.put(f"{k}/{name}", e)
            store.put(f"local/{k}/{name}", e)
    for fid in SERVE_TEMPORAL:
        store.put_temporal(fid, serve_temporal())
    return store


@contextlib.contextmanager
def group_queries():
    """Record each group query the frontend issues: its ``n_dispatches``."""
    mod = sys.modules["repro_torch.serve.analytics"]
    seen, real = [], {n: getattr(mod, n) for n in ("_query_opset", "query")}

    def spy(name):
        def call(*args, **kw):
            res = real[name](*args, **kw)
            seen.append(res.n_dispatches)
            return res
        return call

    for name in real:
        setattr(mod, name, spy(name))
    try:
        yield seen
    finally:
        for name, fn in real.items():
            setattr(mod, name, fn)


def serve_step(fe, reqs) -> dict:
    """One frontend step over ``reqs``: uid -> finished request."""
    for r in reqs:
        fe.add_request(r)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return {r.uid: r for r in fe.step()}


def expected_dispatches(reqs, store) -> list[int]:
    """The groups a step forms by the reference's rule, and the dispatches
    each issues: analytics requests group by (canonical op set, stage, axis,
    normalized region, layout), expression requests by (stage, region);
    malformed ones form none.  A spatial or expression group issues one
    dispatch; a temporal group one postlude per stream it holds."""
    groups: dict[tuple, int] = {}
    for r in reqs:
        if isinstance(r, AppendRequest) or r.error is not None:
            continue
        if r.exprs is not None:
            groups[("expr", str(r.stage), repr(r.region))] = 1
            continue
        ops_ = oplib.canonical_ops(r.op)
        ids = r.fields if isinstance(r.fields, tuple) else (r.fields,)
        items = [store.get(f) for f in ids]
        lay = tuple(c.layout_sig() if hasattr(c, "layout_sig")
                    else layout_key(c) for c in items)
        sig = (ops_, str(r.stage), r.axis, r.region, lay)
        temporal = oplib.is_temporal_ops(ops_)
        groups[sig] = groups.get(sig, 0) + 1 if temporal else 1
    return sorted(groups.values())


def same_result(want, got, what: str) -> None:
    if isinstance(want, dict):
        if sorted(want) != sorted(got):
            fail(f"{what}: ops {sorted(got)} vs {sorted(want)}")
        for k in want:
            bitwise_err(want[k], got[k], f"{what} {k}")
    elif isinstance(want, list):
        for i, (w, g) in enumerate(zip(want, got, strict=True)):
            bitwise_err(w, g, f"{what} [{i}]")
    else:
        bitwise_err(want, got, what)


def check_serve_step(done: dict, ref: dict, labels: dict, what: str) -> None:
    """Every request answered or rejected; the malformed ones rejected with
    the reference's exception type and nothing else rejected; every answer
    bitwise the single-device frontend's, at the same stage."""
    if sorted(done) != sorted(ref):
        fail(f"{what}: finished uids {sorted(done)} vs {sorted(ref)}")
    for uid, r in done.items():
        label = labels.get(uid, "append")
        if label in MALFORMED:
            if r.error is None or not r.error.startswith(
                    MALFORMED[label] + ": "):
                fail(f"{what} {label}: rejected as {r.error!r}, want a "
                     f"{MALFORMED[label]}")
            continue
        if r.error is not None:
            fail(f"{what} {label}: rejected: {r.error}")
        w = ref[uid]
        if isinstance(r, AppendRequest):
            if r.slab_index != w.slab_index:
                fail(f"{what} append {uid}: slab {r.slab_index}")
            continue
        if repr(r.result_stage) != repr(w.result_stage):
            fail(f"{what} {label}: stage {r.result_stage} vs "
                 f"{w.result_stage}")
        same_result(w.result, r.result, f"{what} {label}")


def replay_query(store, kw: dict):
    """One request's ``query()`` against ``store``."""
    if "exprs" in kw:
        return analytics.query(exprs=kw["exprs"], store=store)
    return flat_query([kw["fields"]], kw["op"], kw.get("stage", "auto"),
                      axis=kw.get("axis", 0), region=kw.get("region"),
                      store=store)


def replay(fields, slabs, devices, label: str) -> dict:
    """Every request of the step as its own ``query()`` (appends as
    ``append``) against fresh stores over ``devices`` behind a router and
    against one fresh single-device store, in the step's order: the values
    bitwise equal and the launches equal, request by request."""
    eng = analytics.BatchedAnalytics()
    sharded, local = serve_stores(fields, devices, eng)
    router, single = StoreRouter(sharded, local), single_store(fields, eng)
    total = dict.fromkeys(ops.LAUNCHES, 0)
    n = 0
    for slab in slabs:
        for fid in SERVE_TEMPORAL:
            _, a = counted(single.append, fid, slab)
            _, b = counted(router.append, fid, slab)
            if a != b:
                fail(f"5e {label} append {fid}: launches {b} vs {a}")
    for name, kw in serve_specs():
        if name in MALFORMED:
            continue
        want, a = counted(replay_query, single, kw)
        got, b = counted(replay_query, router, kw)
        if a != b:
            diff = {k: (b[k], a[k]) for k in a if a[k] != b[k]}
            fail(f"5e {label} {name}: launches (sharded, single) {diff}")
        if got.stages != want.stages:
            fail(f"5e {label} {name}: stages {got.stages} vs {want.stages}")
        for i, (w, g) in enumerate(zip(want.values, got.values, strict=True)):
            same_result(w, g, f"5e {label} {name} [{i}]")
        for k, c in b.items():
            total[k] += c
        n += 1
    detail(f"  5e replay {label}: {n} queries, launches "
           f"{json.dumps({k: c for k, c in total.items() if c})}")
    return {"queries": n, "launches": total}


def check_eviction(fields, devices) -> str:
    """At Ocean size, a per-shard budget of one region cell: the third cell
    evicts the first on their shared home shard and leaves its sibling on
    another shard resident; the evicted cell recomputes bitwise."""
    e = fields["hszx_nd"]["Encoded"][0]
    cells = [((a, b), (0, OCEAN[1])) for a, b in EVICT_ROWS]
    budget = materialized_nbytes(e, Stage.Q, region=cells[0]) + 64
    sv = ShardedFieldStore(make_analytics_mesh(devices=devices), budget)
    sv.put("f", e)
    homes = [sv.shard_of("f", Stage.Q, region=c) for c in cells]
    if not (homes[0] != homes[1] and homes[0] == homes[2]):
        fail(f"5e eviction: homes {homes}")
    for c in cells[:2]:
        sv.ensure("f", Stage.Q, region=c)
    sv.ensure("f", Stage.Q, region=cells[2])
    resident = [sv.is_resident("f", Stage.Q, region=c) for c in cells]
    st = sv.shard_stats
    if resident != [False, True, True] or sv.stats.evictions != 1 \
            or st[homes[0]].evictions != 1 or st[homes[1]].evictions:
        fail(f"5e eviction: resident {resident}, evictions "
             f"{[s.evictions for s in st]}")
    single = StreamFieldStore(SERVE_SINGLE_BYTES)
    single.put("f", e)
    want = flat_query(["f"], "mean", Stage.Q, region=cells[0], store=single)
    got = flat_query(["f"], "mean", Stage.Q, region=cells[0], store=sv)
    bitwise_err(want.values[0], got.values[0], "5e eviction recompute")
    return (f"a {budget} B budget per shard: rows {EVICT_ROWS[0]} and "
            f"{EVICT_ROWS[2]} homed on shard {homes[0]}, rows {EVICT_ROWS[1]}"
            f" on shard {homes[1]}; the third cell evicted the first and only "
            f"it, the sibling stayed; the evicted cell recomputed bitwise")


def serve_path(fields, u, v, seed: int) -> dict:
    """The step through a frontend over one single-device store (the
    reference), then through a frontend over a router of a sharded store
    and a local one, per mesh; each sharded step counted and held to the
    reference; every request replayed one by one on fresh stores."""
    slabs = list(stream_slabs(u, v, seed, n=SERVE_APPENDS))
    single = single_store(fields, analytics.BatchedAnalytics())
    ref_done = serve_step(AnalyticsFrontend(store=single),
                          serve_requests(slabs))
    n_app = len(slabs) * len(SERVE_TEMPORAL)
    labels = {n_app + i: name for i, (name, _) in enumerate(serve_specs())}
    meshes = dict(SERVE_MESHES)
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        meshes[f"1 shard per card ({min(8, n_cards)} cards)"] = [
            f"cuda:{i}" for i in range(min(8, n_cards))]
    else:
        say("serve path: one shard per card skipped: 1 CUDA device")
    out = {"slabs": slabs, "single": single, "runs": {}, "labels": labels,
           "launches": None}
    for label, devices in meshes.items():
        eng = analytics.BatchedAnalytics()
        sharded, local = serve_stores(fields, devices, eng)
        fe = AnalyticsFrontend(store=StoreRouter(sharded, local))
        reqs = serve_requests(slabs)
        with group_queries() as groups:
            done, launches = counted(serve_step, fe, reqs)
        check_serve_step(done, ref_done, labels, f"5e {label}")
        want = expected_dispatches(reqs, single)
        if sorted(groups) != want:
            fail(f"5e {label}: group queries with dispatches {groups}, "
                 f"want {want} (one per spatial group, one per stream)")
        if out["launches"] is None:
            out["launches"] = launches
        rep = replay(fields, slabs, devices, label)
        out["runs"][label] = {"fe": fe, "sharded": sharded, "local": local,
                              "groups": len(groups), "launches": launches,
                              "replay": rep, "devices": devices}
        n_rej = sum(r.error is not None for r in done.values())
        say(f"serve path, {label}: {len(done)} requests in one step "
            f"({n_app} appends) == the single-device "
            f"frontend's, bitwise, at the same stages; {n_rej} malformed "
            f"rejected with the reference's types, nothing else; "
            f"{len(groups)} groups, {sum(groups)} dispatches (one per "
            f"spatial group, one per temporal stream); launches "
            f"{json.dumps({k: n for k, n in launches.items() if n})}; "
            f"{rep['queries']} requests replayed one by one: launches and "
            f"values == the single-device store's")
    say("serve path eviction: " + check_eviction(
        fields, SERVE_MESHES["8 shards on cuda:0"]))
    return out


def check_group_launches(out) -> None:
    """In a warm step (no appends, every cell resident) each flat group
    query of the frontend, counted on its own, launches what the first of
    its requests launches alone on the same stores: one launch of each
    kernel pass for the group, however many requests it holds."""
    mod = sys.modules["repro_torch.serve.analytics"]
    real = mod._query_opset
    for label, run in out["runs"].items():
        fe = run["fe"]
        serve_step(fe, serve_requests(out["slabs"], appends=False))
        seen = []

        def spy(fields, *args, **kw):
            torch.cuda.synchronize()
            ops.reset_launches()
            res = real(fields, *args, **kw)
            torch.cuda.synchronize()
            seen.append((list(fields), args, kw, dict(ops.LAUNCHES)))
            return res

        mod._query_opset = spy
        try:
            serve_step(fe, serve_requests(out["slabs"], appends=False))
        finally:
            mod._query_opset = real
        shared = []
        for fields, args, kw, got in seen:
            _, alone = counted(real, fields[:1], *args, **kw)
            if got != alone:
                diff = {k: (got[k], alone[k]) for k in got
                        if got[k] != alone[k]}
                fail(f"5e {label} group of {len(fields)} {args}: launches "
                     f"(group, first request alone) {diff}")
            if len(fields) > 1 and any(got.values()):
                shared.append(f"{len(fields)} x {args[0]}@"
                              f"{_stage_name(args[1])} "
                              f"{json.dumps({k: n for k, n in got.items() if n})}")
        if not shared:
            fail(f"5e {label}: no group of several requests launched a kernel")
        say(f"serve path, {label}: every one of the warm step's {len(seen)} "
            f"flat group queries launches what its first request launches "
            f"alone; groups of several requests: " + "; ".join(shared))


def check_merge_launches(out) -> None:
    """The word merge launches none of the port's kernels."""
    sharded = out["runs"]["8 shards on cuda:0"]["sharded"]
    progs = sharded.progs
    for fid in ("p/u", "x/u"):
        e = sharded.get(fid)
        for region in (None, R_BASIN):
            plan = None if region is None else R.plan_region(e, region,
                                                              "hull")
            routing = progs.routing(e, sharded.placement_of(fid), plan)
            n_out = (plan.payload_gather(e.bits).n_words if plan is not None
                     else int(e.payload.numel()))
            _, got = counted(progs.merge_words, sharded._stripes[fid],
                             routing, n_out)
            if any(got.values()):
                fail(f"5e merge {fid} {region}: launched "
                     f"{ {k: n for k, n in got.items() if n} }")


def time_serve(out, tag: str) -> None:
    """Host ms per warm step (no appends) over the sharded router beside the
    single-device store and beside the step's requests as their own
    queries; the word merge's device µs, full field and sub-basin; a
    ``torch.profiler`` trace of one warm sharded step."""
    slabs = out["slabs"]
    ref_fe = AnalyticsFrontend(store=out["single"])
    n = len(serve_specs())
    parts = []
    for label, run in out["runs"].items():
        t = host_ms(lambda fe=run["fe"]: serve_step(
            fe, serve_requests(slabs, appends=False)), STEP_REPS)
        parts.append(f"{label} {_spread(t)}")
    t = host_ms(lambda: serve_step(ref_fe, serve_requests(slabs, False)),
                STEP_REPS)
    parts.append(f"single-device store {_spread(t)}")
    alone = [kw for name, kw in serve_specs() if name not in MALFORMED]
    t = host_ms(lambda: [replay_query(out["single"], kw) for kw in alone],
                STEP_REPS)
    parts.append(f"its {len(alone)} well-formed requests as their own "
                 f"queries on the single-device store {_spread(t)}")
    say(f"[{tag}] serve step of {n} requests (warm stores, no appends), host "
        f"ms, median of {STEP_REPS}: " + "; ".join(parts))
    run = out["runs"]["8 shards on cuda:0"]
    sharded = run["sharded"]
    progs = sharded.progs
    e = sharded.get("p/u")
    for name, region in (("full field", None), ("sub-basin", R_BASIN)):
        plan = None if region is None else R.plan_region(e, region, "hull")
        routing = progs.routing(e, sharded.placement_of("p/u"), plan)
        n_out = (plan.payload_gather(e.bits).n_words if plan is not None
                 else int(e.payload.numel()))
        fn = functools.partial(progs.merge_words, sharded._stripes["p/u"],
                               routing, n_out)
        ev = cuda_ms(fn, REPS)
        alone = graph_ms(fn, REPS)
        w_bytes = 4 * n_out
        say(f"[{tag}] serve word merge, hszp_nd u {name} ({n_out} words of "
            f"{e.bits} bits, 8 shards on one card): {alone * 1e3:.1f} us "
            f"device alone (L2-warm graph of {REPS}), {ev * 1e3:.1f} us by "
            f"events; the merged words {w_bytes / 1e6:.2f} MB")
    fe = run["fe"]
    for _ in range(2):
        serve_step(fe, serve_requests(slabs, appends=False))
    torch.cuda.synchronize()
    kernels, busy, span = trace_window(
        lambda: serve_step(fe, serve_requests(slabs, appends=False)),
        "serve.step")
    say(f"[{tag}] serve step trace (8 shards on one card, warm): "
        + trace_lines(kernels, busy, span))


# ===========================================================================
# phase 7: the static audit on the card — the audit, the library's launch
# attributes against the specs, sentinel-checked coverage at edge shapes
# ===========================================================================

def check_audit() -> None:
    """(a) ``run_audit()`` on this checkout: no error and no warning, with
    the fused rules on and under ``override_mode("off")``."""
    for mode in ("on", "off"):
        t0 = time.perf_counter()
        with ops.override_mode(mode):
            report = audit.run_audit()
        counts = {a: 0 for a in audit.ALL_ANALYZERS}
        for f in report.findings:
            counts[f.analyzer] += 1
        if report.findings:
            fail(f"audit (fused rules {mode}): "
                 + "; ".join(f.render() for f in report.findings))
        say(f"audit (fused rules {mode}): 0 errors, 0 warnings "
            f"({', '.join(f'{a} {n}' for a, n in counts.items())}) in "
            f"{time.perf_counter() - t0:.1f} s")


def check_launch_attrs(card: str) -> dict[str, tuple[int, int, int, int]]:
    """(b) Every instantiation's shared memory, registers and blocks per SM
    as the library reports them (``hsz_func_attrs``), against its spec and
    the card's opt-in limit per block, and against the ``hsz_*_info``
    launchers where they cover it.  Returns the readings by name."""
    optin = specs.smem_optin()
    say(f"shared memory per block with the opt-in: {optin} B ({card})")
    got = {}
    for s in specs.KERNEL_SPECS:
        static, dynamic, regs, per_sm = specs.func_attrs(s.name)
        want = specs.smem_bytes(s)
        if (static, dynamic) != want:
            fail(f"{s.name}: the library reports {static} + {dynamic} B of "
                 f"shared memory, the spec {want[0]} + {want[1]}")
        if static > specs.STATIC_SMEM_LIMIT or static + dynamic > optin:
            fail(f"{s.name}: {static} + {dynamic} B over the card's limits")
        if per_sm < 1:
            fail(f"{s.name}: no block fits an SM")
        got[s.name] = (static, dynamic, regs, per_sm)
        say(f"  {s.name}: {static} B static + {dynamic} B dynamic shared "
            f"memory, {regs} registers, {per_sm} blocks/SM ({card})")
    info = {}
    for payload in (False, True):
        flag = str(payload).lower()
        info[f"lorenzo_edges_kernel<{flag}>"] = fused.lorenzo_launch_config(
            payload, None)
        for what in fused.LORENZO_WHATS:
            name = f"lorenzo_stencil_kernel<{flag}, {what.upper()}, INT32>"
            info[name] = fused.lorenzo_launch_config(payload, what)
        for what in fused.BLOCKMEAN_WHATS:
            name = f"blockmean_kernel<{flag}, {what.upper()}>"
            smem, per_sm = fused.blockmean_launch_config(payload, what)
            info[name] = (smem, got[name][2], per_sm)
        info[f"unpack_kernel<{flag}>"] = bitpack.unpack_config(payload)
    info["prefix_stats_tile_kernel<false>"] = prefix_stats.stats_launch_config()
    for name, (smem, regs, per_sm) in info.items():
        static, dynamic, r, p = got[name]
        if (smem, regs, per_sm) != (static + dynamic, r, p):
            fail(f"{name}: hsz_*_info reads {(smem, regs, per_sm)}, "
                 f"hsz_func_attrs {(static + dynamic, r, p)}")
    say(f"launch attributes: {len(got)} instantiations == their specs, "
        f"within {specs.STATIC_SMEM_LIMIT} B static and {optin} B in all; "
        f"the hsz_*_info launchers agree on {len(info)}")
    return got


#: sentinel coverage: guard words on each side of an output window, and
#: the two fills of a window (a cell no launch writes keeps its fill)
GUARD = 64
SENTINELS = (0x5EA7BEEF, ~0x5EA7BEEF)
#: edge shapes: one past every tiling limit (32-row and 128-column tiles,
#: 4224 columns of narrow corner sums)
COVER_ROWS = (1, 31, 32, 33)
COVER_COLS = (1, 127, 128, 129, 4224, 4225)
#: past MAX_GRID_Y = 65535 rows (the grid-stride loop over blockIdx.y):
#: quant_lorenzo2d's rows, then grad2d's interior rows
COVER_TALL = ((65537, 3), (65539, 4))
#: unpack / pack: SPAN * k +- 1 values at these widths
COVER_SPANS = (1, 2, 7)
COVER_WIDTHS = (1, 7, 16, 17, 31)
#: batched launches: fields, (plane, width) and (plane, block, width)
#: whose payload rows are not 16-byte multiples
COVER_BATCH = 3
COVER_BATCH_LZ = (((31, 127), 7), ((33, 4225), 17), ((65, 300), 13))
COVER_BATCH_BM = (((44, 126), (4, 6), 13), ((33, 129), (1, 1), 7))
#: the batched grad2d's planes: the smallest, one past a 256-column grid
#: block, and past MAX_GRID_Y interior rows
COVER_BATCH_GRAD = ((3, 3), (33, 259), (65539, 4))


#: the f32 epilogue's instantiations as the wrappers name them (what, mode)
LZ_F32 = tuple((w.lower(), m.lower()) for w, m in specs.MODES_LZ
               if m != "INT32")


class Guarded:
    """One launch twice through ``build.call``, its outputs in windows of
    guarded buffers filled with a sentinel (one sentinel per launch).  Fails
    unless every guard word is untouched, no cell of a window keeps its
    sentinel in both launches, and the two launches agree bitwise.  A
    window that the launch accumulates onto starts from given values
    (``prior``) in both launches instead: its caller's comparison with the
    plain version finds a cell written twice, and one written never where
    its value moves; with ``changes``, every cell of such a window must
    differ from its prior in both launches (a prior that every write
    changes finds each cell written never)."""

    def __init__(self, covered: set):
        self.covered = covered

    def __call__(self, names, outputs: dict, launch, written=None,
                 prior=None, changes=False) -> dict:
        """``outputs``: name -> (shape, dtype); ``launch(ptrs)`` calls the
        launcher with ``ptrs[name]``; ``written`` optionally limits a
        window's checked cells (name -> count of leading elements);
        ``prior`` (name -> tensor of the output's shape) the windows'
        values before the launch."""
        prior = prior or {}
        runs = []
        for fill in SENTINELS:
            bufs, ptrs = {}, {}
            for name, (shape, dtype) in outputs.items():
                words = int(np.prod(shape)) * (8 if dtype == torch.float64 else 4) // 4
                buf = torch.full((2 * GUARD + words,), fill, dtype=torch.int32,
                                 device=DEVICE)
                if name in prior:
                    buf[GUARD:GUARD + words] = prior[name].reshape(-1).view(
                        torch.int32)
                bufs[name] = buf
                ptrs[name] = buf[GUARD:].data_ptr()
            launch(ptrs)
            torch.cuda.synchronize()
            runs.append(bufs)
        out = {}
        for name, (shape, dtype) in outputs.items():
            a, b = runs[0][name], runs[1][name]
            for buf, fill in ((a, SENTINELS[0]), (b, SENTINELS[1])):
                if bool((buf[:GUARD] != fill).any()) or bool(
                        (buf[-GUARD:] != fill).any()):
                    fail(f"{'/'.join(names)} {name}: a guard word changed")
            wa, wb = a[GUARD:-GUARD], b[GUARD:-GUARD]
            per = 2 if dtype == torch.float64 else 1
            n = (written or {}).get(name, wa.numel() // per) * per
            left = (wa[:n] == SENTINELS[0]) & (wb[:n] == SENTINELS[1])
            if name in prior and changes:
                was = prior[name].reshape(-1).view(torch.int32)[:n]
                left = (wa[:n] == was) | (wb[:n] == was)
            if (name not in prior or changes) and bool(left.any()):
                fail(f"{'/'.join(names)} {name}: {int(left.sum())} cells no "
                     "launch wrote")
            if n < wa.numel() and (bool((wa[n:] != SENTINELS[0]).any())
                                   or bool((wb[n:] != SENTINELS[1]).any())):
                fail(f"{'/'.join(names)} {name}: written past its window")
            if not torch.equal(wa[:n], wb[:n]):
                fail(f"{'/'.join(names)} {name}: two launches differ")
            out[name] = wa.view(dtype).reshape(shape)
        self.covered.update(names)
        return out


def _payload_of(p: torch.Tensor, bits: int) -> torch.Tensor:
    """The residual plane ``p`` zigzagged and packed at ``bits`` (plain);
    a batch of planes gives one payload row per plane."""
    if p.ndim == 3:
        return torch.stack([_payload_of(x, bits) for x in p])
    return bitpack.pack_plain(encode.zigzag(p.reshape(-1)), bits)


def _residuals(shape, bits: int, rng) -> torch.Tensor:
    """Residuals whose zigzag values fit ``bits``."""
    u = rng.integers(0, 1 << bits, shape, dtype=np.int64).astype(np.int32)
    return encode.unzigzag(torch.as_tensor(u, device=DEVICE))


def cover_lorenzo(shape, bits: int, batch: int = 1, *, g: Guarded,
                  rng) -> None:
    """The Lorenzo edge pass, scans and stencils, both sources and every
    ``what`` (over ``batch`` planes in one launch: the batch's windows and
    plain versions carry the leading axis), and the stats pass with its
    corner scan over the batch, against the plain versions bitwise (the
    stats: each field's exact sums rounded once, bitwise)."""
    n0, n1 = shape
    lead = (batch,) if batch > 1 else ()
    tile = fused.lorenzo_tile()
    n_rt, n_ct = -(-n0 // tile[0]), -(-n1 // tile[1])
    s = ops.stream_ptr()
    for payload in (False, True):
        flag = str(payload).lower()
        p = _residuals(lead + shape, bits, rng) if payload else torch.as_tensor(
            rng.integers(-2 ** 31, 2 ** 31, lead + shape, dtype=np.int64)
            .astype(np.int32), device=DEVICE)
        src = _payload_of(p, bits) if payload else p
        nw = src.shape[-1] if payload else 0
        b = bits if payload else 0
        edges = g((f"lorenzo_edges_kernel<{flag}>", "lorenzo_scan_kernel"),
                  {"rowedge": (lead + (n0, n_ct), torch.int32),
                   "coledge": (lead + (n_rt, n1), torch.int32)},
                  lambda ptr: build.call(
                      "hsz_lorenzo_edges", int(payload), src.data_ptr(), nw, b,
                      n0, n1, batch, ptr["rowedge"], ptr["coledge"], None, s))
        bitwise_err(fused.lorenzo_edge_prefixes_plain(p, tile),
                    (edges["rowedge"], edges["coledge"]),
                    f"lorenzo edges {flag} {batch} x {shape}")
        for what in fused.LORENZO_WHATS:
            outs = {"out0": (lead + shape, torch.int32)}
            if what == "grad":
                outs["out1"] = (lead + shape, torch.int32)
            got = g((f"lorenzo_stencil_kernel<{flag}, {what.upper()}, INT32>",),
                    outs, lambda ptr, w=what: build.call(
                        "hsz_lorenzo_stencil", int(payload), src.data_ptr(), nw,
                        b, n0, n1, batch, edges["rowedge"].data_ptr(),
                        edges["coledge"].data_ptr(), fused._LZ_CODE[w], 0,
                        None, ptr["out0"], ptr.get("out1"), s))
            bitwise_err(fused.lorenzo_core(p, what),
                        tuple(got[k] for k in sorted(got)),
                        f"lorenzo stencil {flag} {what} {batch} x {shape}")
        # the f32 epilogue: each field's own eps; add and sub onto random
        # values, then onto -0.0 with eps of the sign that makes every write
        # change it (d = 0: -0.0 + +0.0 = +0.0, -0.0 - -0.0 = +0.0), so that
        # a cell the launch never wrote keeps -0.0
        eps = torch.as_tensor(rng.uniform(1e-3, 2.0, batch).astype(np.float32),
                              device=DEVICE)
        for what, mode in LZ_F32:
            outs = {"out0": (lead + shape, torch.float32)}
            if what == "grad":
                outs["out1"] = (lead + shape, torch.float32)
            priors = [(None, eps, False)] if mode == "write" else [
                (torch.as_tensor(rng.standard_normal(lead + shape)
                                 .astype(np.float32) * 100.0, device=DEVICE),
                 eps, False),
                (torch.full(lead + shape, -0.0, device=DEVICE),
                 eps if mode == "add" else -eps, True)]
            for before, e, changes in priors:
                got = g((f"lorenzo_stencil_kernel<{flag}, {what.upper()}, "
                         f"{mode.upper()}>",), outs,
                        lambda ptr, w=what, m=mode, e=e: build.call(
                            "hsz_lorenzo_stencil", int(payload), src.data_ptr(),
                            nw, b, n0, n1, batch, edges["rowedge"].data_ptr(),
                            edges["coledge"].data_ptr(), fused._LZ_CODE[w],
                            fused._MODE_CODE[m], e.data_ptr(), ptr["out0"],
                            ptr.get("out1"), s),
                        prior=None if before is None else {"out0": before},
                        changes=changes)
                want = fused.lorenzo_scale_plain(
                    fused.lorenzo_core(p, what), e if lead else e[0], mode,
                    None if before is None else before.clone())
                bitwise_err(want, tuple(got[k] for k in sorted(got)),
                            f"lorenzo stencil f32 {flag} {what} {mode} {batch} "
                            f"x {shape}")
    p = bounded_batch(shape, batch, rng).reshape(lead + shape)
    cols = prefix_stats.corner_cols()
    n_cb = -(-n1 // cols)
    st = g(("lorenzo_edges_kernel<false>", "corner_scan_kernel"),
           {"rowedge": (lead + (n0, n_ct), torch.int32),
            "coledge": (lead + (n_rt, n1), torch.int32),
            "corners": (lead + (n_rt, n_cb), torch.int32)},
           lambda ptr: build.call(
               "hsz_lorenzo_edges", 0, p.data_ptr(), 0, 0, n0, n1, batch,
               ptr["rowedge"], ptr["coledge"], ptr["corners"], s))
    bitwise_err(prefix_stats.corner_sums_plain(st["coledge"], cols),
                st["corners"], f"corner sums {batch} x {shape}")
    wide = 4 * (n_ct - 1) > 128
    name = f"prefix_stats_tile_kernel<{str(wide).lower()}>"
    per_sm = specs.func_attrs(name)[3]
    grid = min(batch * n_rt * n_ct, RATES["sms"] * max(per_sm, 1))
    # every pair is written: a block's tiles' sums of a field, or zeros
    got = g((name, "prefix_stats_reduce_kernel"),
            {"partials": ((batch, grid, 2), torch.float64),
             "out": (lead + (2,), torch.float32)},
            lambda ptr: build.call(
                "hsz_prefix_stats", p.data_ptr(), n0, n1, batch,
                st["rowedge"].data_ptr(), st["coledge"].data_ptr(),
                st["corners"].data_ptr(), ptr["partials"], batch * grid,
                ptr["out"], s))
    for b, (plane, sums) in enumerate(zip(p.reshape((-1,) + shape),
                                          got["out"].reshape(-1, 2))):
        what = f"prefix_stats2d {batch} x {shape} field {b}"
        stat_err(prefix_stats.prefix_stats2d_plain(plane), tuple(sums), what)
        exact_stats(plane, tuple(sums), what)


def cover_blockmean(shape, block, bits: int, batch: int = 1, *, g: Guarded,
                    rng) -> None:
    """The block-mean kernel, both sources and every ``what`` (over
    ``batch`` planes in one launch)."""
    n0, n1 = shape
    lead = (batch,) if batch > 1 else ()
    meta = torch.as_tensor(rng.integers(-2 ** 20, 2 ** 20, lead + (
        n0 // block[0], n1 // block[1])).astype(np.int32), device=DEVICE)
    for payload in (False, True):
        flag = str(payload).lower()
        p = _residuals(lead + shape, bits, rng)
        src = _payload_of(p, bits) if payload else p
        nw = src.shape[-1] if payload else 0
        for what in fused.BLOCKMEAN_WHATS:
            dtype = torch.float32 if what.startswith("lap") else torch.int32
            outs = {"out0": (lead + shape, dtype)}
            if what == "grad":
                outs["out1"] = (lead + shape, dtype)
            got = g((f"blockmean_kernel<{flag}, {what.upper()}>",), outs,
                    lambda ptr, w=what: build.call(
                        "hsz_blockmean", int(payload), src.data_ptr(), nw,
                        bits if payload else 0, n0, n1, batch,
                        meta.data_ptr(), block[0], block[1],
                        fused._BM_CODE[w], ptr["out0"], ptr.get("out1"),
                        ops.stream_ptr()))
            bitwise_err(fused.blockmean_core(p, meta, block, what),
                        tuple(got[k] for k in sorted(got)),
                        f"blockmean {flag} {what} {batch} x {shape} {block}")


def cover_entry(shape, batch: int = 1, *, g: Guarded, rng) -> None:
    """quant_lorenzo2d, grad2d, laplacian2d and block_stats at ``shape``;
    with ``batch`` > 1 the batched grad2d over that many planes."""
    n0, n1 = shape
    s = ops.stream_ptr()
    if batch > 1:
        q = torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, (batch,) + shape,
                                         dtype=np.int64).astype(np.int32),
                            device=DEVICE)
        inner = (batch, n0 - 2, n1 - 2)
        got = g(("grad2d_kernel",), {"d0": (inner, torch.int32),
                                     "d1": (inner, torch.int32)},
                lambda ptr: build.call("hsz_grad2d", q.data_ptr(), n0, n1,
                                       batch, ptr["d0"], ptr["d1"], s))
        bitwise_err(stencil_dq.grad2d_int_plain(q), (got["d0"], got["d1"]),
                    f"grad2d {batch} x {shape}")
        return
    x = torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                        device=DEVICE)
    eps = torch.tensor(1e-3, device=DEVICE)
    inv = quant_lorenzo._inv(eps, DEVICE)
    got = g(("quant_lorenzo2d_kernel",), {"p": (shape, torch.int32)},
            lambda ptr: build.call("hsz_quant_lorenzo2d", x.data_ptr(), n0, n1,
                                   inv.data_ptr(), ptr["p"], s))
    bitwise_err(quant_lorenzo.quant_lorenzo2d_plain(x, eps), got["p"],
                f"quant_lorenzo2d {shape}")
    q = torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, shape, dtype=np.int64)
                        .astype(np.int32), device=DEVICE)
    got = g(("block_stats_kernel",), {"means": ((n0,), torch.int32),
                                      "maxu": ((n0,), torch.int32)},
            lambda ptr: build.call("hsz_block_stats", q.data_ptr(), n0, n1,
                                   ptr["means"], ptr["maxu"], s))
    bitwise_err(ref.block_stats(q), (got["means"], got["maxu"]),
                f"block_stats {shape}")
    if min(shape) < 3:
        return
    inner = (n0 - 2, n1 - 2)
    got = g(("grad2d_kernel",), {"d0": (inner, torch.int32),
                                 "d1": (inner, torch.int32)},
            lambda ptr: build.call("hsz_grad2d", q.data_ptr(), n0, n1, 1,
                                   ptr["d0"], ptr["d1"], s))
    bitwise_err(stencil_dq.grad2d_int_plain(q), (got["d0"], got["d1"]),
                f"grad2d {shape}")
    got = g(("laplacian2d_kernel",), {"out": (inner, torch.int32)},
            lambda ptr: build.call("hsz_laplacian2d", q.data_ptr(), n0, n1,
                                   ptr["out"], s))
    bitwise_err(stencil_dq.laplacian2d_int_plain(q), got["out"],
                f"laplacian2d {shape}")


def cover_bitpack(n: int, bits: int, batch: int = 1, *, g: Guarded,
                  rng) -> None:
    """pack and both unpack instantiations for ``n`` values at ``bits``;
    with ``batch`` > 1 the decode's unpack over that many payloads."""
    s = ops.stream_ptr()
    n_words = -(-(n * bits) // 32)
    if batch > 1:
        u = torch.as_tensor(rng.integers(0, 1 << bits, (batch, n),
                                         dtype=np.int64).astype(np.int32),
                            device=DEVICE)
        words = torch.stack([bitpack.pack_plain(x, bits) for x in u])
        got = g(("unpack_kernel<true>",), {"out": ((batch, n), torch.int32)},
                lambda ptr: build.call(
                    "hsz_unpack", words.data_ptr(), n_words, ptr["out"], n,
                    bits, 1, batch, s))
        bitwise_err(bitpack.unpack_residuals_plain(words, n, bits),
                    got["out"], f"unpack<True> {batch} x {n} x {bits} bits")
        return
    u = torch.as_tensor(rng.integers(0, 1 << bits, n, dtype=np.int64)
                        .astype(np.int32), device=DEVICE)
    got = g(("pack_kernel",), {"words": ((n_words,), torch.int32)},
            lambda ptr: build.call("hsz_pack", u.data_ptr(), n, ptr["words"],
                                   n_words, bits, s))
    words = bitpack.pack_plain(u, bits)
    bitwise_err(words, got["words"], f"pack {n} x {bits} bits")
    for residuals, plain in ((False, bitpack.unpack_plain),
                             (True, bitpack.unpack_residuals_plain)):
        got = g((f"unpack_kernel<{str(residuals).lower()}>",),
                {"out": ((n,), torch.int32)},
                lambda ptr, r=residuals: build.call(
                    "hsz_unpack", words.data_ptr(), n_words, ptr["out"], n,
                    bits, int(r), 1, s))
        bitwise_err(plain(words, n, bits), got["out"],
                    f"unpack<{residuals}> {n} x {bits} bits")


def cover_lorenzo3d(shape, bits: int, batch: int = 1, padded=None, *,
                    g: Guarded, rng) -> None:
    """The rank-3 Lorenzo derivative's kernels (every axis, axis 2 after its
    edge pass) over ``batch`` fields of seeded payload words (every residual
    the width allows) in one launch, in the ``padded`` layout if given,
    against the plain versions bitwise."""
    padded = tuple(padded or shape)
    lead = (batch,) if batch > 1 else ()
    n_words = -(-math.prod(padded) * bits // 32)
    words = torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, lead + (n_words,),
                                         dtype=np.int64).astype(np.int32),
                            device=DEVICE)
    eps = torch.as_tensor(rng.uniform(1e-4, 1e-2, lead).astype(np.float32),
                          device=DEVICE)
    m = tuple(n - 2 for n in shape)
    sizes = (n_words, bits, padded[1], padded[2], *shape, batch)
    run = specs.CONSTANTS["lorenzo3d.cu"]["RUN"]
    s = ops.stream_ptr()
    ve = g(("lorenzo3d_edges_kernel",),
           {"vedge": (lead + (-(-m[0] // run), shape[1] - 1, m[2]),
                      torch.int32)},
           lambda ptr: build.call("hsz_lorenzo3d_edges", words.data_ptr(),
                                  *sizes, ptr["vedge"], s))["vedge"]
    bitwise_err(fused.lorenzo3d_edges_plain(words, padded, shape, bits), ve,
                f"lorenzo3d edges {batch} x {shape} in {padded} at {bits}")
    for axis in range(3):
        name = ("lorenzo3d_lane_kernel" if axis == 2
                else f"lorenzo3d_plane_kernel<{axis}>")
        got = g((name,), {"out": (lead + m, torch.float32)},
                lambda ptr, a=axis: build.call(
                    "hsz_lorenzo3d_stencil", a, words.data_ptr(), *sizes,
                    eps.data_ptr(), ve.data_ptr() if a == 2 else None,
                    ptr["out"], s))["out"]
        bitwise_err(fused.lorenzo_enc3d_plain(words, padded, shape, bits,
                                              axis, eps), got,
                    f"lorenzo3d axis {axis} {batch} x {shape} in {padded} "
                    f"at {bits}")


#: rank-3 coverage: one past each tiling limit of ``lorenzo3d.cu`` (runs
#: of 64 rows, 8 slabs a block, 16 rows a warp, 32- and 384-column chunks),
#: its widest interiors, a padded layout and a batch
COVER_3D = (((3, 3, 3), 1, 1, None), ((67, 19, 387), 7, 1, None),
            ((66, 18, 386), 31, 1, None), ((20, 514, 35), 17, 1, None),
            ((4, 11, 770), 9, 1, None),
            ((20, 27, 33), 9, COVER_BATCH, (24, 32, 40)))


def cover_shapes() -> list[tuple]:
    """Every (family, arguments) case of the coverage check."""
    edge = [(r, c) for r in COVER_ROWS for c in COVER_COLS]
    cases = [("lorenzo", s, 7) for s in edge + [OCEAN]]
    cases += [("lorenzo", (33, 129), b) for b in COVER_WIDTHS]
    cases += [("blockmean", s, (1, 1), 7) for s in edge]
    cases += [("blockmean", (32, 128), (4, 8), b) for b in COVER_WIDTHS]
    cases += [("blockmean", OCEAN, BLOCK, 7)]
    cases += [("entry", s) for s in edge + list(COVER_TALL) + [OCEAN]]
    span = specs.CONSTANTS["unpack.cu"]["SPAN"]
    cases += [("bitpack", span * k + d, b) for k in COVER_SPANS
              for d in (-1, 1) for b in COVER_WIDTHS]
    cases += [("bitpack", OCEAN[0] * OCEAN[1], 7)]
    # batches of COVER_BATCH fields, payload rows of n_words % 4 != 0
    cases += [("lorenzo", s, b, COVER_BATCH) for s, b in COVER_BATCH_LZ]
    cases += [("blockmean", s, blk, b, COVER_BATCH)
              for s, blk, b in COVER_BATCH_BM]
    cases += [("bitpack", span * k + 1, b, COVER_BATCH) for k in (1, 2)
              for b in (7, 17)]
    cases += [("entry", s, COVER_BATCH) for s in COVER_BATCH_GRAD]
    cases += [("lorenzo3d", *c) for c in COVER_3D]
    return cases


def check_coverage(seed: int, cases=None) -> set[str]:
    """(c) Every instantiation through ``build.call`` into guarded windows
    at the edge shapes (``cover_shapes``, or ``cases``); returns the
    instantiations launched.  The full run fails unless that is all of
    them."""
    rng = np.random.default_rng(seed)
    covered: set[str] = set()
    g = Guarded(covered)
    t0 = time.perf_counter()
    full = cases is None
    cases = cover_shapes() if full else cases
    for case in cases:
        kind, *args = case
        {"lorenzo": cover_lorenzo, "blockmean": cover_blockmean,
         "entry": cover_entry, "bitpack": cover_bitpack,
         "lorenzo3d": cover_lorenzo3d}[kind](
             *args, g=g, rng=rng)
    missing = sorted(set(specs.KERNEL_IDS) - covered)
    if full and missing:
        fail(f"coverage: instantiations never launched: {missing}")
    say(f"coverage: {len(covered)} instantiations at {len(cases)} cases "
        f"(rows {COVER_ROWS} x columns {COVER_COLS}, {COVER_TALL}, Ocean, "
        f"unpack spans {COVER_SPANS} x 2048 +- 1 at widths {COVER_WIDTHS}; "
        f"batches of {COVER_BATCH}: {COVER_BATCH_LZ}, {COVER_BATCH_BM}, "
        f"unpack spans 2048 k + 1, grad2d {COVER_BATCH_GRAD}): "
        "every window cell written, no guard word touched, two launches "
        f"bitwise equal and == the plain versions in "
        f"{time.perf_counter() - t0:.1f} s")
    return covered


# ===========================================================================
# host syncs on the query path (phases 5 / 5b's warm queries)
# ===========================================================================

#: a frame of the port's kernel wrappers (``src/repro_torch/kernels/``)
KERNEL_DIR = str(ROOT / "src" / "repro_torch" / "kernels")
PORT_DIR = str(ROOT / "src" / "repro_torch")


def _rule_codes() -> set:
    """The code objects of every ``FusedRule.fn``."""
    return {r.fn.__code__ for table in (rules.DERIVATIVE, rules.GRADIENT,
                                        rules.LAPLACIAN)
            for r in table.values()}


def sync_audit(fields) -> None:
    """The warm full-field cells of phase 5 and region cells of phase 5b
    once more under ``torch.cuda.set_sync_debug_mode("warn")``: every
    distinct host sync by the innermost frame of the port that raised it,
    with its count and the port's frames above it.  Any sync fails: the
    warm query paths read nothing back to the host (the audit's host-sync
    lint says so for the kernel wrappers and ``FusedRule.fn``s, and the
    plan arrays and mean weights come from the device cache)."""
    calls = []
    for scheme in SCHEMES:
        for container, (fu, fv) in fields[scheme].items():
            for op, stage in feasible(scheme):
                calls.append(functools.partial(run_cell, op, stage, fu, fv))
            for name, window in WINDOWS.items():
                for op, stage in region_cells(scheme, name):
                    calls.append(functools.partial(run_cell, op, stage, fu, fv,
                                                   window))
    for fn in calls:    # warm: plans, device caches, programs
        fn()
    torch.cuda.synchronize()
    codes = _rule_codes()
    found: dict[str, dict] = {}

    def show(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" not in str(message):
            return
        frames, f = [], sys._getframe(1)
        while f is not None:
            frames.append(f)
            f = f.f_back
        port = [f for f in frames if f.f_code.co_filename.startswith(PORT_DIR)]
        site = port[0] if port else frames[0]
        path = site.f_code.co_filename.removeprefix(str(ROOT) + "/")
        key = f"{path}:{site.f_lineno} {site.f_code.co_name}"
        entry = found.setdefault(key, {
            "count": 0, "message": str(message).splitlines()[0],
            "chain": " <- ".join(f"{pathlib.Path(f.f_code.co_filename).name}:"
                                 f"{f.f_lineno} {f.f_code.co_name}"
                                 for f in port[:6]),
            "in_wrapper": any(f.f_code.co_filename.startswith(KERNEL_DIR)
                              for f in port),
            "in_rule": any(f.f_code in codes for f in frames)})
        entry["count"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for fn in calls:
                fn()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    say(f"host syncs under set_sync_debug_mode('warn') over {len(calls)} warm "
        f"full-field and region queries: {len(found)} distinct, "
        f"{sum(e['count'] for e in found.values())} in all")
    for key, e in sorted(found.items(), key=lambda kv: -kv[1]["count"]):
        say(f"  sync x{e['count']} at {key}: {e['message']}; frames "
            f"{e['chain']}")
    if found:
        where = ["kernel wrapper" if e["in_wrapper"] else
                 "FusedRule.fn" if e["in_rule"] else "query path"
                 for e in found.values()]
        fail(f"host syncs on the warm query paths ({', '.join(where)}): "
             f"{sorted(found)}")


# ===========================================================================
# phase 8: the science store at scale 1 and LM serving at full width
# ===========================================================================

#: where phase 8's stores keep their ``.hsz`` files (``build/`` is ignored)
STORE_ROOT = ROOT / "build" / "hsz_store"
#: the stores' scale: 1 is Ocean at full size (2400 x 3600)
STORE_SCALE = 1
#: host ms of ``stats`` / ``derivative_features``: each call deserializes
#: the 6.3 MB blob on the host (0.7-0.9 s a call on the card's machine), so
#: 3 calls, not 30, keep phase 8 near its time budget
STORE_REPS = 3
LM_ARCH = "smollm-360m"
#: phase 8c: the ssm, hybrid and audio archs at their published widths, and
#: the depth each runs at (``None``: the full depth); recurrentgemma-9b is
#: cut to one period (rec, rec, attn) of its 38 layers
LM_WIDE = {"falcon-mamba-7b": None, "recurrentgemma-9b": 3,
           "whisper-base": None}
#: launch/serve.py's defaults
LM_SLOTS, LM_MAX_LEN, LM_REQUESTS, LM_PROMPT, LM_NEW = 4, 128, 8, 8, 16
LM_STEP_REPS = 20
#: the reduced archs held against the CPU port at f32 compute: phase 8b's
#: transformer family, then phase 8c's ssm, hybrid and audio families
LM_SMALL = ("qwen3-4b", "granite-moe-3b-a800m", "deepseek-v3-671b",
            "paligemma-3b")
LM_SMALL_8C = ("falcon-mamba-7b", "recurrentgemma-9b", "whisper-base")
#: decode steps of a reduced arch against the CPU port: 24 take the
#: reduced recurrentgemma (window 16) past its ring buffer's wrap
LM_SMALL_STEPS = {"hybrid": 24}
#: f32 compute, card vs CPU: the same arithmetic summed in another order
LM_TOL = dict(rtol=1e-4, atol=1e-4)
#: the reference test's tolerance between a decode and a full forward
LM_LOOSE = dict(rtol=0.1, atol=0.15)
#: the published widths printed per family
FAMILY_WIDTHS = {
    "dense": ("d_model", "n_heads", "n_kv", "head_dim", "d_ff", "vocab"),
    "ssm": ("d_model", "expand", "ssm_state", "d_conv", "vocab"),
    "hybrid": ("d_model", "n_heads", "n_kv", "head_dim", "lru_width", "d_ff",
               "window", "vocab"),
    "audio": ("enc_layers", "d_model", "n_heads", "n_kv", "head_dim", "d_ff",
              "enc_frames", "vocab")}


def science_stores(seed: int, device) -> dict:
    """``ScientificStore`` at scale 1 (Ocean at full size) for both n-D
    schemes over ``STORE_ROOT``: ``hszp_nd`` holds (u, v), ``hszx_nd`` u."""
    return {s: ScientificStore(compressor_name=s, scale=STORE_SCALE,
                               rel_eb=REL_EB, seed=seed,
                               root=str(STORE_ROOT / s), device=device)
            for s in SCHEMES}


def science_path(stores) -> dict:
    """test_system's pipeline and the store's accessors on one device:
    mean@① of the ``hszx_nd`` u, laplacian at ②③④ and divergence at ③④ of
    the ``hszp_nd`` (u, v), then stats / derivative_features / raw."""
    xs, ps = stores["hszx_nd"], stores["hszp_nd"]
    cx = xs.get("Ocean", 0).open()
    cu, cv = ps.get("Ocean", 0).open(), ps.get("Ocean", 1).open()
    out = {"cx": cx, "cu": cu,
           "mean@M": H.mean(cx, Stage.M), "raw x": xs.raw("Ocean", 0),
           "div": {st: H.divergence([cu, cv], st) for st in (Stage.Q, Stage.F)},
           "lap": {st: H.laplacian(cu, st)
                   for st in (Stage.P, Stage.Q, Stage.F)}}
    for s, st in stores.items():
        out[s] = {"stats": st.stats("Ocean", 0), "raw": st.raw("Ocean", 0),
                  "feat": st.derivative_features("Ocean", 0)}
    out["feat v"] = ps.derivative_features("Ocean", 1)
    return out


def check_science(seed: int, tag: str) -> dict:
    """8a: the stores on the card (they synthesize, compress and write the
    ``.hsz`` files), test_system's checks on the card, everything held
    against the CPU port reading the same bytes; host ms per accessor."""
    shutil.rmtree(STORE_ROOT, ignore_errors=True)
    t0 = time.perf_counter()
    card = science_stores(seed, DEVICE)
    for s, st in card.items():
        st.get("Ocean", 0)
    card["hszp_nd"].get("Ocean", 1)
    t_put = time.perf_counter() - t0
    ops.reset_launches()
    got = science_path(card)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    require_launches("science store", launches)
    # test_system's own checks, on the card
    raw = got["raw x"].double()
    eps = float(got["cx"].eps)
    gap = abs(float(got["mean@M"]) - float(raw.mean()))
    if not gap <= 2 * eps:
        fail(f"science store: mean@M off the decompressed mean by {gap} > 2 eps")
    lap_gap = max(float((got["lap"][st] - got["lap"][Stage.F]).abs().max())
                  for st in (Stage.P, Stage.Q))
    div_gap = float((got["div"][Stage.Q] - got["div"][Stage.F]).abs().max())
    if not (lap_gap < 1e-4 and div_gap < 1e-4):
        fail(f"science store: laplacian ②③ vs ④ {lap_gap}, divergence ③ vs "
             f"④ {div_gap} (limit 1e-4)")
    # the CPU port on the same bytes
    host = science_path(science_stores(seed, "cpu"))
    worst = {"stat": 0.0, "vector": 0.0}
    bitwise_err(host["raw x"], got["raw x"].cpu(), "store raw hszx_nd")
    worst["stat"] = close_stat(host["mean@M"], got["mean@M"].cpu(), host["cx"],
                               Stage.M, "mean", "store mean@M")
    for st, val in got["lap"].items():
        bitwise_err(host["lap"][st], val.cpu(), f"store laplacian@{st.name}")
    for st, val in got["div"].items():
        worst["vector"] = max(worst["vector"], close_vector(
            host["div"][st], val.cpu(), f"store divergence@{st.name}"))
    for s in SCHEMES:
        field = host["cx"] if s == "hszx_nd" else host["cu"]
        stage1 = Stage.M if s == "hszx_nd" else Stage.P
        for op, stage in (("mean", stage1), ("std", Stage.P)):
            worst["stat"] = max(worst["stat"], close_stat(
                host[s]["stats"][op], got[s]["stats"][op], field, stage, op,
                f"store {s} stats {op}"))
        bitwise_err(host[s]["raw"], got[s]["raw"].cpu(), f"store {s} raw")
        bitwise_err(host[s]["feat"], to_cpu(got[s]["feat"]),
                    f"store {s} derivative_features")
    bitwise_err(host["feat v"], to_cpu(got["feat v"]),
                "store hszp_nd derivative_features (v)")
    say(f"[{tag}] science store at scale {STORE_SCALE} (Ocean "
        f"{tuple(got['cu'].shape)}, rel_eb {REL_EB}): "
        f"stores written in {t_put:.1f} s; mean@① - decompressed mean "
        f"{gap:.3g} <= 2 eps {2 * eps:.3g}; laplacian ②③ vs ④ {lap_gap:.3g}, "
        f"divergence ③ vs ④ {div_gap:.3g} (< 1e-4); == CPU port on the same "
        f".hsz bytes: laplacian ②③④, gradient@③, raw bitwise, divergence "
        f"{worst['vector']:.3g}, stats {worst['stat']:.3g}")
    for s, st in card.items():   # warm: every accessor ran above
        for name, fn in (("stats", lambda: st.stats("Ocean", 0)),
                         ("derivative_features",
                          lambda: st.derivative_features("Ocean", 0))):
            t = []
            for _ in range(STORE_REPS):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                t.append((time.perf_counter() - t0) * 1e3)
            t.sort()
            say(f"[{tag}] science store {s} {name}: median "
                f"{statistics.median(t):.3f} ms of {STORE_REPS} (min "
                f"{t[0]:.3f}, max {t[-1]:.3f}; host deserialize included)")
    return launches


def _drain(eng, reqs) -> dict:
    for r in reqs:
        eng.add_request(r)
    return {r.uid: r.out_tokens for r in eng.run_until_drained()}


def _lm_requests(vocab: int, seed: int, n=LM_REQUESTS, prompt=LM_PROMPT,
                 new=LM_NEW) -> list:
    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(1, vocab, prompt).astype(np.int32),
                    max_new_tokens=new) for i in range(n)]


def _loose(want, got, what: str, agree_min: float) -> float:
    """The reference test's check between a decode and a full forward:
    top-1 agreement and rtol 0.1 / atol 0.15."""
    agree = float((want.argmax(-1) == got.argmax(-1)).double().mean())
    if agree < agree_min or not torch.allclose(got, want, **LM_LOOSE):
        fail(f"{what}: top-1 agreement {agree}, max |diff| "
             f"{float((got - want).abs().max())}")
    return agree


def cast_trace(module, model, params, toks, cache) -> dict:
    """One warm decode step in a ``torch.profiler`` trace with the model
    module's ``cast_tree`` (``module.cast_tree``) under a
    ``record_function``: the step's device events (kernels, copies, fills)
    and their device µs, the µs of those launched under the layers' weight
    casts (``cast_tree``) and under every ``aten::_to_copy``, and the
    kernels that take most of it."""
    from torch.profiler import record_function
    real = module.cast_tree
    label = "cast_tree"

    def traced(tree, dtype):
        with record_function(label):
            return real(tree, dtype)

    module.cast_tree = traced
    try:
        for _ in range(2):
            model.decode_step(params, toks, cache)
        torch.cuda.synchronize()
        events = profiled(lambda: model.decode_step(params, toks, cache),
                          "a decode step")
    finally:
        module.cast_tree = real
    cuda = torch.autograd.DeviceType.CUDA
    # the annotation's own span on the device timeline is not a kernel
    kernels = [e for e in events if e.device_type == cuda and e.name != label]
    total = sum(e.device_time for e in kernels)
    if not kernels or total <= 0:
        fail("torch.profiler recorded no device time for a decode step")
    under = lambda name: [e for e in events
                          if e.name == name and e.device_type != cuda]
    by_name_ = {}
    for e in kernels:
        short = re.sub(r"^void |\(anonymous namespace\)::|\(.*$|<.*$", "",
                       e.name)[:48]
        n, us = by_name_.get(short, (0, 0.0))
        by_name_[short] = (n + 1, us + e.device_time)
    return {"cast_tree_us": sum(e.device_time_total for e in under(label)),
            "to_copy_us": sum(e.device_time_total
                              for e in under("aten::_to_copy")),
            "n_cast_tree": len(under(label)), "launches": len(kernels),
            "device_us": total,
            "top": sorted(((k, n, us) for k, (n, us) in by_name_.items()),
                          key=lambda t: -t[2])[:6]}


def _widths(cfg) -> str:
    keys = FAMILY_WIDTHS.get(cfg.family, FAMILY_WIDTHS["dense"])
    return ", ".join(f"{k} {getattr(cfg, k)}" for k in keys)


def _conv_to_bf16(cache):
    """``cache`` with every ``conv`` state cast to bf16, as the Mamba and
    Griffin prefills hand it over."""
    if isinstance(cache, dict):
        return {k: v.to(torch.bfloat16) if k == "conv" else _conv_to_bf16(v)
                for k, v in cache.items()}
    if isinstance(cache, list):
        return [_conv_to_bf16(v) for v in cache]
    return cache


def lm_full_width(seed: int, tag: str, arch: str = LM_ARCH,
                  n_layers: int | None = None) -> None:
    """8b / 8c: ``arch`` at its published widths (and depth, or
    ``n_layers``), f32 params from a seeded generator on the card, bf16
    compute: the engine with launch/serve.py's defaults (``kv_quant`` off
    and on where the cache honours it: the transformer's and whisper's
    self K/V; the Mamba and RG-LRU states and the ring buffer ignore it);
    engine == manual greedy decode; f32-compute decode == full forward
    (whisper's cross cache filled from the encoder); prefill -> decode ==
    step-by-step decode (whisper: its prefill returns a fresh cache);
    times, cache bytes per slot and the peak memory."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()    # by earlier phases
    cfg = ARCHS[arch]
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    audio = cfg.family == "audio"
    depth = (f"{cfg.n_layers} layers" if n_layers is None else
             f"{cfg.n_layers} of its {ARCHS[arch].n_layers} layers")
    model = get_model(cfg)
    # the family's model module, whose ``cast_tree`` the step's trace wraps
    module = sys.modules[model.decode_step.func.__module__]
    t0 = time.perf_counter()
    params, _ = model.init(torch.Generator(device=DEVICE).manual_seed(seed),
                           device=DEVICE)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    # decode reads (and casts) every weight but the encoder's
    n_cast = n_params - (sum(t.numel() for t in tree_leaves(params["enc"]))
                         if audio else 0)
    say(f"[{tag}] {arch}: {depth}, {_widths(cfg)}; {n_params:,} f32 params "
        f"({n_params * 4 / 1e9:.3f} GB; param_count {cfg.param_count:,} "
        f"without the norms) initialised on the card in {t_init:.2f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, "
        f"{held / 2 ** 30:.2f} GiB of it held before this arch")
    honours_kv_quant = cfg.family not in ("ssm", "hybrid")
    for kv_quant in ((False, True) if honours_kv_quant else (False,)):
        m = get_model(dataclasses.replace(cfg, kv_quant=kv_quant))
        eng = Engine(m, params, slots=LM_SLOTS, max_len=LM_MAX_LEN,
                     device=DEVICE)
        n_steps = [0]
        real_decode = eng._decode

        def counted_decode(*a, _real=real_decode):
            n_steps[0] += 1
            return _real(*a)

        eng._decode = counted_decode
        reqs = _lm_requests(cfg.vocab, seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = _drain(eng, reqs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if sorted(done) != list(range(LM_REQUESTS)) or any(
                len(t) != LM_NEW or not all(0 <= x < cfg.vocab for x in t)
                for t in done.values()):
            fail(f"{arch} kv_quant={kv_quant}: the engine did not drain "
                 f"{LM_REQUESTS} requests of {LM_NEW} tokens in [0, vocab)")
        cache_bytes = sum(t.nbytes for k, v in eng.cache.items() if k != "pos"
                          for t in tree_leaves(v))
        toks = torch.as_tensor(np.asarray([[r.prompt[0]] for r in reqs[:LM_SLOTS]],
                                          np.int32), device=DEVICE)
        cache = eng.cache
        step = host_ms(lambda: m.decode_step(params, toks, cache), LM_STEP_REPS)
        n_tok = sum(len(t) for t in done.values())
        say(f"[{tag}] {arch} Engine(slots={LM_SLOTS}, max_len={LM_MAX_LEN}) "
            f"kv_quant={kv_quant}: {LM_REQUESTS} requests x {LM_NEW} tokens "
            f"(prompt {LM_PROMPT}) drained, {n_tok} tokens in {dt:.3f} s = "
            f"{n_tok / dt:.1f} tokens/s over {n_steps[0]} decode steps; warm "
            f"decode step of {LM_SLOTS} slots {_spread(step)}, median of "
            f"{LM_STEP_REPS}; cache {cache_bytes // LM_SLOTS:,} bytes per slot")
        if not kv_quant:
            trace = cast_trace(module, m, params, toks, cache)
            cast_bytes = n_cast * 6   # f32 read + bf16 written, once per step
            dev = trace["device_us"]
            say(f"[{tag}] {arch} decode step trace: {trace['launches']} "
                f"device kernels and copies, {dev:.1f} us of device time "
                f"({dev / 1e3 / statistics.median(step):.1%} of the warm "
                f"step's median); the layers' weight casts (cast_tree "
                f"x{trace['n_cast_tree']}) {trace['cast_tree_us']:.1f} us "
                f"({trace['cast_tree_us'] / dev:.1%}), every aten::_to_copy "
                f"{trace['to_copy_us']:.1f} us ({trace['to_copy_us'] / dev:.1%});"
                f" casting every weight moves {cast_bytes / 1e9:.2f} GB, "
                f"{cast_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms at "
                f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; by device time: "
                + ", ".join(f"{k} x{n} {us:.1f} us" for k, n, us in trace["top"]))
        del eng, cache
    # one request: engine == manual greedy decode
    prompt = np.asarray([5, 17, 3], np.int32)
    got = _drain(Engine(model, params, slots=1, max_len=32, device=DEVICE),
                 [Request(uid=0, prompt=prompt, max_new_tokens=5)])[0]
    cache = model.init_cache(1, 32, device=DEVICE)
    for t in prompt:
        logits, cache = model.decode_step(
            params, torch.tensor([[t]], dtype=torch.int32, device=DEVICE), cache)
    manual = []
    for _ in range(5):
        manual.append(int(torch.argmax(logits[0, -1])))
        logits, cache = model.decode_step(
            params, torch.tensor([[manual[-1]]], dtype=torch.int32,
                                 device=DEVICE), cache)
    if got != manual:
        fail(f"{arch}: engine tokens {got} != manual greedy {manual}")
    # f32 compute: 8 teacher-forced decode steps against full_logits, and
    # prefill -> decode against step-by-step decode
    m32 = get_model(dataclasses.replace(cfg, compute_dtype=torch.float32))
    rng = np.random.default_rng(seed)
    toks = torch.as_tensor(rng.integers(1, cfg.vocab, (2, 8)).astype(np.int32),
                           device=DEVICE)
    batch = {"tokens": toks}
    cache = m32.init_cache(2, 8, device=DEVICE)
    if audio:   # seeded normal frames; the cross cache from the encoder
        batch["frames"] = torch.randn(
            (2, cfg.enc_frames, cfg.d_model), device=DEVICE,
            generator=torch.Generator(device=DEVICE).manual_seed(seed))
        enc_out = whisper.encode(m32.cfg, params, batch["frames"])
        if enc_out.shape != batch["frames"].shape or not bool(
                torch.isfinite(enc_out).all()):
            fail(f"{arch}: encoder output {tuple(enc_out.shape)} not finite "
                 f"or not of the frames' shape")
        cache["layers"]["cross"] = whisper.cross_cache(m32.cfg, params, enc_out)
    full = m32.full_logits(params, batch)
    steps = []
    for t in range(8):
        logits, cache = m32.decode_step(params, toks[:, t:t + 1], cache)
        steps.append(logits[:, 0].float())
    dec = torch.stack(steps, dim=1)
    agree = _loose(full, dec, f"{arch} f32 decode vs full_logits", 0.9)
    P = 5
    prefix = dict(batch, tokens=toks[:, :P])
    plog, pcache = m32.prefill(params, prefix, 8)
    if audio:   # the reference's prefill: last logits, then a fresh cache
        _loose(full[:, P - 1:P], plog.float(),
               f"{arch} prefill logits vs full_logits", 1.0)
        fresh = m32.init_cache(2, 8, device=DEVICE)
        if int(pcache["pos"]) != 0 or not all(
                torch.equal(a, b) for a, b in zip(tree_leaves(pcache),
                                                  tree_leaves(fresh))):
            fail(f"{arch}: prefill returned a cache that init_cache does not")
        cont = "prefill returns a fresh cache (the reference's)"
    else:
        # prefill hands the conv state over in bf16 (the reference's
        # prefill casts it), so the step-by-step path rounds its own conv
        # state the same way at P before the two continue side by side
        scache = m32.init_cache(2, 8, device=DEVICE)
        for t in range(P):
            _, scache = m32.decode_step(params, toks[:, t:t + 1], scache)
        scache = _conv_to_bf16(scache)
        for t in range(P, 8):
            plog, pcache = m32.decode_step(params, toks[:, t:t + 1], pcache)
            slog, scache = m32.decode_step(params, toks[:, t:t + 1], scache)
        _loose(slog[:, -1].float(), plog[:, -1].float(),
               f"{arch} prefill -> decode vs step-by-step decode", 1.0)
        cont = (f"prefill({P}) -> decode == step-by-step decode, max |diff| "
                f"{float((plog - slog).abs().max()):.3g}")
        if not torch.equal(slog, logits):   # a conv state: rounded at P
            cont += (f" (with the conv state rounded to bf16 at {P} as "
                     f"prefill hands it over; unrounded "
                     f"{float((plog - logits).abs().max()):.3g})")
    peak = torch.cuda.max_memory_allocated()
    say(f"[{tag}] {arch}: engine == manual greedy decode ({got}); f32 "
        f"compute: 8 teacher-forced decode steps vs full_logits top-1 "
        f"{agree:.3f}, max |diff| {float((dec - full).abs().max()):.3g} "
        f"(rtol 0.1 / atol 0.15); {cont}; peak memory "
        f"{peak / 2 ** 30:.2f} GiB (torch.cuda.max_memory_allocated), "
        f"{(peak - held) / 2 ** 30:.2f} GiB above what earlier phases hold")


def lm_small_vs_cpu(seed: int, tag: str, names=LM_SMALL) -> None:
    """8b / 8c: the reduced archs on the card against the CPU port, same
    params (made on the CPU and moved), f32 compute: logits within
    ``LM_TOL`` over ``full_logits`` and teacher-forced decode steps
    (whisper's cross cache filled from each side's encoder), greedy engine
    tokens equal."""
    for name in names:
        cfg = dataclasses.replace(reduced(ARCHS[name]),
                                  compute_dtype=torch.float32)
        m = get_model(cfg)
        host, _ = m.init(torch.Generator().manual_seed(seed), device="cpu")
        card = tree_map(lambda t: t.to(DEVICE), host)
        n = LM_SMALL_STEPS.get(cfg.family, 8)
        rng = np.random.default_rng(seed)
        batch = {"tokens": rng.integers(0, cfg.vocab, (2, n)).astype(np.int32)}
        if cfg.prefix_tokens:
            batch["prefix_embeds"] = rng.normal(
                size=(2, cfg.prefix_tokens, cfg.d_model)).astype(np.float32)
        if cfg.family == "audio":
            batch["frames"] = rng.normal(
                size=(2, cfg.enc_frames, cfg.d_model)).astype(np.float32)
        hb = {k: torch.as_tensor(v) for k, v in batch.items()}
        cb = {k: v.to(DEVICE) for k, v in hb.items()}
        want, got = m.full_logits(host, hb), m.full_logits(card, cb).cpu()
        if not torch.allclose(got, want, **LM_TOL):
            fail(f"{name}: full_logits card vs CPU max |diff| "
                 f"{float((got - want).abs().max())}")
        gap = float((got - want).abs().max())
        max_len = max(16, n)
        hc, cc = m.init_cache(2, max_len, device="cpu"), m.init_cache(2, max_len, device=DEVICE)
        if cfg.family == "audio":
            for c, p, b in ((hc, host, hb), (cc, card, cb)):
                c["layers"]["cross"] = whisper.cross_cache(
                    cfg, p, whisper.encode(cfg, p, b["frames"]))
        for t in range(n):
            hl, hc = m.decode_step(host, hb["tokens"][:, t:t + 1], hc)
            cl, cc = m.decode_step(card, cb["tokens"][:, t:t + 1], cc)
            if not torch.allclose(cl.cpu(), hl, **LM_TOL):
                fail(f"{name}: decode step {t} card vs CPU max |diff| "
                     f"{float((cl.cpu() - hl).abs().max())}")
            gap = max(gap, float((cl.cpu() - hl).abs().max()))
        want_t = _drain(Engine(m, host, slots=2, max_len=32, device="cpu"),
                        _lm_requests(cfg.vocab, seed, n=3, prompt=5, new=6))
        got_t = _drain(Engine(m, card, slots=2, max_len=32, device=DEVICE),
                       _lm_requests(cfg.vocab, seed, n=3, prompt=5, new=6))
        if got_t != want_t:
            fail(f"{name}: engine tokens on the card {got_t} != CPU {want_t}")
        wrap = (f" (window {cfg.window}: the ring wraps)"
                if cfg.window and n > cfg.window else "")
        say(f"[{tag}] reduced {name} at f32 compute: card == CPU port, "
            f"full_logits and {n} decode steps{wrap} max |diff| {gap:.3g} "
            f"(rtol/atol 1e-4), 3 requests' greedy tokens equal")


# ===========================================================================
# phase 9: training at smollm-360m's full width, the hom step, checkpoints
# and the compressed collectives
# ===========================================================================

TRAIN_ARCH = "smollm-360m"
TRAIN_SEQ, TRAIN_BATCH = 512, 8
#: gspmd steps at full width; the last ``TRAIN_WARM`` of them are timed
TRAIN_STEPS, TRAIN_WARM = 8, 5
TRAIN_OPT = dict(lr=1e-3, warmup_steps=5, total_steps=100)
#: workers of the hom step and of the all-gather, all on the one card
HOM_WORKERS = 4
HOM_STEPS = 2
#: the checkpoint round trips run at smollm-360m's widths cut to 2 layers:
#: the codec is host work whose time scales with bytes, not with the card
CKPT_LAYERS = 2
CKPT_REL_EB = 1e-4
#: where phase 9 writes its checkpoints (``build/`` is ignored)
CKPT_ROOT = ROOT / "build" / "train_ckpt"
GATHER_BITS = (8, 12)
#: f32 compute, card vs CPU (as ``LM_TOL``)
TRAIN_TOL = dict(rtol=1e-4, atol=1e-4)


def _on_card(batch: dict) -> dict:
    return {k: torch.as_tensor(v, device=DEVICE) for k, v in batch.items()}


def _max_ulp(got: torch.Tensor, want: torch.Tensor) -> int:
    """f32 ulps between two tensors of one shape (on the host)."""
    a = got.detach().float().cpu().numpy().view(np.int32).astype(np.int64)
    b = want.detach().float().cpu().numpy().view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


def train_full_width(seed: int, tag: str) -> dict:
    """9a: ``TRAIN_STEPS`` gspmd steps of ``smollm-360m`` at its published
    widths and depth, f32 params from a seeded generator on the card, bf16
    compute, ``remat="full"``, the token pipeline at ``TRAIN_SEQ`` x
    ``TRAIN_BATCH``: losses and grad norms finite, ``lr`` the host's
    schedule; ``microbatch=2`` against the full batch on one batch; ms per
    warm step, tokens/s, peak memory and a profiler trace of one step.
    Returns what 9b and 9d go on with."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    cfg = dataclasses.replace(ARCHS[TRAIN_ARCH], remat="full")
    model = get_model(cfg)
    params, _ = model.init(torch.Generator(device=DEVICE).manual_seed(seed),
                           device=DEVICE)
    n_params = sum(t.numel() for t in tree_leaves(params))
    opt_cfg = train_opt.AdamWConfig(**TRAIN_OPT)
    pipe = TokenPipeline(TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, seed=seed))
    step = train_step.make_train_step(model, opt_cfg)
    state = train_step.init_state(params)
    losses, gnorms, times, lr_ulps = [], [], [], 0
    for s in range(1, TRAIN_STEPS + 1):
        batch = _on_card(next(pipe))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        host_lr = train_opt.schedule(opt_cfg, torch.tensor(s, dtype=torch.int32))
        lr_ulps = max(lr_ulps, _max_ulp(m["lr"], host_lr))
        if lr_ulps > 2:
            fail(f"step {s}: lr {float(m['lr'])} on the card, {float(host_lr)} "
                 f"from the host's schedule")
    if not (np.isfinite(losses).all() and np.isfinite(gnorms).all()):
        fail(f"{TRAIN_ARCH} training: losses {losses}, grad norms {gnorms}")
    if int(state.step) != TRAIN_STEPS:
        fail(f"{TRAIN_ARCH} training: step {int(state.step)} after "
             f"{TRAIN_STEPS} steps")
    peak = torch.cuda.max_memory_allocated()
    warm = sorted(times[-TRAIN_WARM:])
    med = statistics.median(warm)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = 6 * n_params * tokens
    say(f"[{tag}] train {TRAIN_ARCH}: {cfg.n_layers} layers, {_widths(cfg)}; "
        f"{n_params:,} f32 params, bf16 compute, remat {cfg.remat}, batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens, AdamW {TRAIN_OPT}; "
        f"{TRAIN_STEPS} gspmd steps: losses "
        + ", ".join(f"{l:.4f}" for l in losses) + "; grad norms "
        + ", ".join(f"{g:.3f}" for g in gnorms)
        + f"; lr == the host's schedule within {lr_ulps} ulps (2 allowed)")
    say(f"[{tag}] train {TRAIN_ARCH}: first step {times[0]:.1f} ms, warm "
        f"step {med:.1f} ms (median of the last {TRAIN_WARM}: "
        + ", ".join(f"{t:.1f}" for t in warm)
        + f"), {tokens / med * 1e3:.0f} tokens/s; 6·N·T = {flops / 1e12:.2f} "
        f"TFLOP a step, {flops / med / 1e9:.1f} TFLOP/s; peak memory "
        f"{peak / 2 ** 30:.2f} GiB ({(peak - held) / 2 ** 30:.2f} GiB above "
        f"what earlier phases hold)")
    # microbatch=2 against the full batch on one batch (the reference
    # test's tolerances)
    batch = _on_card(next(pipe))
    _, m_full = train_step.make_train_step(model, opt_cfg)(state, batch)
    _, m_micro = train_step.make_train_step(model, opt_cfg, microbatch=2)(
        state, batch)
    l_full, l_micro = float(m_full["loss"]), float(m_micro["loss"])
    g_full, g_micro = float(m_full["grad_norm"]), float(m_micro["grad_norm"])
    if not (abs(l_micro - l_full) <= 1e-5 * abs(l_full)
            and abs(g_micro - g_full) <= 1e-3 * abs(g_full)):
        fail(f"microbatch=2 vs the full batch: loss {l_micro} vs {l_full}, "
             f"grad norm {g_micro} vs {g_full}")
    say(f"[{tag}] train {TRAIN_ARCH}: microbatch=2 vs the full batch: loss "
        f"{l_micro:.6f} vs {l_full:.6f} (rel {abs(l_micro - l_full) / l_full:.2e},"
        f" rtol 1e-5), grad norm {g_micro:.5f} vs {g_full:.5f} (rel "
        f"{abs(g_micro - g_full) / g_full:.2e}, rtol 1e-3)")
    del m_full, m_micro
    kernels, busy, span = trace_window(lambda: step(state, batch), "train.step")
    dev_us = sum(e.device_time for e in kernels)
    say(f"[{tag}] train {TRAIN_ARCH} step trace: {dev_us / 1e3:.1f} ms of "
        f"device time over {len(kernels)} device events "
        f"({dev_us / 1e3 / med:.1%} of the warm step's median {med:.1f} ms); "
        f"under the profiler the step's window is {span / 1e3:.1f} ms; "
        + trace_lines(kernels, busy, span, top_n=8))
    return {"model": model, "opt_cfg": opt_cfg, "state": state, "pipe": pipe}


def hom_full_width(trained: dict, tag: str) -> None:
    """9b: the same model in ``hom`` mode over ``HOM_WORKERS`` workers on the
    card.  The pieces on one batch at zero residuals: every leaf's
    compressed mean within the per-worker eps bound of ``tests/test_comm.py``
    of the exact mean of the workers' gradients, residuals finite, the
    largest |Σq| at most ``worst_case_psum`` and the int16 sum equal to the
    int32 one; then ``HOM_STEPS`` hom steps, losses and every worker's
    residual finite."""
    model, opt_cfg = trained["model"], trained["opt_cfg"]
    params, pipe = trained["state"].params, trained["pipe"]
    mesh = make_host_mesh(devices=[DEVICE] * HOM_WORKERS)
    batch = _on_card(next(pipe))
    grads = [train_step.value_and_grad(model.loss_fn, params, b)[1]
             for b in train_step.split_batch(batch, HOM_WORKERS)]
    mean, res = hom.compressed_psum_tree(grads, None, mesh, HOM_WORKERS)
    bits = hom.bit_budget(HOM_WORKERS)
    qmax = float(2 ** (bits - 1) - 1)
    per_leaf = [tree_leaves(g) for g in grads]
    worst, ratio = 0, 0.0
    for i, got in enumerate(tree_leaves(mean)):
        vs = [leaves[i].float() for leaves in per_leaf]
        exact = sum(v.double() for v in vs) / HOM_WORKERS
        bound = max(float(v.abs().max()) for v in vs) / qmax
        err = float((got.double() - exact).abs().max())
        if err > bound:
            fail(f"hom compressed mean of leaf {i}: |mean - exact| {err} > "
                 f"the per-worker eps bound {bound}")
        ratio = max(ratio, err / bound if bound else 0.0)
        delta = hom._shared_delta(vs, qmax)
        qs = [hom._quantize(v, delta, qmax, torch.int16) for v in vs]
        q16, q32 = qs[0], qs[0].int()
        for q in qs[1:]:
            q16, q32 = q16 + q, q32 + q.int()
        if not torch.equal(q16.int(), q32):
            fail(f"hom leaf {i}: the int16 sum wrapped")
        worst = max(worst, int(q32.abs().max()))
    if worst > hom.worst_case_psum(HOM_WORKERS):
        fail(f"hom: largest |qsum| {worst} > worst_case_psum "
             f"{hom.worst_case_psum(HOM_WORKERS)}")
    if not all(bool(torch.isfinite(t).all()) for r in res for t in tree_leaves(r)):
        fail("hom: a residual is not finite")
    del grads, mean, res, per_leaf
    gc.collect()
    state = train_step.init_state(params, hom_mode=True, mesh=mesh)
    step = train_step.make_train_step(model, opt_cfg, mode="hom", mesh=mesh)
    losses, times = [], []
    for _ in range(HOM_STEPS):
        batch = _on_card(next(pipe))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    if not np.isfinite(losses).all() or len(state.ef_residual) != HOM_WORKERS:
        fail(f"hom steps: losses {losses}")
    r_max = max(float(t.abs().max()) for r in state.ef_residual
                for t in tree_leaves(r))
    if not np.isfinite(r_max):
        fail("hom steps: a residual is not finite")
    say(f"[{tag}] train {TRAIN_ARCH} hom over {HOM_WORKERS} workers on "
        f"{DEVICE} (int16 wire, {bits} bits a worker): every leaf's "
        f"compressed mean within the per-worker eps bound of the exact mean "
        f"(worst {ratio:.3f} of it), largest |qsum| {worst} <= "
        f"worst_case_psum {hom.worst_case_psum(HOM_WORKERS)}, int16 sums "
        f"exact; {HOM_STEPS} hom steps: losses "
        + ", ".join(f"{l:.4f}" for l in losses) + ", ms "
        + ", ".join(f"{t:.1f}" for t in times)
        + f"; residuals finite on every worker (max |r| {r_max:.3g})")
    del state
    gc.collect()


def checkpoints(seed: int, tag: str) -> None:
    """9c: at smollm-360m's widths cut to ``CKPT_LAYERS`` layers: a lossless
    save of the whole ``TrainState`` and the pipeline, restore (bitwise),
    then 2 steps against 2 uninterrupted ones (losses rtol 1e-6, under
    ``torch.use_deterministic_algorithms``); an HSZ save of the params at
    ``CKPT_REL_EB``, restore with the integrity check, every leaf within
    ``rel_eb·range·1.01``; MB/s of each save and restore and the codec."""
    cfg = dataclasses.replace(ARCHS[TRAIN_ARCH], n_layers=CKPT_LAYERS,
                              remat="full")
    model = get_model(cfg)
    gen = torch.Generator(device=DEVICE)
    params, _ = model.init(gen.manual_seed(seed), device=DEVICE)
    opt_cfg = train_opt.AdamWConfig(**TRAIN_OPT)
    pipe_cfg = TokenPipelineConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                   global_batch=TRAIN_BATCH, seed=seed)
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    # the resume check compares losses at rtol 1e-6: deterministic kernels
    # where torch has them (cuBLAS asks for this workspace setting)
    workspace = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        step = train_step.make_train_step(model, opt_cfg)
        pipe = TokenPipeline(pipe_cfg)
        state, _ = step(train_step.init_state(params), _on_card(next(pipe)))
        tree = state._asdict() | {"data": pipe.state_dict()}
        raw = sum(t.numel() * t.element_size() for t in tree_leaves(tree)
                  if isinstance(t, torch.Tensor))
        d = str(CKPT_ROOT / "lossless")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_ckpt.save(d, 1, tree, mode="lossless")
        t_save = time.perf_counter() - t0
        pipe_a = TokenPipeline(pipe_cfg, start_step=pipe.step)
        cont, state_a = [], state
        for _ in range(2):
            state_a, m = step(state_a, _on_card(next(pipe_a)))
            cont.append(float(m["loss"]))
        del state_a
        # a fresh process's state: other weights, zero moments
        fresh, _ = model.init(gen.manual_seed(seed + 1), device=DEVICE)
        pipe_b = TokenPipeline(pipe_cfg)
        target = train_step.init_state(fresh)._asdict() | {
            "data": pipe_b.state_dict()}
        t0 = time.perf_counter()
        restored = train_ckpt.restore(d, 1, target, device=DEVICE)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        pipe_b.load_state_dict(restored.pop("data"))
        state_b = train_step.TrainState(**restored)
        for a, b in zip(tree_flatten_with_paths(state_b)[1],
                        tree_flatten_with_paths(state)[1]):
            if not torch.equal(a, b):
                fail("lossless checkpoint: a restored leaf differs")
        resumed = []
        for _ in range(2):
            state_b, m = step(state_b, _on_card(next(pipe_b)))
            resumed.append(float(m["loss"]))
        if not np.allclose(resumed, cont, rtol=1e-6, atol=0):
            fail(f"resumed losses {resumed} != uninterrupted {cont}")
        del state_b, restored, target, fresh
    finally:
        torch.use_deterministic_algorithms(False)
        if workspace is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = workspace
    lossless = json.loads(pathlib.Path(d, "step_00000001",
                                       "manifest.json").read_text())
    codec = lossless["leaves"][0]["codec"]
    stored = sum(f.stat().st_size for f in pathlib.Path(d).rglob("*.bin"))
    # HSZ: the params, verified on restore by the manifest's stage-② mean
    h = str(CKPT_ROOT / "hsz")
    ptree = {"params": state.params}
    p_raw = sum(t.numel() * 4 for t in tree_leaves(state.params))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_ckpt.save(h, 1, ptree, mode="hsz", rel_eb=CKPT_REL_EB)
    t_hsave = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = train_ckpt.restore(h, 1, ptree, device=DEVICE)
    torch.cuda.synchronize()
    t_hrestore = time.perf_counter() - t0
    worst = 0.0
    for a, b in zip(tree_leaves(state.params), tree_leaves(back["params"])):
        rng = float(a.max() - a.min())
        if a.numel() >= 1024:
            err = float((a - b).abs().max())
            if err > max(CKPT_REL_EB * rng, 1e-7) * 1.01:
                fail(f"HSZ checkpoint: |error| {err} > rel_eb·range")
            worst = max(worst, err / max(CKPT_REL_EB * rng, 1e-7))
        elif not torch.equal(a, b):
            fail("HSZ checkpoint: a small leaf is not lossless")
    h_stored = sum(f.stat().st_size for f in pathlib.Path(h).rglob("*.bin"))
    n_hsz = sum(e["codec"] == "hsz" for e in json.loads(pathlib.Path(
        h, "step_00000001", "manifest.json").read_text())["leaves"])
    say(f"[{tag}] checkpoints of {TRAIN_ARCH} at {CKPT_LAYERS} of its "
        f"{ARCHS[TRAIN_ARCH].n_layers} layers: lossless ({codec}) TrainState "
        f"+ pipeline {raw / 1e6:.1f} MB -> {stored / 1e6:.1f} MB, save "
        f"{t_save:.2f} s ({raw / 1e6 / t_save:.1f} MB/s), restore "
        f"{t_restore:.2f} s ({raw / 1e6 / t_restore:.1f} MB/s), bitwise; 2 "
        f"steps after the restore == 2 uninterrupted: losses "
        + ", ".join(f"{l:.6f}" for l in resumed)
        + f" (rtol 1e-6); HSZ params rel_eb {CKPT_REL_EB}: {p_raw / 1e6:.1f} "
        f"MB -> {h_stored / 1e6:.1f} MB ({p_raw / h_stored:.2f}x, {n_hsz} "
        f"hszp leaves), save {t_hsave:.2f} s ({p_raw / 1e6 / t_hsave:.1f} "
        f"MB/s), restore with the integrity check {t_hrestore:.2f} s "
        f"({p_raw / 1e6 / t_hrestore:.1f} MB/s), worst error {worst:.3f} of "
        f"rel_eb·range")
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)


def collectives_path(trained: dict, tag: str) -> dict:
    """9d: ``packed_allgather`` of the full-width embedding over
    ``HOM_WORKERS`` workers at ``GATHER_BITS`` (worker ``w`` holds the
    embedding times ``(w + 1) / HOM_WORKERS``), launches counted: the words
    bitwise ``pack_plain``'s and their values bitwise ``unpack_plain``'s on
    the card, the gathered values bitwise the CPU port's and within half a
    bin; ``stage1_stats`` of the trained params against float64 numpy.
    Returns the path's launches."""
    params = trained["state"].params
    embed = params["embed"]
    xs = [embed * ((w + 1) / HOM_WORKERS) for w in range(HOM_WORKERS)]
    mesh = make_host_mesh(devices=[DEVICE] * HOM_WORKERS)
    ops.reset_launches()
    out = {bits: hom.packed_allgather(xs, mesh, bits) for bits in GATHER_BITS}
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    require_launches("collectives", launches)
    n = embed.numel()
    cpu_mesh = make_host_mesh(devices=["cpu"] * HOM_WORKERS)
    host_xs = [x.cpu() for x in xs]
    lines = []
    for bits, got in out.items():
        qmax = float(2 ** (bits - 1) - 1)
        delta = hom._shared_delta(xs, qmax)
        for x in xs:
            u = hom.wire_values(x, delta, qmax)
            words = bitpack.pack(u, bits)
            if not torch.equal(words, bitpack.pack_plain(u, bits)):
                fail(f"packed_allgather bits {bits}: pack != pack_plain")
            if not torch.equal(bitpack.unpack(words, u.numel(), bits),
                               bitpack.unpack_plain(words, u.numel(), bits)):
                fail(f"packed_allgather bits {bits}: unpack != unpack_plain")
        want = hom.packed_allgather(host_xs, cpu_mesh, bits)
        if not torch.equal(got.cpu(), want):
            fail(f"packed_allgather bits {bits}: card != CPU port")
        gap = max(float((got[w] - x).abs().max()) for w, x in enumerate(xs))
        if gap > float(delta) * 0.5 * 1.0001:
            fail(f"packed_allgather bits {bits}: |gathered - x| {gap} > "
                 f"half a bin {float(delta) / 2}")
        t = host_ms(lambda b=bits: hom.packed_allgather(xs, mesh, b), 5)
        wire = HOM_WORKERS * (n + (-n) % 32) * bits // 8
        lines.append(f"bits {bits}: {wire / 1e6:.1f} MB of words against "
                     f"{HOM_WORKERS * n * 4 / 1e6:.1f} MB of f32, max |error| "
                     f"{gap:.3g} <= half a bin, {_spread(t)}")
    t0 = time.perf_counter()
    st = hom.stage1_stats(params)
    torch.cuda.synchronize()
    t_stats = (time.perf_counter() - t0) * 1e3
    total = total_sq = count = 0
    for t in tree_leaves(params):
        a = t.detach().cpu().numpy().astype(np.float64)
        total, total_sq, count = total + a.sum(), total_sq + (a * a).sum(), \
            count + a.size
    mean, norm = total / count, np.sqrt(total_sq)
    if not (np.isclose(float(st["mean"]), mean, rtol=1e-4, atol=0)
            and np.isclose(float(st["norm"]), norm, rtol=1e-4, atol=0)):
        fail(f"stage1_stats mean {float(st['mean'])} / norm "
             f"{float(st['norm'])} vs float64 {mean} / {norm}")
    say(f"[{tag}] collectives: packed_allgather of the {TRAIN_ARCH} embedding "
        f"{tuple(embed.shape)} over {HOM_WORKERS} workers on {DEVICE}, words "
        f"== pack_plain's and values == unpack_plain's on the card, gathered "
        f"== the CPU port's bitwise; " + "; ".join(lines)
        + f". stage1_stats of {count:,} params: mean {float(st['mean']):.6g} "
        f"(float64 {mean:.6g}), norm {float(st['norm']):.6g} (float64 "
        f"{norm:.6g}), rtol 1e-4, {t_stats:.1f} ms")
    return launches


def train_small_vs_cpu(seed: int, tag: str) -> None:
    """9e: the ten reduced archs at f32 compute on the card against the CPU
    port with the same params and batch: loss and every gradient leaf
    within ``TRAIN_TOL``, and one gspmd step's new params within it where
    the CPU's gradient is not within the gradient tolerance of 0 (there
    AdamW's ``g / (|g| + eps)`` may take either sign)."""
    opt_cfg = train_opt.AdamWConfig(**TRAIN_OPT)
    gaps = []
    for name in ARCHS:
        cfg = dataclasses.replace(reduced(ARCHS[name]),
                                  compute_dtype=torch.float32)
        m = get_model(cfg)
        host, _ = m.init(torch.Generator().manual_seed(seed), device="cpu")
        card = tree_map(lambda t: t.to(DEVICE), host)
        rng = np.random.default_rng(seed)
        batch = {"tokens": rng.integers(0, cfg.vocab, (2, 8)).astype(np.int32)}
        if cfg.prefix_tokens:
            batch["prefix_embeds"] = rng.normal(
                size=(2, cfg.prefix_tokens, cfg.d_model)).astype(np.float32)
        if cfg.family == "audio":
            batch["frames"] = rng.normal(
                size=(2, cfg.enc_frames, cfg.d_model)).astype(np.float32)
        hb = {k: torch.as_tensor(v) for k, v in batch.items()}
        cb = _on_card(batch)
        hl, hg = train_step.value_and_grad(m.loss_fn, host, hb)
        cl, cg = train_step.value_and_grad(m.loss_fn, card, cb)
        gap = abs(float(cl) - float(hl))
        if not np.isclose(float(cl), float(hl), **TRAIN_TOL):
            fail(f"{name}: loss {float(cl)} on the card, {float(hl)} on the CPU")
        for a, b in zip(tree_leaves(cg), tree_leaves(hg)):
            if not torch.allclose(a.cpu(), b, **TRAIN_TOL):
                fail(f"{name}: a gradient leaf card vs CPU max |diff| "
                     f"{float((a.cpu() - b).abs().max())}")
            gap = max(gap, float((a.cpu() - b).abs().max()))
        step = train_step.make_train_step(m, opt_cfg)
        hs, _ = step(train_step.init_state(host), hb)
        cs, _ = step(train_step.init_state(card), cb)
        moved, flips = 0.0, 0
        for a, b, ga, gb in zip(tree_leaves(cs.params), tree_leaves(hs.params),
                                tree_leaves(cg), tree_leaves(hg)):
            off = ~torch.isclose(a.cpu(), b, **TRAIN_TOL)
            flip = torch.sign(ga.cpu()) != torch.sign(gb)
            if bool((off & ~flip).any()):
                fail(f"{name}: one step's new params card vs CPU max |diff| "
                     f"{float((a.cpu() - b)[off & ~flip].abs().max())}")
            flips += int(off.sum())
            moved = max(moved, float((a.cpu() - b)[~flip].abs().max()))
        gaps.append(f"{name} {gap:.2g}/{moved:.2g}"
                    + (f" ({flips} params whose gradient's sign differs)"
                       if flips else ""))
    say(f"[{tag}] train: the {len(ARCHS)} reduced archs at f32 compute, card "
        f"== CPU port (rtol/atol 1e-4): loss and every gradient leaf, then "
        f"one gspmd step's params; max |diff| grads/params: " + ", ".join(gaps))


# ===========================================================================
# phase 10: the mesh layer, manual expert parallelism and the dry run
# ===========================================================================

#: the expert-parallel meshes: (data, model) peers, all on the one card
EP_MESHES = ((1, 4), (2, 4))
#: the one-layer checks' tokens (batch x seq): each of 4 peers routes 16
#: (8 on the (2, 4) mesh)
EP_TOKENS = (2, 32)
#: a capacity factor at which these inputs drop no token (checked from the
#: routing before it is relied on)
EP_NO_DROP_CF = 8.0
#: deepseek-v3's MoE layer at f32 holds 45.1 GB of expert weights; below
#: this much free memory the layer runs at bf16 instead
EP_F32_FREE = 62 * 2 ** 30
#: EP against the moe path at bf16: the einsums run at other batch shapes,
#: so cuBLAS may sum in another order (about one bf16 ulp of the output)
EP_BF16_TOL = dict(rtol=2e-2, atol=2e-2)
#: the meshed engine: granite-moe-3b-a800m at full width and depth
EP_SERVE_ARCH = "granite-moe-3b-a800m"
EP_PROMPT, EP_NEW = 4, 8
#: the dry run against the card (smollm-360m on a (1, 1) mesh): phase 9a's
#: train shape and a decode shape whose cache fits beside the rest
DRY_CARD_ARCH = "smollm-360m"
DRY_CARD_SHAPES = (ShapeConfig("train_8x512", "train", TRAIN_SEQ, TRAIN_BATCH),
                   ShapeConfig("decode_8x4096", "decode", 4096, 8))
DRY_PEAK_RANGE = (0.5, 2.0)
#: the dry-run sweep: every cell of these archs on both production meshes,
#: in processes of their own (no card) while the card runs phase 10
DRY_ARCHS = ("smollm-360m", "deepseek-v3-671b")
DRY_DIR = ROOT / "build" / "dryrun_smoke"
DRY_WORKERS = 3


def _moe_cfg(arch: str, **kw) -> ffn.FfnCfg:
    return dataclasses.replace(transformer._ffn_cfg(ARCHS[arch], "moe"), **kw)


def _filled_params(fcfg: ffn.FfnCfg, seed: int, device, dtype) -> dict:
    """One MoE layer's params, seeded normals at ``Builder``'s scales,
    drawn in place on ``device`` (no temporary the size of a weight)."""
    g = torch.Generator(device=device).manual_seed(seed)
    b = Builder(None)   # only for the shapes
    shapes = tree_map(lambda t: tuple(t.shape), Builder.split(
        ffn.init_moe(b, fcfg))[0])

    def draw(shape):
        t = torch.empty(shape, dtype=torch.float32, device=device)
        t.normal_(generator=g).mul_(1.0 / (shape[-2] if len(shape) > 1
                                           else shape[-1]) ** 0.5)
        return t.to(dtype)

    return tree_map(draw, shapes, is_leaf=lambda s: isinstance(s, tuple)
                    and all(isinstance(d, int) for d in s))


def ep_drops(expert_idx: np.ndarray, fcfg: ffn.FfnCfg, mesh_shape) -> int:
    """Token-slots manual EP would drop for this routing (stage 1: more
    than ``cap1`` to one peer; stage 2: more than ``cap2`` to one local
    expert), counted from the (T, K) expert choices."""
    dp, tp = mesh_shape
    T, K = expert_idx.shape
    e_loc = -(-fcfg.n_experts // tp)
    ts_ = T // dp // tp
    cf = fcfg.capacity_factor
    cap1 = int(max(1, round(ts_ * K / tp * cf)))
    cap2 = int(max(1, round(tp * cap1 / e_loc * cf)))
    drops = 0
    for d in range(dp):
        recv = np.zeros((tp, e_loc), np.int64)
        for g in range(tp):
            e = expert_idx[(d * tp + g) * ts_:(d * tp + g + 1) * ts_].reshape(-1)
            per_peer = np.bincount(e // e_loc, minlength=tp)
            drops += int(np.maximum(per_peer - cap1, 0).sum())
            if per_peer.max() <= cap1:
                np.add.at(recv, (e // e_loc, e % e_loc), 1)
        drops += int(np.maximum(recv - cap2, 0).sum())
    return drops


def moe_drops(expert_idx: np.ndarray, fcfg: ffn.FfnCfg) -> int:
    """Token-slots ``moe`` drops: more than its capacity C to one expert."""
    T, K = expert_idx.shape
    C = int(max(1, round(T * K / fcfg.n_experts * fcfg.capacity_factor)))
    load = np.bincount(expert_idx.reshape(-1), minlength=fcfg.n_experts)
    return int(np.maximum(load - C, 0).sum())


@contextlib.contextmanager
def active_mesh(shape, device: str):
    """A host mesh of ``shape`` over one device repeated, active."""
    mesh = make_host_mesh(shape, devices=[device] * math.prod(shape))
    mesh_lib.activate(mesh)
    try:
        yield mesh
    finally:
        mesh_lib.deactivate()


def ep_layer(seed: int, tag: str) -> None:
    """10a: one MoE layer at full width over ``EP_MESHES`` on the card:
    granite-moe-3b-a800m at f32 and its configured capacity against the CPU
    port on the same inputs; deepseek-v3-671b against the port's ``moe`` on
    the card with nothing dropped (f32 weights where the card has room)."""
    B, S = EP_TOKENS
    rng = np.random.default_rng(seed)
    # granite-moe: against the CPU port
    fcfg = _moe_cfg("granite-moe-3b-a800m")
    host = _filled_params(fcfg, seed, "cpu", torch.float32)
    card = tree_map(lambda t: t.to(DEVICE), host)
    xh = torch.as_tensor(rng.normal(size=(B, S, fcfg.d_model)).astype(np.float32))
    xc = xh.to(DEVICE)
    idx = ffn.route(card, xc.reshape(-1, fcfg.d_model), fcfg)[1].cpu().numpy()
    for shape in EP_MESHES:
        with active_mesh(shape, DEVICE):
            if not ffn._can_manual_ep(fcfg, xc):
                fail(f"granite-moe layer on {shape}: manual EP not taken")
            exchange.reset_counts()
            yc = ffn.forward(card, xc, fcfg)
            counts = exchange.counts()
            ms = host_ms(lambda: ffn.forward(card, xc, fcfg), 5)
        with active_mesh(shape, "cpu"):
            yh = ffn.forward(host, xh, fcfg)
        err = float((yc.cpu() - yh).abs().max())
        if not torch.allclose(yc.cpu(), yh, **LM_TOL):
            fail(f"granite-moe layer on {shape}: card vs CPU port max |diff| {err}")
        say(f"[{tag}] EP granite-moe-3b-a800m layer (E {fcfg.n_experts}, d "
            f"{fcfg.d_model}, d_ff {fcfg.d_ff}, top-{fcfg.top_k}, capacity "
            f"{fcfg.capacity_factor}) on a {shape[0]}x{shape[1]} mesh on one "
            f"card, {B * S} tokens, f32: card == CPU port (rtol/atol 1e-4), "
            f"max |diff| {err:.3g}; {ep_drops(idx, fcfg, shape)} token-slots "
            f"dropped; exchanges {counts}; {_spread(ms)} a layer")
    del host, card
    gc.collect()
    torch.cuda.empty_cache()
    # deepseek-v3: against the moe path on the card, nothing dropped
    fcfg = _moe_cfg("deepseek-v3-671b", capacity_factor=EP_NO_DROP_CF)
    free = torch.cuda.mem_get_info()[0]
    dtype = torch.float32 if free >= EP_F32_FREE else torch.bfloat16
    tol = LM_TOL if dtype == torch.float32 else EP_BF16_TOL
    torch.cuda.reset_peak_memory_stats()
    p = _filled_params(fcfg, seed, DEVICE, dtype)
    x = torch.as_tensor(rng.normal(size=(B, S, fcfg.d_model)).astype(np.float32),
                        device=DEVICE).to(dtype)
    idx = ffn.route(p, x.reshape(-1, fcfg.d_model), fcfg)[1].cpu().numpy()
    if moe_drops(idx, fcfg):
        fail(f"deepseek-v3 layer: moe drops {moe_drops(idx, fcfg)} token-slots "
             f"at capacity {fcfg.capacity_factor}")
    want = ffn.moe(p, x, fcfg)
    for shape in EP_MESHES:
        if ep_drops(idx, fcfg, shape):
            fail(f"deepseek-v3 layer on {shape}: EP drops "
                 f"{ep_drops(idx, fcfg, shape)} token-slots")
        with active_mesh(shape, DEVICE):
            exchange.reset_counts()
            got = ffn.forward(p, x, fcfg)
            counts = exchange.counts()
            ms = host_ms(lambda: ffn.forward(p, x, fcfg), 3)
        err = float((got.float() - want.float()).abs().max())
        if not torch.allclose(got.float(), want.float(), **tol):
            fail(f"deepseek-v3 layer on {shape}: EP vs moe max |diff| {err}")
        say(f"[{tag}] EP deepseek-v3-671b layer (E {fcfg.n_experts}, d "
            f"{fcfg.d_model}, moe d_ff {fcfg.d_ff}, top-{fcfg.top_k}, sigmoid, "
            f"{fcfg.n_shared} shared) at {str(dtype)[6:]} ({free / 2 ** 30:.1f} "
            f"GiB free before it) on a {shape[0]}x{shape[1]} mesh, {B * S} "
            f"tokens, capacity {fcfg.capacity_factor} (no drops): EP == moe on "
            f"the card (rtol/atol {tol['rtol']}), max |diff| {err:.3g}; "
            f"exchanges {counts}; {_spread(ms)} a layer; peak "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    del p, x, want, got
    gc.collect()
    torch.cuda.empty_cache()


def ep_serve(seed: int, tag: str) -> None:
    """10b: ``EP_SERVE_ARCH`` at full width and depth served by
    ``Engine(slots=4, max_len=128)`` with the (1, 4) mesh active: at f32
    compute and a capacity that drops nothing, the greedy tokens of 8
    drained requests equal the unmeshed engine's; at the config's capacity,
    the tokens that differ are counted; tokens/s and ms per warm step."""
    base = ARCHS[EP_SERVE_ARCH]
    gc.collect()
    torch.cuda.empty_cache()
    out = {}
    for cf in (EP_NO_DROP_CF, base.capacity_factor):
        cfg = dataclasses.replace(base, compute_dtype=torch.float32,
                                  capacity_factor=cf)
        model = get_model(cfg)
        params, _ = model.init(torch.Generator(device=DEVICE).manual_seed(seed),
                               device=DEVICE)
        for meshed in (False, True):
            ctx = (active_mesh((1, 4), DEVICE) if meshed
                   else contextlib.nullcontext())
            with ctx:
                exchange.reset_counts()
                eng = Engine(model, params, slots=LM_SLOTS, max_len=LM_MAX_LEN,
                             device=DEVICE)
                reqs = _lm_requests(cfg.vocab, seed, prompt=EP_PROMPT, new=EP_NEW)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                done = _drain(eng, reqs)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                counts = exchange.counts()
                toks = torch.as_tensor(np.asarray(
                    [[r.prompt[0]] for r in reqs[:LM_SLOTS]], np.int32),
                    device=DEVICE)
                cache = eng.cache
                step = host_ms(lambda: model.decode_step(params, toks, cache), 5)
            if sorted(done) != list(range(LM_REQUESTS)):
                fail(f"{EP_SERVE_ARCH} meshed={meshed}: the engine did not drain")
            if meshed and not counts.get("all-to-all", {}).get("count"):
                fail(f"{EP_SERVE_ARCH}: the meshed engine issued no exchange")
            out[(cf, meshed)] = done
            n_tok = sum(len(t) for t in done.values())
            say(f"[{tag}] EP serve {EP_SERVE_ARCH} ({cfg.n_layers} layers, "
                f"{_widths(cfg)}, {cfg.n_experts} experts top-{cfg.top_k}) "
                f"f32 compute, capacity {cf}, "
                f"{'(1, 4) mesh on one card' if meshed else 'no mesh'}: "
                f"{LM_REQUESTS} requests x {EP_NEW} tokens (prompt {EP_PROMPT}) "
                f"in {dt:.3f} s = {n_tok / dt:.1f} tokens/s; warm decode step "
                f"{_spread(step)}; exchanges {counts.get('all-to-all', {})}")
        del params, model
        gc.collect()
        torch.cuda.empty_cache()
    plain, meshed = out[(EP_NO_DROP_CF, False)], out[(EP_NO_DROP_CF, True)]
    if plain != meshed:
        fail(f"{EP_SERVE_ARCH}: with nothing dropped the meshed engine's greedy "
             f"tokens differ from the unmeshed engine's: {meshed} vs {plain}")
    a, b = out[(base.capacity_factor, False)], out[(base.capacity_factor, True)]
    differ = sum(x != y for u in a for x, y in zip(a[u], b[u]))
    say(f"[{tag}] EP serve {EP_SERVE_ARCH}: capacity {EP_NO_DROP_CF} (nothing "
        f"dropped): meshed == unmeshed greedy tokens, all "
        f"{sum(len(t) for t in plain.values())}; at the config's capacity "
        f"{base.capacity_factor}: {differ} of "
        f"{sum(len(t) for t in a.values())} tokens differ (EP caps each peer "
        f"and local expert, moe each expert)")


def dry_vs_card(seed: int, tag: str) -> None:
    """10c: the dry run of ``DRY_CARD_ARCH`` on a (1, 1) mesh against the
    real step on the card: the predicted peak (arguments + the step's own
    peak) over ``torch.cuda.max_memory_allocated`` of the same step (within
    ``DRY_PEAK_RANGE``), and the dry run's FLOPs over the step's time."""
    one = make_host_mesh((1, 1), devices=["meta"])
    cfg = dataclasses.replace(ARCHS[DRY_CARD_ARCH], remat="full")
    model = get_model(cfg)
    for shape in DRY_CARD_SHAPES:
        rec = dryrun.build_cell(DRY_CARD_ARCH, shape, multi_pod=False,
                                mesh=one, remat="full")
        if rec["status"] != "ok":
            fail(f"dry run {DRY_CARD_ARCH} {shape.name}: {rec.get('error')}")
        predicted = rec["memory"]["peak_per_device_gib"] * 2 ** 30
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        params, _ = model.init(torch.Generator(device=DEVICE).manual_seed(seed),
                               device=DEVICE)
        batch = make_batch(cfg, shape, torch.Generator(device=DEVICE).manual_seed(seed),
                           device=DEVICE)
        if shape.kind == "train":
            step = train_step.make_train_step(model, train_opt.AdamWConfig())
            state = train_step.init_state(params)
            state, _ = step(state, batch)          # warm: the first step
            run = lambda: step(state, batch)
        else:
            cache = model.init_cache(shape.global_batch, shape.seq_len,
                                     device=DEVICE)
            run = lambda: model.decode_step(params, batch["tokens"], cache)
            run()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = run()
        torch.cuda.synchronize()
        real = torch.cuda.max_memory_allocated() - base
        del out
        times = host_ms(run, 3)
        ratio = real / predicted
        flops = rec["hlo"]["dot_flops"]
        med = statistics.median(times)
        say(f"[{tag}] dry run vs card, {DRY_CARD_ARCH} {shape.kind} "
            f"{shape.global_batch} x {shape.seq_len} (remat full) on a (1, 1) "
            f"mesh: predicted peak {predicted / 2 ** 30:.3f} GiB (arguments "
            f"{rec['memory']['argument_bytes'] / 2 ** 30:.3f} + the step's "
            f"{rec['hlo']['peak_live_bytes'] / 2 ** 30:.3f}), the card's "
            f"max_memory_allocated {real / 2 ** 30:.3f} GiB: ratio card / dry "
            f"run {ratio:.3f} (allowed {DRY_PEAK_RANGE[0]}-{DRY_PEAK_RANGE[1]}); "
            f"dry-run dot FLOPs {flops / 1e12:.3f} T over the step's "
            f"{_spread(times)} = {flops / med / 1e9:.2f} TFLOP/s achieved "
            f"({flops / med / 1e9 / 989:.1%} of the 989 TFLOP/s bf16 "
            f"datasheet peak); dry run {rec['compile_s']} s on the host")
        if not DRY_PEAK_RANGE[0] <= ratio <= DRY_PEAK_RANGE[1]:
            fail(f"dry run {DRY_CARD_ARCH} {shape.name}: card / dry-run peak "
                 f"{ratio:.3f} outside {DRY_PEAK_RANGE}")
        del run, params, batch
        if shape.kind == "train":
            del state, step
        else:
            del cache
        gc.collect()
        torch.cuda.empty_cache()


def mesh_steps_vs_cpu(seed: int, tag: str) -> None:
    """10d: two gspmd steps of the reduced MoE archs at f32 compute under a
    (2, 2) mesh (manual EP in every MoE layer), card against the CPU port:
    losses and the gradient leaves within ``TRAIN_TOL``, the params after
    two steps within it where the first step's gradient has the same sign
    (elsewhere AdamW's ``g / (|g| + eps)`` may take either)."""
    opt_cfg = train_opt.AdamWConfig(**TRAIN_OPT)
    for name in ("granite-moe-3b-a800m", "deepseek-v3-671b"):
        cfg = dataclasses.replace(reduced(ARCHS[name]), compute_dtype=torch.float32)
        m = get_model(cfg)
        host, _ = m.init(torch.Generator().manual_seed(seed), device="cpu")
        rng = np.random.default_rng(seed)
        batch = {"tokens": rng.integers(0, cfg.vocab, (4, 8)).astype(np.int32)}
        res = {}
        for where, dev in (("card", DEVICE), ("cpu", "cpu")):
            params = tree_map(lambda t: t.to(dev), host)
            b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
            with active_mesh((2, 2), dev):
                exchange.reset_counts()
                loss, grads = train_step.value_and_grad(m.loss_fn, params, b)
                step = train_step.make_train_step(m, opt_cfg)
                state = train_step.init_state(params)
                losses = []
                for _ in range(2):
                    state, met = step(state, b)
                    losses.append(float(met["loss"]))
                res[where] = (loss, grads, state, losses, exchange.counts())
        (cl, cg, cs, closs, counts), (hl, hg, hs, hloss, _) = res["card"], res["cpu"]
        if not counts.get("all-to-all", {}).get("count"):
            fail(f"{name} on a (2, 2) mesh: no expert-parallel exchange")
        if not np.allclose(closs + [float(cl)], hloss + [float(hl)], **TRAIN_TOL):
            fail(f"{name} (2, 2) mesh: losses {closs} on the card, {hloss} on "
                 f"the CPU")
        gap, moved = 0.0, 0.0
        for a, b_, ga, gb in zip(tree_leaves(cs.params), tree_leaves(hs.params),
                                 tree_leaves(cg), tree_leaves(hg)):
            if not torch.allclose(ga.cpu(), gb, **TRAIN_TOL):
                fail(f"{name} (2, 2) mesh: a gradient leaf card vs CPU max "
                     f"|diff| {float((ga.cpu() - gb).abs().max())}")
            gap = max(gap, float((ga.cpu() - gb).abs().max()))
            same = torch.sign(ga.cpu()) == torch.sign(gb)
            off = ~torch.isclose(a.cpu(), b_, **TRAIN_TOL) & same
            if bool(off.any()):
                fail(f"{name} (2, 2) mesh: params after two steps card vs CPU "
                     f"max |diff| {float((a.cpu() - b_)[off].abs().max())}")
            moved = max(moved, float((a.cpu() - b_)[same].abs().max()))
        say(f"[{tag}] (2, 2) mesh, reduced {name} at f32 compute, two gspmd "
            f"steps with manual EP ({counts}): card == CPU port (rtol/atol "
            f"1e-4), losses {', '.join(f'{l:.6f}' for l in closs)}; max |diff| "
            f"grads {gap:.2g}, params {moved:.2g}")


def start_dry_sweep() -> list:
    """10e, started: the dry run of every ``DRY_ARCHS`` cell on both
    production meshes (its CLI, ``dryrun.main``), in ``DRY_WORKERS`` host
    processes that need no card, the cells dealt out longest first
    (``deepseek-v3-671b`` training, about 20 s each); returns them."""
    shutil.rmtree(DRY_DIR, ignore_errors=True)
    DRY_DIR.mkdir(parents=True)
    cells = []
    for arch in DRY_ARCHS:
        for shape in SHAPES:
            meshes = (["--multi-pod"], []) if SHAPES[shape].kind == "train" \
                else (["--both-meshes"],)
            cells += [["--arch", arch, "--shape", shape, "--out", str(DRY_DIR)]
                      + extra for extra in meshes]
    cells.sort(key=lambda c: ("deepseek" not in c[1], "train" not in c[3]))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    code = ("import json, sys; from repro_torch.launch import dryrun; "
            "sys.exit(max(dryrun.main(a) for a in json.loads(sys.argv[1])))")
    procs = []
    for w in range(DRY_WORKERS):
        with open(DRY_DIR / f"log_{w}.txt", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code, json.dumps(cells[w::DRY_WORKERS])],
                env=env, cwd=str(ROOT), stdout=log, stderr=subprocess.STDOUT))
    return procs


def stop_dry_sweep(procs) -> None:
    """End every dry-run process still running (after a failure)."""
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def finish_dry_sweep(procs, tag: str) -> None:
    """10e, checked: every record's status is what ``cell_supported`` says
    (a "failed" cell fails the run), each with its per-device peak, dot
    FLOPs and the H100 roofline's dominant term."""
    t0 = time.perf_counter()
    for p in procs:
        p.wait(timeout=600)
    waited = time.perf_counter() - t0
    bad = [p.args[-1] for p in procs if p.returncode != 0]
    recs = [json.loads(f.read_text()) for f in sorted(DRY_DIR.glob("*.json"))]
    want = {(a, s, m) for a in DRY_ARCHS for s in SHAPES
            for m in ("16x16", "2x16x16")}
    got = {(r["arch"], r["shape"], r["mesh"]): r for r in recs}
    if set(got) != want:
        fail(f"dry-run sweep: records for {sorted(set(got))}, want {sorted(want)}")
    lines = []
    for key in sorted(got):
        r = got[key]
        ok = cell_supported(ARCHS[key[0]], SHAPES[key[1]])[0]
        if r["status"] != ("ok" if ok else "skipped"):
            fail(f"dry run {key}: status {r['status']} "
                 f"({r.get('error', r.get('reason'))})")
        if r["status"] == "ok":
            a = roofline.analyze_record(r)
            lines.append(f"{key[0]} {key[1]} {key[2]}: peak "
                         f"{r['memory']['peak_per_device_gib']} GiB/dev, "
                         f"{r['hlo']['dot_flops'] / 1e12:.2f} TFLOP/dev, "
                         f"{a['dominant']}-bound, roofline "
                         f"{a['roofline_fraction']:.2f}, meta step "
                         f"{r['compile_s']} s")
        else:
            lines.append(f"{key[0]} {key[1]} {key[2]}: skipped")
    if bad:
        fail(f"dry-run processes exited non-zero: {bad}")
    say(f"[{tag}] dry-run sweep of {', '.join(DRY_ARCHS)} on 16x16 and "
        f"2x16x16 ({len(got)} cells, {DRY_WORKERS} host processes beside "
        f"phase 10; {waited:.1f} s waited at its end): every status == "
        f"cell_supported; " + "; ".join(lines))


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
    # the stencil sites as the served rules launch them: the f32 answer of
    # the field's eps (a gradient writes it; a divergence adds and a curl
    # subtracts its second term, deriv1, onto the first)
    f_eps = e_lz.eps.to(torch.float32).reshape(())
    acc = fused.lorenzo_stencil(lz_words, shape, lz_bits, rowedge, coledge,
                                "deriv0", from_payload=True,
                                site="lorenzo_enc2d", eps=f_eps)
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
            # deriv0 and deriv1 2; f32 conversion and multiply 2 an output
            lambda w, r, c, e: fused.lorenzo_stencil(
                w, shape, lz_bits, r, c, "grad", from_payload=True,
                site="lorenzo_enc2d", eps=e), (lz_words, rowedge, coledge, f_eps),
            lambda: fused.lorenzo_scale_plain(fused.lorenzo_enc2d_plain(
                lz_words, shape, lz_bits, what="grad"), f_eps),
            pay(e_lz) + edge_bytes + 8 * n + 4, 9 * n, 4 * n),
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
        "lorenzo2d.stencil": (  # D0 and D1 2, deriv0 and deriv1 2; f32
            # conversion and multiply 2 an output
            lambda x, r, c, e: fused.lorenzo_stencil(
                x, shape, 0, r, c, "grad", from_payload=False,
                site="lorenzo2d", eps=e), (lz_plane, rowedge, coledge, f_eps),
            lambda: fused.lorenzo_scale_plain(
                fused.lorenzo_core(lz_plane, "grad"), f_eps),
            4 * n + edge_bytes + 8 * n + 4, 4 * n, 4 * n),
        # deriv1 accumulated onto an f32 plane (the plane read once more):
        # take out 2, unzigzag 3 (payload), D1 1, deriv1 1; f32 conversion,
        # multiply and add or subtract 3
        **{f"{site}.stencil.{mode}": (
            lambda x, r, c, e, o, fp=fp, si=site, b=b, m=mode:
            fused.lorenzo_stencil(x, shape, b, r, c, "deriv1", from_payload=fp,
                                  site=si, eps=e, mode=m, out=o),
            (src, rowedge, coledge, f_eps, acc),
            lambda plain=plain, m=mode: fused.lorenzo_scale_plain(
                plain(), f_eps, m, acc.clone()),
            n_src + edge_bytes + 8 * n + 4, (7 if fp else 2) * n, 3 * n)
           for site, src, fp, b, n_src, plain in (
               ("lorenzo_enc2d", lz_words, True, lz_bits, pay(e_lz),
                lambda: fused.lorenzo_enc2d_plain(lz_words, shape, lz_bits,
                                                  what="deriv1")),
               ("lorenzo2d", lz_plane, False, 0, 4 * n,
                lambda: fused.lorenzo_core(lz_plane, "deriv1")))
           for mode in ("add", "sub")},
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
        # the serving rules' sites: the same passes, one field
        "lorenzo_moments.edges": (
            lambda v: prefix_stats.stats_edges(v, "lorenzo_moments"), (p,),
            lambda: fused.lorenzo_edge_prefixes_plain(p, (th, tw)),
            4 * n + edge_bytes + corner_bytes, 2 * n),
        "lorenzo_moments.stats": (
            functools.partial(prefix_stats.prefix_stats_tiles,
                              site="lorenzo_moments"), (p, *ps_edges),
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


#: the rank-3 kernels' main-path shape: a serving group of 16 Miranda
#: fields (256 x 384 x 384) at 9 bits, and one field of it
MIRANDA, MIRANDA_BATCH, MIRANDA_BITS = (256, 384, 384), 16, 9


def _rank3_times(fn, args: tuple, plain, reps: int, n_bytes: int,
                 n_ops: tuple) -> dict:
    """One rank-3 pass or derivative timed as :func:`time_kernels` does
    (``plain`` the plain version of all its fields, called once a rep)."""
    k_ms = cuda_ms(functools.partial(fn, *args), reps)
    g_ms = graph_ms(fn, reps, args)
    h_ms = enqueue_ms(functools.partial(fn, *args), reps)
    p_ms = cuda_ms(plain, 1)
    b_ms, b_by = bound_ms(n_bytes, *n_ops)
    return {"ms": k_ms, "graph_ms": g_ms, "enqueue_ms": h_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes}


def time_rank3(seed: int, reps: int, tag: str, errs: dict) -> dict:
    """The rank-3 Lorenzo derivative at its main-path shape: B = 16 Miranda
    fields of seeded payload words (every residual the width allows) with
    their own eps, and the first of them alone.  Each axis, axis 2 as its
    edge pass and its stencil, bitwise ``lorenzo_enc3d_plain`` (the edge
    pass ``lorenzo3d_edges_plain``) field by field on the same payload and
    eps, then timed; the bound is this run's payload read once and its f32
    interior written once.  Returns the two sites' kernels-line entries:
    the edge pass at B = 16, and the stencil's with every axis's whole
    derivative at B = 16 and at B = 1 under ``axes`` (its own numbers are
    axis 0's, where the derivative is the stencil launch alone)."""
    shape, batch, bits = MIRANDA, MIRANDA_BATCH, MIRANDA_BITS
    n = math.prod(shape)
    m = tuple(k - 2 for k in shape)
    n_words = -(-n * bits // 32)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    words = torch.randint(-2 ** 31, 2 ** 31, (batch, n_words), generator=gen,
                          device=DEVICE, dtype=torch.int64).to(torch.int32)
    eps = torch.rand((batch,), generator=gen, device=DEVICE) * 1e-2 + 1e-4
    cases = {batch: (words, eps), 1: (words[0].clone(), eps[0].clone())}
    ops.reset_launches()
    vedge = fused.lorenzo3d_edges(words, shape, shape, bits)
    for b in range(batch):
        bitwise_err(fused.lorenzo3d_edges_plain(words[b], shape, shape, bits),
                    vedge[b], f"lorenzo3d edges, Miranda field {b} of {batch}")
    del vedge
    for axis in range(3):
        got = fused.lorenzo_enc3d(words, shape, shape, bits, axis, eps)
        for b in range(batch):
            bitwise_err(fused.lorenzo_enc3d_plain(words[b], shape, shape, bits,
                                                  axis, eps[b]), got[b],
                        f"lorenzo_enc3d axis {axis}, Miranda field {b} of "
                        f"{batch}")
        del got
    got = {k: ops.LAUNCHES[k] for k in PATHS["rank-3 path"]}
    if got != {"lorenzo_enc3d.edges": 2, "lorenzo_enc3d.stencil": 3}:
        fail(f"rank-3 launches: {got} (one edge pass alone and one "
             "derivative of each axis)")
    # a derivative launches one stencil, and axis 2 one edge pass
    per_call = {"lorenzo_enc3d.edges": 1, "lorenzo_enc3d.stencil": 1}
    errs["lorenzo_enc3d.edges"] = errs["lorenzo_enc3d.stencil"] = 0.0
    say(f"[{tag}] rank-3 kernels at {batch} x {shape}, {bits} bits: every "
        "axis and the edge pass bitwise the plain versions, field by field")

    def lone(fn, w, e):
        # the plain version of each field in turn (its int64 unpack)
        return lambda: [fn(w[b], e[b]) if w.ndim == 2 else fn(w, e)
                        for b in range(w.shape[0] if w.ndim == 2 else 1)]

    # take out 2 and unzigzag 3 a residual; r = p + p' 1 and the two prefix
    # adds 2 an interior value; its f32 conversion and multiply 2
    pay = 4 * words.numel()
    edges_bytes = 4 * batch * -(-m[0] // specs.CONSTANTS["lorenzo3d.cu"]["RUN"]
                                ) * (shape[1] - 1) * m[2]
    edges = _rank3_times(
        lambda w: fused.lorenzo3d_edges(w, shape, shape, bits), (words,),
        lone(lambda w, e: fused.lorenzo3d_edges_plain(w, shape, shape, bits),
             words, eps),
        reps, pay + edges_bytes, (5 * batch * n + 2 * batch * math.prod(m),))
    axes = []
    for axis in range(3):
        for b, (w, e) in cases.items():
            t = _rank3_times(
                lambda w, e, a=axis: fused.lorenzo_enc3d(w, shape, shape,
                                                         bits, a, e),
                (w, e),
                lone(lambda w, e, a=axis: fused.lorenzo_enc3d_plain(
                    w, shape, shape, bits, a, e), w, e),
                reps if b > 1 else 2 * reps,
                4 * w.numel() + 4 * b * math.prod(m),
                (5 * b * n + 3 * b * math.prod(m), 2 * b * math.prod(m)))
            axes.append({"axis": axis, "batch": b, **t})
            say(f"[{tag}] lorenzo_enc3d axis {axis}, {b} x {shape}: "
                f"{t['ms'] * 1e3:.1f} us by events, device alone "
                f"{t['graph_ms'] * 1e3:.1f} us, enqueue "
                f"{t['enqueue_ms'] * 1e3:.1f} us (plain "
                f"{t['plain_ms'] * 1e3:.1f} us, bound "
                f"{t['bound_ms'] * 1e3:.1f} us by {t['bound_by']}, "
                f"{t['graph_ms'] / t['bound_ms']:.2f}x)")
    say(f"[{tag}] lorenzo3d edge pass, {batch} x {shape}: "
        f"{edges['ms'] * 1e3:.1f} us by events, device alone "
        f"{edges['graph_ms'] * 1e3:.1f} us (plain "
        f"{edges['plain_ms'] * 1e3:.1f} us, bound "
        f"{edges['bound_ms'] * 1e3:.1f} us by {edges['bound_by']})")
    first = next(a for a in axes if a["axis"] == 0 and a["batch"] == batch)
    stencil = {k: first[k] for k in edges}
    return {"lorenzo_enc3d.edges": {**edges, "batch": batch},
            "lorenzo_enc3d.stencil": {**stencil, "batch": batch, "axis": 0,
                                      "axes": axes},
            "per_call": per_call}


def time_batched_kernels(inp: dict, single: dict, reps: int,
                         tag: str) -> dict:
    """The batched kernels at Ocean x ``BATCH`` (phase 3b's inputs; what =
    grad for the band kernels), timed as ``time_kernels`` times one field:
    events, device alone (cold and L2-warm), enqueue, the batched plain
    version and the bound of the batch's bytes and operations; beside each,
    ``BATCH`` times one field's device-alone time from ``single``."""
    shape, bits, b = inp["shape"], inp["bits"], BATCH
    plane, words, meta, p = inp["plane"], inp["words"], inp["meta"], inp["p"]
    ps = inp["ps"]
    n = shape[0] * shape[1]
    m = (shape[0] - 2) * (shape[1] - 2)
    th, tw = fused.lorenzo_tile()
    n_rt, n_ct = -(-shape[0] // th), -(-shape[1] // tw)
    edge_bytes = 4 * b * (shape[0] * n_ct + n_rt * shape[1])
    pay, meta_bytes = 4 * words.numel(), 4 * meta.numel()
    w_edges = fused.lorenzo_edges(words, shape, bits, from_payload=True,
                                  site="lorenzo_enc2d")
    p_edges = fused.lorenzo_edges(plane, shape, 0, from_payload=False,
                                  site="lorenzo2d")
    corner_bytes = 4 * b * n_rt * -(-shape[1] // prefix_stats.corner_cols())
    ps_edges = prefix_stats.stats_edges(ps, "lorenzo_moments")
    # the stencil sites' f32 answer, each field its own eps
    beps = torch.linspace(1e-3, 1e-2, b, dtype=torch.float32, device=DEVICE)
    # the operations per element of time_kernels' plans, over b fields
    plans = {
        "unpack.residuals": (
            lambda w: bitpack.unpack_residuals(w, n, bits), (words,),
            lambda: bitpack.unpack_residuals_plain(words, n, bits),
            pay + 4 * b * n, 5 * b * n),
        "lorenzo_enc2d.edges": (
            lambda w: fused.lorenzo_edges(w, shape, bits, from_payload=True,
                                          site="lorenzo_enc2d"), (words,),
            lambda: fused.lorenzo_edge_prefixes_plain(p, (th, tw)),
            pay + edge_bytes, 7 * b * n),
        "lorenzo_enc2d.stencil": (
            lambda w, r, c, e: fused.lorenzo_stencil(
                w, shape, bits, r, c, "grad", from_payload=True,
                site="lorenzo_enc2d", eps=e), (words, *w_edges, beps),
            lambda: fused.lorenzo_scale_plain(fused.lorenzo_enc2d_plain(
                words, shape, bits, what="grad"), beps),
            pay + edge_bytes + 8 * b * n + 4 * b, 9 * b * n, 4 * b * n),
        "blockmean_enc2d": (
            lambda w, m: fused.blockmean_enc2d(w, m, shape, BLOCK, bits,
                                               what="grad"), (words, meta),
            lambda: fused.blockmean_enc2d_plain(words, meta, shape, BLOCK,
                                                bits, what="grad"),
            pay + meta_bytes + 8 * b * n, 11 * b * n),
        "lorenzo2d.edges": (
            lambda x: fused.lorenzo_edges(x, shape, 0, from_payload=False,
                                          site="lorenzo2d"), (plane,),
            lambda: fused.lorenzo_edge_prefixes_plain(plane, (th, tw)),
            4 * b * n + edge_bytes, 2 * b * n),
        "lorenzo2d.stencil": (
            lambda x, r, c, e: fused.lorenzo_stencil(
                x, shape, 0, r, c, "grad", from_payload=False,
                site="lorenzo2d", eps=e), (plane, *p_edges, beps),
            lambda: fused.lorenzo_scale_plain(fused.lorenzo_core(plane, "grad"),
                                              beps),
            4 * b * n + edge_bytes + 8 * b * n + 4 * b, 4 * b * n, 4 * b * n),
        "blockmean2d": (
            lambda x, m: fused.blockmean2d(x, m, BLOCK, what="grad"),
            (plane, meta),
            lambda: fused.blockmean_core(plane, meta, BLOCK, "grad"),
            4 * b * n + meta_bytes + 8 * b * n, 6 * b * n),
        "grad2d": (  # two differences per interior element
            stencil_dq.grad2d_int, (plane,),
            lambda: stencil_dq.grad2d_int_plain(plane),
            4 * b * n + 8 * b * m, 2 * b * m),
        "lorenzo_moments.edges": (  # row and column sums 2
            lambda v: prefix_stats.stats_edges(v, "lorenzo_moments"), (ps,),
            lambda: fused.lorenzo_edge_prefixes_plain(ps, (th, tw)),
            4 * b * n + edge_bytes + corner_bytes, 2 * b * n),
        "lorenzo_moments.stats": (  # q from two prefixes 2; f32 cast, q²,
            # two sums 4
            functools.partial(prefix_stats.prefix_stats_tiles,
                              site="lorenzo_moments"), (ps, *ps_edges),
            lambda: prefix_stats.prefix_stats_batch_plain(ps),
            4 * b * n + edge_bytes + corner_bytes + 8 * b, 2 * b * n,
            4 * b * n),
    }
    out = {}
    for site, (fn, args, plain, n_bytes, *n_ops) in plans.items():
        kernel = functools.partial(fn, *args)
        k_ms = cuda_ms(kernel, reps)
        g_ms = graph_ms(fn, reps, args)
        w_ms = graph_ms(fn, reps, args, cold=False)
        h_ms = enqueue_ms(kernel, reps)
        p_ms = cuda_ms(plain, max(3, reps // 10))
        b_ms, b_by = bound_ms(n_bytes, *n_ops)
        one = single[site]["graph_ms"]
        out[f"{site} x{b}"] = {
            "ms": k_ms, "graph_ms": g_ms, "enqueue_ms": h_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes,
            "one_field_graph_ms": one}
        say(f"[{tag}] {site} x{b} (one launch, {b} x {shape}): "
            f"{k_ms * 1e3:.1f} us by events, device alone {g_ms * 1e3:.1f} "
            f"us (L2-warm {w_ms * 1e3:.1f} us; {b} x one field alone "
            f"{b * one * 1e3:.1f} us, ratio {g_ms / (b * one):.3f}), enqueue "
            f"{h_ms * 1e3:.1f} us (plain {p_ms * 1e3:.1f} us, bound "
            f"{b_ms * 1e3:.1f} us by {b_by}, {n_bytes / 1e6:.1f} MB, "
            f"{n_bytes / (g_ms * 1e-3) / 1e9:.0f} GB/s device alone)")
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


#: the f32 epilogue's timings: Ocean alone and the engine's batch of 16, at
#: the Ocean cells' 9 bits
LZ_F32_BATCHES = (1, 16)
LZ_F32_BITS = 9


def time_lorenzo_f32(seed: int, reps: int, tag: str) -> dict:
    """The Lorenzo stencil pass alone (its edges given) at Ocean's shape, one
    field and 16, from a 9-bit payload (``lorenzo_enc2d``, §6 row 3) and
    from the residual plane (``lorenzo2d``, row 5), deriv0 in four forms in
    one call: the int32 plane; the int32 plane with the torch tail the
    rules ran before (interior crop, f32 conversion, x eps); the f32 write
    mode; the add mode onto an f32 plane.  Write and add are bitwise the
    plain epilogue of the int32 plane.  The byte bound: the source and
    edges read once and the plane written once, the add mode's plane read
    once more.  Returns the timings by (site, batch)."""
    rng = np.random.default_rng(seed)
    shape, bits = OCEAN, LZ_F32_BITS
    n = math.prod(shape)
    out = {}
    for batch in LZ_F32_BATCHES:
        lead = (batch,) if batch > 1 else ()
        p = _residuals(lead + shape, bits, rng)
        eps = torch.as_tensor(rng.uniform(1e-4, 1e-2, batch).astype(np.float32),
                              device=DEVICE)
        eps = eps if lead else eps[0]
        for site, src, w_bits in (("lorenzo_enc2d", _payload_of(p, bits), bits),
                                  ("lorenzo2d", p, 0)):
            from_payload = site == "lorenzo_enc2d"
            edges = fused.lorenzo_edges(src, shape, w_bits,
                                        from_payload=from_payload, site=site)

            def stencil(x, r, c, fp=from_payload, si=site, wb=w_bits, **kw):
                return fused.lorenzo_stencil(x, shape, wb, r, c, "deriv0",
                                             from_payload=fp, site=si, **kw)

            def tail(x, r, c, e):
                d = stencil(x, r, c)[..., 1:-1, 1:-1]
                return d.to(torch.float32) * e.reshape(e.shape + (1, 1))

            ints = stencil(src, *edges)
            plane = stencil(src, *edges, eps=eps)
            bitwise_err(fused.lorenzo_scale_plain(ints, eps), plane,
                        f"{site} f32 write, {batch} x {shape}")
            acc = plane.clone()
            stencil(src, *edges, eps=eps, mode="add", out=acc)
            bitwise_err(fused.lorenzo_scale_plain(ints, eps, "add",
                                                  plane.clone()),
                        acc, f"{site} f32 add, {batch} x {shape}")
            del ints
            base = 4 * src.numel() + 4 * sum(e.numel() for e in edges)
            plane_bytes = 4 * batch * n
            row = {}
            for form, fn, args, n_bytes in (
                    ("int32", stencil, (src, *edges), base + plane_bytes),
                    ("int32 + torch tail", tail, (src, *edges, eps),
                     base + plane_bytes),
                    ("f32 write", lambda x, r, c, e: stencil(x, r, c, eps=e),
                     (src, *edges, eps), base + plane_bytes),
                    ("f32 add", lambda x, r, c, e, o: stencil(
                        x, r, c, eps=e, mode="add", out=o),
                     (src, *edges, eps, acc), base + 2 * plane_bytes)):
                ms = graph_ms(fn, reps, args)
                b_ms = n_bytes / HBM_BYTES_PER_S * 1e3
                row[form] = {"graph_ms": ms, "bound_ms": b_ms}
                say(f"[{tag}] {site} stencil pass deriv0 {form}, {batch} x "
                    f"{shape} at {bits} bits: device alone {ms * 1e3:.1f} us "
                    f"(byte bound {b_ms * 1e3:.1f} us, {ms / b_ms:.2f}x)")
            out[(site, batch)] = row
            del src, edges, plane, acc
            torch.cuda.empty_cache()
        del p
    return out


def served_tails(fields, tag: str) -> dict:
    """``kernels.ops.TAILS`` over one served step of each Ocean traffic mix
    with a float tail (diff: derivative along axis 0 and Laplacian of u and
    v; multi: divergence and curl of (u, v); 16 requests of each op) for
    both schemes: the share of float-tail operations that ran in a kernel
    epilogue.  The Lorenzo (HSZp-nd) steps run them all there, the
    block-mean ones none."""
    mixes = {"diff": [("derivative", 0, fid) for fid in ("u", "v")] * 8
             + [("laplacian", 0, fid) for fid in ("u", "v")] * 8,
             "multi": [(op, 0, ("u", "v")) for op in ("divergence", "curl")
                       for _ in range(16)]}
    shares = {}
    for scheme in SCHEMES:
        store = FieldStore(cache_bytes=0)
        for fid, f in zip(("u", "v"), fields[scheme]["Encoded"]):
            store.put(fid, f)
        for mix, kinds in mixes.items():
            fe = AnalyticsFrontend(store=store)
            for i, (op, axis, ids) in enumerate(kinds):
                fe.add_request(AnalyticsRequest(uid=i, fields=ids, op=op,
                                                axis=axis, stage="auto"))
            ops.reset_tails()
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", DeprecationWarning)
                done = fe.step()
            torch.cuda.synchronize()
            if any(r.error is not None for r in done):
                fail(f"served {scheme} {mix}: {[r.error for r in done]}")
            tails = dict(ops.TAILS)
            share = tails["kernel"] / max(sum(tails.values()), 1)
            shares[(scheme, mix)] = share
            want = 1.0 if scheme == "hszp_nd" else 0.0
            if share != want:
                fail(f"served {scheme} {mix}: float tails {tails}, kernel "
                     f"share {share} (expected {want})")
            say(f"[{tag}] served {scheme} {mix} step of {len(kinds)} "
                f"requests: float tails {tails}, kernel share {share:.2f}")
    return shares


def traced_kernels(fn) -> tuple[list[str], list]:
    """The device kernels that one call of ``fn`` runs, in order, from a
    ``torch.profiler`` trace (after two untraced calls): short names and
    the profiler's events (``device_time`` in us)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    events = sorted((e for e in profiled(fn, "a call", whole=True)
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    names = [re.sub(r"^void |\(anonymous namespace\)::|\(.*$", "", e.name)
             for e in events]
    return names, events


def _listed(names, events) -> str:
    return ", ".join(f"{k} {e.device_time:.1f} us"
                     for k, e in zip(names, events))


def query_kernels(fields, tag: str) -> dict:
    """The device kernels of one Lorenzo gradient@③ query per container, in
    order, from a ``torch.profiler`` trace: the Lorenzo kernels (at most
    three, the stencil pass writing the f32 answer) and no float tail after
    them, each with its device time."""
    out = {}
    for container in ("Encoded", "Compressed"):
        fu, fv = fields["hszp_nd"][container]
        names, events = traced_kernels(
            lambda: run_cell("gradient", Stage.Q, fu, fv))
        ours = 0
        while ours < len(names) and names[ours].startswith("lorenzo_"):
            ours += 1
        if not 0 < ours <= 3 or ours != len(names):
            fail(f"Lorenzo gradient query ({container}): kernels {names}")
        out[container] = {"before_tail": ours, "total": len(names)}
        say(f"[{tag}] hszp_nd {container} gradient@Q device kernels: {ours} "
            f"({_listed(names[:ours], events[:ours])}), no float tail")
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
    "lorenzo_moments.edges": ("hszp_nd", "Encoded", "std", Stage.P),
    "lorenzo_moments.stats": ("hszp_nd", "Encoded", "std", Stage.P),
    "lorenzo_enc2d.edges": ("hszp_nd", "Encoded", "gradient", Stage.Q),
    "lorenzo_enc2d.stencil": ("hszp_nd", "Encoded", "gradient", Stage.Q),
    "blockmean_enc2d": ("hszx_nd", "Encoded", "gradient", Stage.Q),
    "lorenzo2d.edges": ("hszp_nd", "Compressed", "gradient", Stage.Q),
    "lorenzo2d.stencil": ("hszp_nd", "Compressed", "gradient", Stage.Q),
    "blockmean2d": ("hszx_nd", "Compressed", "gradient", Stage.Q),
}

#: the stencil pass's accumulate modes as kernels-line entries (name ->
#: the query whose launches of it are counted): a divergence adds its
#: second term, a curl subtracts it
MODE_QUERY = {
    "lorenzo_enc2d.stencil.add": ("hszp_nd", "Encoded", "divergence", Stage.Q),
    "lorenzo_enc2d.stencil.sub": ("hszp_nd", "Encoded", "curl", Stage.Q),
    "lorenzo2d.stencil.add": ("hszp_nd", "Compressed", "divergence", Stage.Q),
    "lorenzo2d.stencil.sub": ("hszp_nd", "Compressed", "curl", Stage.Q),
}
#: launches of the MODE_QUERY entries, counted at the launcher
#: (``kernels.ops.LAUNCHES`` counts every mode under its stencil site)
MODE_LAUNCHES = dict.fromkeys(MODE_QUERY, 0)


def tally_modes(call):
    """``build.call`` that also counts the stencil pass's add and sub
    launches in :data:`MODE_LAUNCHES`."""
    modes = {fused._MODE_CODE[m]: m for m in ("add", "sub")}

    def tallied(name, *args):
        if name == "hsz_lorenzo_stencil" and args[10] in modes:
            site = "lorenzo_enc2d" if args[0] else "lorenzo2d"
            MODE_LAUNCHES[f"{site}.stencil.{modes[args[10]]}"] += 1
        return call(name, *args)
    return tallied


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
    for site, (scheme, container, op, stage) in MODE_QUERY.items():
        fu, fv = fields[scheme][container]
        for k in MODE_LAUNCHES:
            MODE_LAUNCHES[k] = 0
        run_cell(op, stage, fu, fv)
        torch.cuda.synchronize()
        out[site] = MODE_LAUNCHES[site]
        if not out[site]:
            fail(f"{scheme} {container} {op}@{stage.name}: no {site} launch")
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
                   f"lorenzo_stencil_kernel<{flag}, {fused._LZ_CODE[what]}, ")
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
    build.call = tally_modes(build.call)
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
    phase_s["3b"] = time.perf_counter()
    # 3b. the batched kernels: one launch over a batch of fields, against
    # the batched plain versions (Ocean x 8, ragged batches, cross-field)
    batch_in = check_batched_kernels(args.seed, errs)

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
    for k in MODE_LAUNCHES:
        MODE_LAUNCHES[k] = 0
    fields, decomp, results = main_path(u, v)
    path_launches["main path"] = dict(ops.LAUNCHES)
    mode_launches = dict(MODE_LAUNCHES)
    if not all(mode_launches.values()):
        fail(f"main path: accumulate launches {mode_launches}")
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
    # the rank-3 path: the Lorenzo derivative's rank-3 kernels
    ops.reset_launches()
    rank3_path(args.seed)
    path_launches["rank-3 path"] = dict(ops.LAUNCHES)
    require_launches("rank-3 path", path_launches["rank-3 path"])
    never = [k for k in ops.LAUNCHES
             if all(counts[k] == 0 for counts in path_launches.values())]
    if never:
        fail(f"kernel sites launched on no path: {never}")
    # each site's launches on its path (unpack runs on both: the main path's)
    launches = {k: path_launches[next(
        (p for p in ("main path", "rank-3 path") if k in PATHS[p]),
        "entry point")][k] for k in SITES}
    check_region_path(fields, hosts, region_out)
    check_region_ab(fields)
    check_region_kernels(fields, errs)
    phase_s["5b syncs"] = time.perf_counter()
    sync_audit(fields)

    phase_s["5c fields"] = time.perf_counter()
    # 5c. the engine path: batched op sets, expressions, the store; each
    # query counted on its own and held against its plan
    efields = engine_fields(args.seed)
    phase_s["5b batches"] = time.perf_counter()
    # 5b batches: region and store-seeded programs over the eight fields,
    # each run one program (every kernel pass one launch for the batch)
    path_launches["region batches"], _ = region_batches(
        efields, analytics.BatchedAnalytics())
    require_launches("region batches", path_launches["region batches"])
    phase_s["5c path"] = time.perf_counter()
    engine_out = engine_path(efields, analytics.BatchedAnalytics())
    path_launches["engine path"], batched_launches = check_engine_launches(
        efields, engine_out)
    for k, c in path_launches["region batches"].items():
        batched_launches[k] += c
    idle = [k for k in BATCHED_SITES if not batched_launches[k]]
    if idle:
        fail(f"the engine's batched runs never launched {idle}")
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
    times.update(time_batched_kernels(batch_in, times, REPS, tag))
    del batch_in
    rank3 = time_rank3(args.seed, REPS, tag, errs)
    times.update(rank3)
    epilogue = time_lorenzo_f32(args.seed, REPS, tag)
    served_tails(fields, tag)
    per_query = per_query_launches(fields, tag)
    per_query.update(per_call_launches(entry, tag))
    per_query.update(rank3.pop("per_call"))
    query_kernels(fields, tag)
    decode_and_stats_kernels(fields, entry, tag)
    region_query_kernels(fields, tag)
    time_queries(fields, tag)
    time_region_queries(fields, tag)
    time_engine(efields, tag)
    engine_trace(efields, tag)
    time_region_batches(efields, tag)

    phase_s["7"] = time.perf_counter()
    # 7. the static audit on the card: clean in both modes, the library's
    # launch attributes against the specs, sentinel-checked coverage of
    # every instantiation at the edge shapes
    check_audit()
    check_launch_attrs(card)
    check_coverage(args.seed)

    phase_s["8a"] = time.perf_counter()
    # 8. the science store at scale 1 against the CPU port on the same .hsz
    # bytes, then LM serving at smollm-360m's full width.  It runs before
    # 5e, whose run made the profiler drop the first kernel of later traces
    path_launches["science store"] = check_science(args.seed, tag)
    phase_s["8b"] = time.perf_counter()
    lm_full_width(args.seed, tag)
    phase_s["8b CPU"] = time.perf_counter()
    lm_small_vs_cpu(args.seed, tag)
    phase_s["8c"] = time.perf_counter()
    # 8c. the ssm, hybrid and audio families at their published widths,
    # then reduced against the CPU port
    for arch, n_layers in LM_WIDE.items():
        lm_full_width(args.seed, tag, arch, n_layers)
    phase_s["8c CPU"] = time.perf_counter()
    lm_small_vs_cpu(args.seed, tag, LM_SMALL_8C)

    phase_s["9a"] = time.perf_counter()
    # 9. training at smollm-360m's full width (gspmd, then hom over four
    # workers on the card), checkpoints at its widths cut to 2 layers, the
    # compressed collectives (their pack / unpack launches counted), then
    # the reduced archs against the CPU port
    trained = train_full_width(args.seed, tag)
    phase_s["9b"] = time.perf_counter()
    hom_full_width(trained, tag)
    phase_s["9c"] = time.perf_counter()
    checkpoints(args.seed, tag)
    phase_s["9d"] = time.perf_counter()
    path_launches["collectives"] = collectives_path(trained, tag)
    del trained
    gc.collect()
    torch.cuda.empty_cache()
    phase_s["9e"] = time.perf_counter()
    train_small_vs_cpu(args.seed, tag)

    phase_s["10a"] = time.perf_counter()
    # 10. the mesh layer: one MoE layer with manual expert parallelism over
    # peers on the card, the meshed engine, the dry run against the card and
    # gspmd steps under a (2, 2) mesh; meanwhile the dry-run sweep runs in
    # host processes of its own
    sweep = start_dry_sweep()
    try:
        ep_layer(args.seed, tag)
        phase_s["10b"] = time.perf_counter()
        ep_serve(args.seed, tag)
        phase_s["10c"] = time.perf_counter()
        dry_vs_card(args.seed, tag)
        phase_s["10d"] = time.perf_counter()
        mesh_steps_vs_cpu(args.seed, tag)
        phase_s["10e"] = time.perf_counter()
        finish_dry_sweep(sweep, tag)
    finally:
        stop_dry_sweep(sweep)

    phase_s["5e"] = time.perf_counter()
    # 5e. the serve path: one frontend step over a router of a sharded store
    # (8 shards on the card, then 1) and a local one, held to the same step
    # over a single-device store and replayed query by query.  It runs after
    # phase 6's traces: once it had run, the profiler dropped the first
    # kernel of every later trace (PERF.md §7)
    serve_out = serve_path(fields, u, v, args.seed)
    path_launches["serve path"] = serve_out["launches"]
    require_launches("serve path", path_launches["serve path"])
    check_merge_launches(serve_out)
    check_group_launches(serve_out)
    phase_s["5e times"] = time.perf_counter()
    time_serve(serve_out, tag)
    del serve_out

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
            "region_batch_launches": path_launches["region batches"][name],
            "engine_launches": path_launches["engine path"][name],
            "stream_launches": path_launches["stream path"][name],
            "serve_launches": path_launches["serve path"][name],
            "science_store_launches": path_launches["science store"][name],
            "collectives_launches": path_launches["collectives"][name]})
        if name == "unpack.residuals":
            kernels[-1]["slab"] = slab_times
        if name == "prefix_stats2d.stats":
            kernels[-1]["wide"] = dict(times[WIDE_STATS],
                                       shape=list(PS_WIDE[1]))
        if name in PATHS["rank-3 path"]:
            kernels[-1].update(
                {k: t[k] for k in ("batch", "axis", "axes") if k in t},
                shape=list(MIRANDA), bits=MIRANDA_BITS)
        if name in ("lorenzo_enc2d.stencil", "lorenzo2d.stencil"):
            # deriv0 in each form, one field and a batch (time_lorenzo_f32)
            kernels[-1]["epilogue"] = {
                f"x{b}": row for (site, b), row in epilogue.items()
                if name == f"{site}.stencil"}
    for name, (scheme, container, op, stage) in MODE_QUERY.items():
        # the accumulate modes of the stencil sites: their launches on the
        # main path and per divergence or curl query
        t = times[name]
        source, replaces = SITES[name.rsplit(".", 1)[0]]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": mode_launches[name],
            "launches_per_query": per_query[name], "max_abs_err": errs[name],
            "ms": t["ms"], "graph_ms": t["graph_ms"],
            "enqueue_ms": t["enqueue_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None})
    for site in BATCHED_SITES:
        # the same kernel over a batch of 8 Ocean fields in one launch: its
        # launches are those of the batched runs: the engine path's (a),
        # (b) and (d) hits, and phase 5b's region and seeded batches
        name = f"{site} x{BATCH}"
        t = times[name]
        source, replaces = SITES[site]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": batched_launches[site],
            "batch": BATCH, "max_abs_err": errs[name], "ms": t["ms"],
            "graph_ms": t["graph_ms"], "enqueue_ms": t["enqueue_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "one_field_graph_ms": t["one_field_graph_ms"]})
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
