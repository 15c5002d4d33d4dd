"""Fault-tolerant checkpointing with HSZ integration.

Layout (one directory per step, atomic rename commit), the reference's
``repro/train/checkpoint.py`` byte for byte, so a checkpoint written by
either package restores in the other:

    ckpt_dir/
      step_000123.tmp/ -> step_000123/
        manifest.json        # tree structure, shapes, dtypes, stats, mode
        arrays/<idx>.bin     # zstd(raw) | zlib(raw) | HSZ stream per leaf

* **leaf paths and order are jax's**: dict keys sorted, NamedTuple fields
  as ``.name``, ``None`` no leaf (``models.common.tree_flatten_with_paths``);
  ``arrays/<i>.bin`` follows that order.  A :class:`~repro_torch.comm.
  PerWorker` value (a ``hom``-mode error-feedback state) is stored as
  worker 0's tree, which is what the reference's host reads, and restored
  onto every worker;
* **atomic commit + retention**: a crash mid-write never corrupts the
  latest checkpoint; keep-last-k pruning;
* **async save**: leaves are pulled to the host first, then a background
  thread compresses and writes (``blocking=False`` returns the thread);
  the lossless codec runs over the leaves on a pool of up to 8 threads
  (save and restore; the files are the ones one thread writes);
* **lossless mode** (default, bit-exact resume): ``zstandard`` level 3,
  else the stdlib ``zlib`` at level 6; bf16 leaves, which numpy cannot
  hold, as their 16-bit patterns under the dtype name ``"bfloat16"``;
* **HSZ mode** (the paper): float leaves of at least 1024 values stored as
  error-bounded ``hszp`` streams (``core.encode.serialize``, compressed on
  the leaf's device); the manifest records stage-② homomorphic statistics
  (mean / std from the residuals) so restore verifies integrity without
  decompressing.
"""
from __future__ import annotations

import concurrent.futures
import json
import os
import shutil
import threading
import time
import zlib
from typing import Any

import numpy as np
import torch

try:
    import zstandard
except ImportError:  # optional dep: fall back to stdlib zlib lossless codec
    zstandard = None

from ..comm.hom_collectives import PerWorker
from ..core import Stage, encode as hsz_encode, homomorphic, hszp
from ..kernels import ops as kernel_ops
from ..models.common import tree_flatten_with_paths, tree_map, tree_unflatten

_FLOAT_KINDS = ("f",)
_BF16 = "bfloat16"


def _lossless_codec():
    """(codec name, compress fn) — zstd when available, else stdlib zlib.
    A zstd compressor object is not thread-safe, so each call makes its
    own."""
    if zstandard is not None:
        return "zstd", lambda raw: zstandard.ZstdCompressor(level=3).compress(raw)
    return "zlib", lambda raw: zlib.compress(raw, 6)


def _lossless_decompress(codec: str, blob: bytes) -> bytes:
    if codec == "zstd":
        if zstandard is None:
            raise RuntimeError(
                "checkpoint was written with zstd but zstandard is not installed")
        return zstandard.ZstdDecompressor().decompress(blob)
    return zlib.decompress(blob)


def _host_view(tree):
    """``tree`` with every :class:`PerWorker` value replaced by worker 0's."""
    if isinstance(tree, PerWorker):
        return _host_view(tree[0])
    if isinstance(tree, dict):
        return {k: _host_view(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_host_view(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_view(v) for v in tree)
    return tree


def _per_workers(target, restored):
    """``restored`` (a :func:`_host_view` of ``target``) with each
    :class:`PerWorker` value of ``target`` rebuilt: the restored tree put on
    every worker's devices."""
    if isinstance(target, PerWorker):
        return PerWorker(tree_map(lambda t, ref: t.to(ref.device), restored, w)
                         for w in target)
    if isinstance(target, dict):
        return {k: _per_workers(v, restored[k]) for k, v in target.items()}
    if isinstance(target, tuple) and hasattr(target, "_fields"):
        return type(target)(*(_per_workers(v, r)
                              for v, r in zip(target, restored)))
    if isinstance(target, (list, tuple)):
        return type(target)(_per_workers(v, r)
                            for v, r in zip(target, restored))
    return restored


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """(host array, manifest dtype name) of one leaf; bf16 as its bits."""
    if not isinstance(leaf, torch.Tensor):
        arr = np.asarray(leaf)
        return arr, str(arr.dtype)
    t = leaf.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16), _BF16
    arr = t.cpu().numpy()
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save(ckpt_dir: str, step: int, tree: Any, *, mode: str = "lossless",
         rel_eb: float = 1e-4, keep: int = 3, blocking: bool = True,
         extra_meta: dict | None = None) -> threading.Thread | None:
    """Serialize ``tree`` to ``ckpt_dir/step_{step:08d}`` atomically."""
    paths, leaves = tree_flatten_with_paths(_host_view(tree))
    # pull to host before handing to the writer thread
    host = [_to_host(l) for l in leaves]
    devices = [l.device if isinstance(l, torch.Tensor) else torch.device("cpu")
               for l in leaves]

    def _write():
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        os.makedirs(os.path.join(tmp, "arrays"), exist_ok=True)
        manifest = {"step": step, "mode": mode, "rel_eb": rel_eb,
                    "time": time.time(), "leaves": [],
                    "extra": extra_meta or {}}
        lossless_codec, lossless_compress = _lossless_codec()
        use_hsz = [mode == "hsz" and arr.dtype.kind in _FLOAT_KINDS
                   and arr.size >= 1024 for arr, _ in host]
        with _codec_pool() as pool:
            # the lossless leaves' codec on worker threads (it releases the
            # interpreter lock), the HSZ leaves on this one
            lossless = {i: pool.submit(lambda a: lossless_compress(a.tobytes()),
                                       arr)
                        for i, (arr, _) in enumerate(host) if not use_hsz[i]}
            for i, (path, (arr, dtype), dev) in enumerate(zip(paths, host,
                                                              devices)):
                manifest["leaves"].append(_write_leaf(
                    tmp, i, path, arr, dtype, dev, use_hsz[i], rel_eb,
                    lossless_codec, lossless.get(i)))
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit
        _prune(ckpt_dir, keep)

    if blocking:
        _write()
        return None
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


def _codec_pool() -> concurrent.futures.ThreadPoolExecutor:
    return concurrent.futures.ThreadPoolExecutor(
        max_workers=max(1, min(8, os.cpu_count() or 1)))


def _write_leaf(tmp, i, path, arr, dtype, dev, use_hsz, rel_eb,
                lossless_codec, lossless_blob) -> dict:
    """Write leaf ``i``'s file (its lossless blob, a future, or its HSZ
    stream made here on ``dev``) and return its manifest entry."""
    entry = {"path": path, "shape": list(arr.shape), "dtype": dtype,
             "file": f"arrays/{i}.bin"}
    if use_hsz:
        c = hszp.compress(torch.as_tensor(arr, dtype=torch.float32),
                          rel_eb=rel_eb, device=dev)
        blob = hsz_encode.serialize(c)
        # stage-② homomorphic validation stats (no decompression at load)
        entry["codec"] = "hsz"
        entry["stats"] = {
            "mean": float(homomorphic.mean(c, Stage.P)),
            "std": float(homomorphic.std(c, Stage.P)),
        }
        entry["ratio"] = float(arr.nbytes * 8) / float(hszp.serialized_bits(c))
    else:
        blob = lossless_blob.result()
        entry["codec"] = lossless_codec
    with open(os.path.join(tmp, entry["file"]), "wb") as f:
        f.write(blob)
    return entry


def _prune(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, target_tree: Any, *, device="cuda",
            verify: bool = True) -> Any:
    """Load into the structure of ``target_tree``, leaves on ``device`` (the
    card unless the caller asks for the CPU) in the target leaves' dtypes;
    a :class:`PerWorker` value's items go to the devices of the target's
    items.  HSZ leaves are verified against the manifest's mean first."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(final, "manifest.json")) as f:
        manifest = json.load(f)
    dev = kernel_ops.resolve_device(device)
    host_target = _host_view(target_tree)
    paths, leaves = tree_flatten_with_paths(host_target)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    entries = [by_path[path] for path in paths]
    blobs = []
    for entry in entries:
        with open(os.path.join(final, entry["file"]), "rb") as f:
            blobs.append(f.read())
    with _codec_pool() as pool:
        raws = [None if e["codec"] == "hsz" else pool.submit(
            _lossless_decompress, e["codec"], b) for e, b in zip(entries, blobs)]
    out = []
    for path, ref, entry, blob, raw in zip(paths, leaves, entries, blobs, raws):
        if entry["codec"] == "hsz":
            c = hsz_encode.deserialize(blob, device=dev)
            if verify and "stats" in entry:
                mu = float(homomorphic.mean(c, Stage.M)) if c.scheme.is_blockmean \
                    else float(homomorphic.mean(c, Stage.P))
                ref_mu = entry["stats"]["mean"]
                eps = float(c.eps)
                if abs(mu - ref_mu) > max(2 * eps, 1e-6 * max(abs(ref_mu), 1)):
                    raise ValueError(
                        f"homomorphic integrity check failed for {path}: "
                        f"mean {mu} vs manifest {ref_mu}")
            t = hszp.decompress(c, Stage.F).reshape(entry["shape"])
            t = t.to(getattr(torch, entry["dtype"]))
        else:
            raw = bytearray(raw.result())
            np_dtype = np.uint16 if entry["dtype"] == _BF16 else entry["dtype"]
            arr = np.frombuffer(raw, dtype=np_dtype).reshape(entry["shape"])
            t = _from_host(arr, entry["dtype"]).to(dev)
        is_tensor = isinstance(ref, torch.Tensor)
        if tuple(t.shape) != tuple(ref.shape if is_tensor else np.shape(ref)):
            raise ValueError(f"shape mismatch for {path}")
        out.append(t.to(ref.dtype) if is_tensor else t)
    return _per_workers(target_tree, tree_unflatten(host_target, out))
