"""Build the Hopper kernels with ``nvcc`` and load them with ``ctypes``.

Every ``csrc/*.cu`` source is compiled for ``sm_90a`` by its own ``nvcc``
process (all started together), and the objects are linked into one shared
library with a plain ``extern "C"`` interface:
``<repo>/build/repro_torch_kernels/libhsz.so``.  The build runs on first use
and is reused while a digest of the sources and flags is unchanged.  It
needs only the sources in the checkout and the CUDA toolkit.

The launchers take raw device pointers (``tensor.data_ptr()``), ints and the
CUDA stream, enqueue their kernel on that stream, and return
``cudaGetLastError()``; :func:`call` raises on a nonzero return.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from .. import trace

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas", "-v", "-Xcompiler", "-fPIC")

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

#: argument types of every launcher (pointers and the stream as c_void_p,
#: so ctypes never narrows them to 32 bits).
SIGNATURES = {
    # words, n_words (per field), out, n, bits, unzigzag, batch, stream
    "hsz_unpack": (_P, _LL, _P, _LL, _I, _I, _I, _P),
    # unzigzag, &smem_bytes, &regs, &blocks_per_sm
    "hsz_unpack_info": (_I, _P, _P, _P),
    # &th, &tw
    "hsz_lorenzo_tile": (_P, _P),
    # &cols
    "hsz_corner_cols": (_P,),
    # from_payload, what (-1: edge pass), &smem_bytes, &regs, &blocks_per_sm
    "hsz_lorenzo_info": (_I, _I, _P, _P, _P),
    # from_payload, src, n_words (per field), bits, n0, n1, batch, rowedge,
    # coledge, corners (null but for prefix_stats2d), stream
    "hsz_lorenzo_edges": (_I, _P, _LL, _I, _I, _I, _I, _P, _P, _P, _P),
    # from_payload, src, n_words (per field), bits, n0, n1, batch, rowedge,
    # coledge, what, mode (0 int32, 1 write, 2 add, 3 sub), eps (null for
    # int32), out0, out1, stream
    "hsz_lorenzo_stencil": (_I, _P, _LL, _I, _I, _I, _I, _P, _P, _I, _I, _P,
                            _P, _P, _P),
    # from_payload, src, n_words (per field), bits, n0, n1, batch, meta,
    # b0, b1, what, out0, out1, stream
    "hsz_blockmean": (_I, _P, _LL, _I, _I, _I, _I, _P, _I, _I, _I, _P, _P,
                      _P),
    # from_payload, what, &smem_bytes, &blocks_per_sm
    "hsz_blockmean_info": (_I, _I, _P, _P),
    # words, n_words (per field), bits, p1, p2, n0, n1, n2, batch, vedge,
    # stream
    "hsz_lorenzo3d_edges": (_P, _LL, _I, _I, _I, _I, _I, _I, _I, _P, _P),
    # axis, words, n_words (per field), bits, p1, p2, n0, n1, n2, batch, eps,
    # vedge (axis 2; null otherwise), out, stream
    "hsz_lorenzo3d_stencil": (_I, _P, _LL, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                              _P, _P),
    # p, n0, n1, batch, rowedge, coledge, corners, partials, n_pairs, out,
    # stream
    "hsz_prefix_stats": (_P, _I, _I, _I, _P, _P, _P, _P, _LL, _P, _P),
    # n0, n1, batch, &grid
    "hsz_prefix_stats_grid": (_I, _I, _I, _P),
    # &smem_bytes, &regs, &blocks_per_sm
    "hsz_prefix_stats_info": (_P, _P, _P),
    # u, n, words, n_words, bits, stream
    "hsz_pack": (_P, _LL, _P, _LL, _I, _P),
    # x, n0, n1, inv, p, stream
    "hsz_quant_lorenzo2d": (_P, _I, _I, _P, _P, _P),
    # q, n_blocks, s_len, means, maxu, stream
    "hsz_block_stats": (_P, _LL, _I, _P, _P, _P),
    # q, n0, n1, batch, d0, d1, stream
    "hsz_grad2d": (_P, _I, _I, _I, _P, _P, _P),
    # q, n0, n1, out, stream
    "hsz_laplacian2d": (_P, _I, _I, _P, _P),
    # kernel id (specs.KERNEL_IDS), &static_smem, &dynamic_smem, &regs,
    # &blocks_per_sm
    "hsz_func_attrs": (_I, _P, _P, _P, _P),
    # &bytes: the card's shared memory per block with the opt-in
    "hsz_smem_optin": (_P,),
}

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
#: ``-Xptxas -v`` report of the last build in this process (registers,
#: shared memory and spills per kernel); empty when the library was reused.
BUILD_LOG: list[str] = []


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the Hopper kernels need the CUDA "
                       "toolkit (nvcc on PATH or under /usr/local/cuda)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()


def build() -> Path:
    """Compile ``csrc/*.cu`` into ``libhsz.so`` (skipped when up to date)."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = _digest()
    lib = BUILD_DIR / "libhsz.so"
    stamp = BUILD_DIR / "libhsz.sha256"
    if (lib.exists() and stamp.exists()
            and stamp.read_text().strip() == digest):
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objs = [BUILD_DIR / (src.stem + ".o") for src in sources]
    procs = [
        (src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for src, obj in zip(sources, objs)
    ]
    BUILD_LOG.clear()
    failed = []
    for src, proc in procs:
        out, _ = proc.communicate()
        BUILD_LOG.extend(f"{src.name}: {line}" for line in out.splitlines()
                         if line.strip())
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(BUILD_LOG))
    tmp = BUILD_DIR / f"libhsz.{os.getpid()}.so"
    link = subprocess.run(
        [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
         *map(str, objs), "-o", str(tmp)],
        capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    tmp.replace(lib)
    stamp.write_text(digest)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def call(name: str, *args) -> None:
    """Call a launcher and raise on a nonzero CUDA error code."""
    with trace.span("hsz.kernel.launch"):
        err = getattr(library(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} failed with CUDA error {err}")
