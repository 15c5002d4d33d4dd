"""Symbolic launch-grid specs for every CUDA kernel instantiation.

``repro_torch.audit.kernelspec`` proves, per instantiation and for every
grid shape the symbol bounds admit, that (a) every read and write of global
memory and of the staged shared-memory windows stays in bounds under its
guard, (b) the grid writes every output element exactly once — one block per
tile, grid-stride loops, persistent tile loops and split grids alike — and
(c) the shared memory fits the card.  Those proofs need a description of each
``__global__`` instantiation: its grid, how the grid walks its work, what one
block reads and writes, and its shared memory.  This module is that
description, kept next to the kernels; the audit cross-checks it against the
``csrc/*.cu`` sources (``__global__`` functions, launch sites, the
instantiation tables that ``hsz_func_attrs`` reads, ``constexpr`` values), and
``chip_smoke.py`` holds the library's own readings against it on the card.

Expression language: integer ``+ - *`` (and ``//`` between constants) over
the spec's symbols and the source's constants (:data:`CONSTANTS`).  A CUDA
tile is clipped by a guard (``if (i < n0)``), not sized to divide the array,
so a clipped tile count is a fact: ``n0 == (n_rt - 1)*TH + e0`` with
``1 <= e0 <= TH``.

* A :class:`Cover` is one dimension of a write (or of a reduction's reads):
  ``index = sum(stride * var)`` over its :class:`Digit`\\ s, innermost
  first, each ``var`` in ``[0, count)``; ``count=None`` is a loop that runs
  while the index is below the extent (a grid-stride or persistent loop).
  Exactly-once coverage is a mixed radix: the first stride is 1, each next
  stride is the previous stride times its count, and the top digit reaches
  the extent (``clip``: the kernel masks the overhang) or ends on it.
* A :class:`Branch` is a contiguous range of ``blockIdx.x`` (a split grid
  has two); its ``walk`` maps blocks and loop trips to work items exactly
  once, ``items`` decomposes an item into tile coordinates.
* A batched instantiation (the symbol ``B``: the fields of a
  ``batch_stack`` view, one launch for all of them) walks ``B`` times the
  items of one field, the field ``b`` as the items' top digit; each write
  names ``b`` in a leading batch dimension (``Write.lead``) before one
  field's dimensions, and its reads index the batch's arrays as one array
  of ``B`` times the rows (field ``b``'s row ``i`` at ``b*n0 + i``), the
  guard on a row the kernel's mask of ``i`` within its own field.
* A :class:`Read` is one access with a guard per dimension: ``"clip"`` (the
  kernel masks both ends), ``"<"`` (it masks the upper end), ``""`` (the
  proof must show the index in bounds), or a range restriction
  ``"sym >= expr"`` / ``"sym <= expr"`` under which the read happens.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

#: the ``constexpr`` values each source declares (the audit checks them
#: against the source, ``constexpr-drift``).
CONSTANTS: dict[str, dict[str, int]] = {
    "pack.cu": {"NT": 256},
    "quant_lorenzo.cu": {"NT": 256, "MAX_GRID_Y": 65535},
    "block_stats.cu": {"NT": 256, "WARPS": 8},
    "stencil_dq.cu": {"NT": 256, "MAX_GRID_Y": 65535, "MAX_GRID_Z": 65535},
    "unpack.cu": {"NT": 256, "STEPS": 2, "SPAN": 2048, "PAD": 4},
    "lorenzo_band.cu": {
        "TH": 32, "TW": 128, "NT": 256, "NWARP": 8, "ROWS": 4, "LD": 136,
        "LDT": 132, "EW": 168, "SCOLS": 32, "TGROUPS": 4, "SSEG": 8,
        "SCHUNK": 16, "PS_T": 1188, "PS_RED": 32, "PS_BUF": 4520,
        "PS_HEAD": 1220, "PS_SMEM": 41040},
    "blockmean_band.cu": {
        "TH": 32, "TW": 128, "NT": 256, "NWARP": 8, "ROWS": 4, "HR": 34,
        "HC": 130, "LD": 136, "TILE": 4624},
}

#: a block's static shared memory, and its static plus dynamic shared
#: memory, on an H100 (232 448 bytes is the opt-in limit per block).
STATIC_SMEM_LIMIT = 48 * 1024
SMEM_OPTIN_LIMIT = 232448


@dataclass(frozen=True)
class Digit:
    var: str
    stride: str
    count: str | None


@dataclass(frozen=True)
class Cover:
    digits: tuple[Digit, ...]
    extent: str
    clip: bool = True


@dataclass(frozen=True)
class Write:
    """One output array: a :class:`Cover` per dimension (row-major).
    ``threads`` names the block's threads at this store, ``fixed`` the ones
    an equality guard pins (``lane == k``), ``alloc`` the allocation's
    extents where the kernel writes only a window of it, ``per`` whether
    each work item or each block writes it."""

    array: str
    dims: tuple[Cover, ...]
    threads: tuple[str, ...] = ("warp", "lane")
    fixed: tuple[str, ...] = ()
    alloc: tuple[str, ...] | None = None
    per: str = "item"  # "block": once per block, after its loop
    lead: tuple[Cover, ...] = ()  # batch dims before one field's ``dims``


@dataclass(frozen=True)
class Read:
    array: str
    index: tuple[str, ...]
    extent: tuple[str, ...]
    guard: tuple[str, ...] = ()
    shared: bool = False


@dataclass(frozen=True)
class Sum:
    """A reduction whose operand must be read exactly once per element."""

    array: str
    dims: tuple[Cover, ...]


@dataclass(frozen=True)
class Branch:
    """``blockIdx.x`` in ``[start, start + count)``.  ``walk`` reaches the
    work items (named ``item`` when they need no decomposition), ``items``
    decomposes an item into coordinates."""

    start: str
    count: str
    walk: Cover
    items: Cover | None = None
    item: str = ""
    writes: tuple[Write, ...] = ()
    reads: tuple[Read, ...] = ()
    sums: tuple[Sum, ...] = ()


@dataclass(frozen=True)
class KernelSpec:
    """Symbolic contract of one ``__global__`` instantiation.

    ``name``     — the instantiation as the source's table names it.
    ``source`` / ``function`` / ``launch`` — the ``csrc`` file, the
    ``__global__`` function and the host function that launches it.
    ``grid``     — blocks along x; ``branches`` split them.
    ``bounds``   — inclusive symbol ranges in declaration order (a bound
    may reference only symbols declared after it; digit variables are
    bounded by their counts and come first).
    ``facts``    — ``"sym == expr"`` rewrites.
    ``params``   — every non-digit symbol as a Python expression over the
    launcher's arguments, for the concrete checks.
    ``smem_static`` / ``smem_dynamic`` — bytes, over the constants
    (dynamic at its largest: 31-bit payloads for the unpack).
    ``smem_arrays`` — the ``__shared__`` arrays the instantiation uses,
    where the compiler drops the ones a template argument leaves untouched
    (empty: all of them).
    ``staging``  — which staged-payload lemma its shared reads rest on.
    """

    name: str
    source: str
    function: str
    launch: str
    replaces: str
    grid: str
    bounds: dict[str, tuple[str, str | None]]
    branches: tuple[Branch, ...]
    facts: tuple[str, ...] = ()
    params: dict[str, str] = field(default_factory=dict)
    smem_static: str = "0"
    smem_dynamic: str = "0"
    smem_arrays: tuple[str, ...] = ()
    staging: str = ""
    notes: str = ""


def _d(*digits) -> tuple[Digit, ...]:
    return tuple(Digit(*d) for d in digits)


_PALLAS = "src/repro/kernels/"

# -- shared pieces ------------------------------------------------------------

#: a plane cut in TH x TW tiles, tiles row-major (tile_of / tile_origin)
_TILE_FACTS = ("n0 == (n_rt - 1)*TH + e0", "n1 == (n_ct - 1)*TW + e1",
               "n_tiles == n_rt*n_ct")
_TILE_BOUNDS = {"n_rt": ("1", None), "n_ct": ("1", None),
                "e0": ("1", "TH"), "e1": ("1", "TW")}
_TILE_PARAMS = {"n_rt": "cdiv(n0, TH)", "n_ct": "cdiv(n1, TW)",
                "n_tiles": "cdiv(n0, TH) * cdiv(n1, TW)",
                "e0": "n0 - (cdiv(n0, TH) - 1) * TH",
                "e1": "n1 - (cdiv(n1, TW) - 1) * TW"}
_COORDS = Cover(_d(("tj", "1", "n_ct"), ("ti", "n_ct", "n_rt")), "n_tiles",
                clip=False)
#: a persistent grid over the tiles: as many blocks as fit, at most one a
#: tile (grid = min(n_tiles, sms * per_sm))
_PERSISTENT = Cover(_d(("bx", "1", "G"), ("it", "G", None)), "n_tiles")
_PERSISTENT_BOUNDS = {"G": ("1", "n_tiles")}
#: the same over a batch of B planes: the tiles of field b follow field
#: b - 1's (tile_of / tile_origin), and a write's batch dimension is b
_BCOORDS = Cover(_d(("tj", "1", "n_ct"), ("ti", "n_ct", "n_rt"),
                    ("b", "n_tiles", "B")), "B*n_tiles", clip=False)
_BPERSISTENT = Cover(_d(("bx", "1", "G"), ("it", "G", None)), "B*n_tiles")
_BPERSISTENT_BOUNDS = {"G": ("1", "B*n_tiles"), "B": ("1", None)}
_BPERSISTENT_PARAM = {"G": "min(B * cdiv(n0, TH) * cdiv(n1, TW), sms * per_sm)"}
_BATCH = Cover(_d(("b", "1", "B")), "B", clip=False)
#: one output row of a tile per (k, warp), 4 columns per (e, lane)
_TILE_ROWS = Cover(_d(("k", "1", "ROWS"), ("warp", "ROWS", "NWARP"),
                      ("ti", "TH", "n_rt")), "n0")
_TILE_COLS = Cover(_d(("e", "1", "4"), ("lane", "4", "32"),
                      ("tj", "TW", "n_ct")), "n1")


def _plane_write(array: str) -> Write:
    """One ``(n0, n1)`` output plane of each field of the batch."""
    return Write(array, (_TILE_ROWS, _TILE_COLS), lead=(_BATCH,))


# -- pack.cu -------------------------------------------------------------------

_PACK = KernelSpec(
    name="pack_kernel", source="pack.cu", function="pack_kernel",
    launch="hsz_pack", replaces=_PALLAS + "bitpack.py:67",
    grid="G",
    bounds={"i": ("0", "n - 1"), "G": ("1", None), "n": ("1", None),
            "n_words": ("1", None)},
    branches=(Branch(
        "0", "G", Cover(_d(("bx", "1", "G")), "G", clip=False),
        writes=(Write("words", (Cover(_d(("tx", "1", "NT"), ("bx", "NT", "G"),
                                          ("k", "NT*G", None)), "n_words"),),
                      threads=("tx",)),),
        reads=(Read("u", ("i",), ("n",)),)),),
    params={"G": "min(cdiv(n_words, NT), 65535 * 32)"},
    notes="grid-stride loop over words; value i of a word is clamped to "
          "n - 1 (last = min(last, n - 1))")

# -- quant_lorenzo.cu ------------------------------------------------------------

_GRID_Y_BOUNDS = {"gy": ("1", "MAX_GRID_Y")}

_QUANT = KernelSpec(
    name="quant_lorenzo2d_kernel", source="quant_lorenzo.cu",
    function="quant_lorenzo2d_kernel", launch="hsz_quant_lorenzo2d",
    replaces=_PALLAS + "quant_lorenzo.py:54",
    grid="gx*gy",
    bounds={"i": ("0", "n0 - 1"), "j": ("0", "n1 - 1"), **_GRID_Y_BOUNDS,
            "gx": ("1", None), "n0": ("1", None), "e1": ("1", "NT")},
    facts=("n1 == (gx - 1)*NT + e1",),
    branches=(Branch(
        "0", "gx*gy", Cover(_d(("bx", "1", "gx"), ("by", "gx", "gy")), "gx*gy",
                            clip=False),
        writes=(Write("p", (Cover(_d(("by", "1", "gy"), ("k", "gy", None)), "n0"),
                            Cover(_d(("tx", "1", "NT"), ("bx", "NT", "gx")), "n1")),
                      threads=("tx",)),),
        reads=(Read("x", ("i", "j"), ("n0", "n1")),
               Read("x", ("i - 1", "j"), ("n0", "n1"), ("i >= 1", "")),
               Read("x", ("i", "j - 1"), ("n0", "n1"), ("", "j >= 1")),
               Read("x", ("i - 1", "j - 1"), ("n0", "n1"),
                    ("i >= 1", "j >= 1")),
               Read("inv", ("0",), ("1",)))),),
    params={"gx": "cdiv(n1, NT)", "gy": "min(n0, MAX_GRID_Y)",
            "e1": "n1 - (cdiv(n1, NT) - 1) * NT"},
    notes="rows past MAX_GRID_Y take the grid-stride loop over blockIdx.y")

# -- block_stats.cu ---------------------------------------------------------------

_BLOCK_STATS = KernelSpec(
    name="block_stats_kernel", source="block_stats.cu",
    function="block_stats_kernel", launch="hsz_block_stats",
    replaces=_PALLAS + "block_stats.py:37",
    grid="G",
    bounds={"row": ("0", "n_blocks - 1"), "kk": ("0", "s_len - 1"),
            "G": ("1", None), "n_blocks": ("1", None), "s_len": ("1", None)},
    branches=(Branch(
        "0", "G", Cover(_d(("bx", "1", "G")), "G", clip=False),
        writes=tuple(
            Write(a, (Cover(_d(("warp", "1", "WARPS"), ("bx", "WARPS", "G"),
                                ("k", "WARPS*G", None)), "n_blocks"),),
                  fixed=("lane",))
            for a in ("means", "maxu")),
        reads=(Read("q", ("row", "kk"), ("n_blocks", "s_len")),),
        sums=(Sum("q", (Cover(_d(("lane", "1", "32"), ("m", "32", None)),
                              "s_len"),)),)),),
    params={"G": "min(cdiv(n_blocks, WARPS), 65535 * 32)"},
    notes="a warp per row, grid-stride over rows; lane 0 writes")

# -- stencil_dq.cu -----------------------------------------------------------------

def _stencil_dq(name: str, launch: str, outs: tuple[str, ...],
                replaces: str, reads: tuple[Read, ...],
                batched: bool = False) -> KernelSpec:
    """``batched``: blockIdx.z walks the B planes of a batch (field b's
    plane at ``b*n0*n1``, its interior planes at ``b*m0*m1``)."""
    walk = _d(("bx", "1", "gx"), ("by", "gx", "gy"))
    if batched:
        walk += _d(("b", "gx*gy", "B"),)
    grid = "gx*gy*B" if batched else "gx*gy"
    return KernelSpec(
        name=name, source="stencil_dq.cu", function=name, launch=launch,
        replaces=replaces, grid=grid,
        bounds={"i": ("0", "n0 - 3"), "j": ("0", "n1 - 3"), **_GRID_Y_BOUNDS,
                "gx": ("1", None), "n0": ("3", None), "e1": ("1", "NT"),
                "n1": ("3", None),
                **({"B": ("1", "MAX_GRID_Z")} if batched else {})},
        facts=("m0 == n0 - 2", "m1 == n1 - 2",
               "n1 == (gx - 1)*NT + e1 + 2"),
        branches=(Branch(
            "0", grid, Cover(walk, grid, clip=False),
            writes=tuple(
                Write(a, (Cover(_d(("by", "1", "gy"), ("k", "gy", None)), "m0"),
                          Cover(_d(("tx", "1", "NT"), ("bx", "NT", "gx")),
                                "m1")),
                      threads=("tx",), lead=(_BATCH,) if batched else ())
                for a in outs),
            reads=reads),),
        params={"gx": "cdiv(n1 - 2, NT)", "gy": "min(n0 - 2, MAX_GRID_Y)",
                "m0": "n0 - 2", "m1": "n1 - 2",
                "e1": "n1 - 2 - (cdiv(n1 - 2, NT) - 1) * NT"},
        notes="interior (n0 - 2, n1 - 2); rows past MAX_GRID_Y take the "
              "grid-stride loop over blockIdx.y"
              + ("; blockIdx.z the field of a batch" if batched else ""))


def _nswe(row0: str, rows: str) -> tuple[Read, ...]:
    """The north, south, west and east reads of interior element (i, j),
    in rows ``row0 + ...`` of an array of ``rows`` rows."""
    return (Read("q", (f"{row0}i", "j + 1"), (rows, "n1")),
            Read("q", (f"{row0}i + 2", "j + 1"), (rows, "n1")),
            Read("q", (f"{row0}i + 1", "j"), (rows, "n1")),
            Read("q", (f"{row0}i + 1", "j + 2"), (rows, "n1")))


#: grad2d reads the batch's planes as one array of B*n0 rows (field b's
#: row r at b*n0 + r)
_GRAD2D = _stencil_dq("grad2d_kernel", "hsz_grad2d", ("d0", "d1"),
                      _PALLAS + "stencil_dq.py:66", _nswe("b*n0 + ", "B*n0"),
                      batched=True)
_LAP2D = _stencil_dq("laplacian2d_kernel", "hsz_laplacian2d", ("out",),
                     _PALLAS + "stencil_dq.py:85",
                     _nswe("", "n0") + (Read("q", ("i + 1", "j + 1"),
                                             ("n0", "n1")),))

# -- unpack.cu ---------------------------------------------------------------------


def _unpack(unzigzag: bool) -> KernelSpec:
    """``unpack_kernel<true>`` (the decode) takes a batch of B payloads, one
    span loop over the B x n_spans spans; ``<false>`` takes one."""
    flag = "true" if unzigzag else "false"
    batch = "B*" if unzigzag else ""
    out_dims = (Cover(_d(("e", "1", "4"), ("tx", "4", "NT"),
                         ("step", "4*NT", "STEPS"),
                         ("ls" if unzigzag else "s", "SPAN", "n_spans")), "n"),)
    return KernelSpec(
        name=f"unpack_kernel<{flag}>", source="unpack.cu",
        function="unpack_kernel", launch="launch",
        replaces=_PALLAS + "bitpack.py:94",
        grid="G",
        bounds={"q": ("0", "SPAN//32*bits + PAD - 1"), "buf": ("0", "1"),
                "G": ("1", f"{batch}n_spans"), "n_spans": ("1", None),
                "en": ("1", "SPAN"), "bits": ("1", "31"),
                **({"B": ("1", None)} if unzigzag else {})},
        facts=("n == (n_spans - 1)*SPAN + en",),
        branches=(Branch(
            "0", "G", Cover(_d(("bx", "1", "G"), ("it", "G", None)),
                            f"{batch}n_spans"),
            # span s of the batch is span s % n_spans of field s / n_spans
            items=(Cover(_d(("ls", "1", "n_spans"), ("b", "n_spans", "B")),
                         "B*n_spans", clip=False) if unzigzag else None),
            item="" if unzigzag else "s",
            writes=(Write("out", out_dims, threads=("tx",),
                          lead=(_BATCH,) if unzigzag else ()),),
            # the prologue copies span blockIdx.x before the loop tests it:
            # the grid has at most one block a span; word q of buffer buf
            # (take4's reads stay below a buffer: check_unpack_lemma)
            reads=(Read("span", ("bx",), (f"{batch}n_spans",)),
                   Read("S", ("buf*(SPAN//32*bits + PAD) + q",),
                        ("2*(SPAN//32*bits + PAD)",), shared=True))),),
        params={"n_spans": "cdiv(n, SPAN)",
                "G": f"min({batch}cdiv(n, SPAN), sms * per_sm)",
                "en": "n - (cdiv(n, SPAN) - 1) * SPAN"},
        smem_dynamic="2*(SPAN//32*31 + PAD)*4",
        staging="unpack",
        notes="persistent grid over spans of SPAN values (of every field of "
              "a batch); dynamic shared memory 2 * buffer_words(bits) words "
              "(its largest at 31 bits)")


# -- lorenzo_band.cu ---------------------------------------------------------------

def _lz_tile_reads(nr: str, nc: str, payload: bool) -> tuple[Read, ...]:
    """The staged window of a Lorenzo tile: rows i0 .. i0 + nr - 1 and
    columns j0 .. j0 + nc - 1 of the input (of field b's plane), masked at
    the plane's edge."""
    if payload:
        src = Read("words", ("w",), ("B*n_words",), ("<",))
    else:
        src = Read("p", ("b*n0 + ti*TH + r", "tj*TW + c"), ("B*n0", "n1"),
                   ("<", "<"))
    return (src,
            Read("R", ("r", "c"), (nr, "LD"), shared=True))


def _lz_bounds(**extra) -> dict:
    return {"r": ("0", "TH - 1"), "c": ("0", "TW - 1"), "w": ("0", None),
            **_TILE_BOUNDS, **extra}


def _edges(payload: bool) -> KernelSpec:
    flag = "true" if payload else "false"
    return KernelSpec(
        name=f"lorenzo_edges_kernel<{flag}>", source="lorenzo_band.cu",
        function="lorenzo_edges_kernel", launch="launch_edges",
        replaces=_PALLAS + ("fused.py:288" if payload else "fused.py:250"),
        grid="G",
        bounds=_lz_bounds(c=("0", "TW - 1"), wr=("0", "NWARP - 1"),
                          **_BPERSISTENT_BOUNDS),
        facts=_TILE_FACTS,
        branches=(Branch(
            "0", "G", _BPERSISTENT, _BCOORDS,
            writes=(
                Write("rowedge", (_TILE_ROWS,
                                  Cover(_d(("tj", "1", "n_ct")), "n_ct",
                                        clip=False)),
                      fixed=("lane",), lead=(_BATCH,)),
                Write("coledge", (Cover(_d(("ti", "1", "n_rt")), "n_rt",
                                        clip=False),
                                  Cover(_d(("c", "1", "TW"), ("tj", "TW", "n_ct")),
                                        "n1")),
                      threads=("c", "h"), fixed=("h",), lead=(_BATCH,))),
            reads=_lz_tile_reads("TH", "TW", payload) + (
                Read("tile", ("bx",), ("B*n_tiles",)),
                Read("T", ("wr", "c"), ("NWARP", "LDT"), shared=True))),),
        params={**_TILE_PARAMS, **_BPERSISTENT_PARAM},
        smem_static="4*(2*TH*LD + NWARP*LDT)",
        staging="lorenzo" if payload else "",
        notes="persistent grid over the tiles of every field of a batch; "
              "the next tile's copies run under the current one; lane k "
              "writes row k of its warp's rows")


def _scan(corners: bool) -> KernelSpec:
    """The edge scan, batched: rbf row blocks and n_cb column blocks per
    field, every field's row blocks first.  The corner scan
    (``prefix_stats2d``) also writes each field's corner sums."""
    name = "corner_scan_kernel" if corners else "lorenzo_scan_kernel"
    col_writes = [
        Write("coledge", (Cover(_d(("s", "1", "slen"), ("warp", "slen", "SSEG")),
                                "n_rt"),
                          Cover(_d(("lane", "1", "SCOLS"), ("cb", "SCOLS", "n_cb")),
                                "n1")), lead=(_BATCH,))]
    if corners:
        col_writes.append(Write(
            "corners", (Cover(_d(("s", "1", "slen"), ("warp", "slen", "SSEG")),
                              "n_rt"),
                        Cover(_d(("cb", "1", "n_cb")), "n_cb", clip=False)),
            fixed=("lane",), lead=(_BATCH,)))
    return KernelSpec(
        name=name, source="lorenzo_band.cu", function=name,
        launch="launch_edges",
        replaces=_PALLAS + ("prefix_stats.py:56" if corners
                            else "fused.py:288"),
        grid="n_rb + B*n_cb",
        bounds={"g": ("0", "SSEG - 1"), "rbf": ("1", None),
                "n_cb": ("1", None), "n_ct": ("1", None),
                "slen": ("1", None), "e_rb": ("1", "NWARP"),
                "e_cb": ("1", "SCOLS"), "e_len": ("1", "SSEG"),
                "B": ("1", None)},
        facts=("n_rb == B*rbf", "n0 == (rbf - 1)*NWARP + e_rb",
               "n1 == (n_cb - 1)*SCOLS + e_cb",
               "n_rt == (slen - 1)*SSEG + e_len"),
        branches=(
            # blocks below n_rb: a warp per row of rowedge, 32 tiles a step
            Branch("0", "n_rb",
                   Cover(_d(("rb", "1", "rbf"), ("b", "rbf", "B")), "n_rb",
                         clip=False),
                   writes=(Write("rowedge", (
                       Cover(_d(("warp", "1", "NWARP"), ("rb", "NWARP", "rbf")),
                             "n0"),
                       Cover(_d(("lane", "1", "32"), ("c0", "32", None)),
                             "n_ct")), lead=(_BATCH,)),)),
            # the others: 32 columns of coledge, a segment of tile rows a warp
            Branch("n_rb", "B*n_cb",
                   Cover(_d(("cb", "1", "n_cb"), ("b", "n_cb", "B")), "B*n_cb",
                         clip=False),
                   writes=tuple(col_writes),
                   reads=(Read("S", ("g", "lane"), ("SSEG", "SCOLS"),
                               shared=True),))),
        params={"n_rb": "B * cdiv(n0, NWARP)", "rbf": "cdiv(n0, NWARP)",
                "n_cb": "cdiv(n1, SCOLS)",
                "n_rt": "cdiv(n0, TH)", "n_ct": "cdiv(n1, TW)",
                "slen": "cdiv(cdiv(n0, TH), SSEG)",
                "e_rb": "n0 - (cdiv(n0, NWARP) - 1) * NWARP",
                "e_cb": "n1 - (cdiv(n1, SCOLS) - 1) * SCOLS",
                "e_len": "cdiv(n0, TH) - (cdiv(cdiv(n0, TH), SSEG) - 1) * SSEG"},
        smem_static="4*SSEG*SCOLS",
        notes="split grid: row blocks, then column blocks (of every field "
              "of a batch); the prefixes are written in place")


_WHATS_LZ = ("DERIV0", "DERIV1", "GRAD", "LAP")


def _stencil(payload: bool, what: str) -> KernelSpec:
    flag = "true" if payload else "false"
    outs = ("out0", "out1") if what == "GRAD" else ("out0",)
    return KernelSpec(
        name=f"lorenzo_stencil_kernel<{flag}, {what}>", source="lorenzo_band.cu",
        function="lorenzo_stencil_kernel", launch="launch_stencil",
        replaces=_PALLAS + ("fused.py:302" if payload else "fused.py:250"),
        grid="B*n_tiles",
        bounds=_lz_bounds(r=("0", "TH"), c=("0", "TW"), rk=("0", "TH - 1"),
                          wr=("0", "NWARP - 1"), B=("1", None)),
        facts=_TILE_FACTS,
        branches=(Branch(
            "0", "B*n_tiles", Cover(_d(("bx", "1", "B*n_tiles")), "B*n_tiles",
                                    clip=False),
            _BCOORDS,
            writes=tuple(_plane_write(a) for a in outs),
            reads=_lz_tile_reads("TH + 1", "TW + 1", payload) + (
                Read("coledge", ("b*n_rt + ti", "tj*TW + c"), ("B*n_rt", "n1"),
                     ("", "<")),
                Read("rowedge", ("b*n0 + ti*TH + r", "tj"), ("B*n0", "n_ct"),
                     ("<", "")),
                Read("E", ("c",), ("EW",), shared=True),
                Read("E", ("132 + r",), ("EW",), shared=True),
                Read("T", ("wr", "c"), ("NWARP", "LDT"), shared=True),
                Read("H", ("wr + 1", "c"), ("NWARP + 1", "TW"),
                     ("", "c <= TW - 1"), shared=True))),),
        params=dict(_TILE_PARAMS),
        # D1 alone uses the warps' column totals T, D0 alone the rows H
        smem_static="4*((TH + 1)*LD + EW"
                    + ("" if what == "DERIV0" else " + NWARP*LDT")
                    + ("" if what == "DERIV1" else " + (NWARP + 1)*TW") + ")",
        smem_arrays=("R", "E") + (() if what == "DERIV0" else ("T",))
        + (() if what == "DERIV1" else ("H",)),
        staging="lorenzo" if payload else "",
        notes="one block per tile of every field of a batch; the window is "
              "the tile, the next row and the next column")


def _stats_tile(wide: bool) -> KernelSpec:
    flag = "true" if wide else "false"
    # corner sums left of tile (ti, tj): groups cg < TGROUPS*tj, 4 loads a
    # lane in the narrow kernel, a loop past them in the wide one
    groups = (Cover(_d(("lane", "1", "32"), ("m", "32", None)), "TGROUPS*tj")
              if wide else
              Cover(_d(("lane", "1", "32"), ("m", "32", "4")), "TGROUPS*tj"))
    return KernelSpec(
        name=f"prefix_stats_tile_kernel<{flag}>", source="lorenzo_band.cu",
        function="prefix_stats_tile_kernel", launch="hsz_prefix_stats",
        replaces=_PALLAS + "prefix_stats.py:56",
        grid="G",
        bounds=_lz_bounds(cg=("0", "TGROUPS*tj - 1"), wr=("0", "NWARP"),
                          ch=("0", "1"), **_BPERSISTENT_BOUNDS,
                          n_cb=("TGROUPS*n_ct - TGROUPS + 1", None),
                          **({} if wide else {"n_ct": ("1", "33")})),
        facts=_TILE_FACTS,
        branches=(Branch(
            "0", "G", _BPERSISTENT, _BCOORDS,
            # each block's pair of every field: its tiles' sums, or zeros
            # for the fields its tiles skip
            writes=(Write("partials", (Cover(_d(("bx", "1", "G")), "G", clip=False),
                                       Cover(_d(("ch", "1", "2")), "2",
                                             clip=False)),
                          threads=("t",), fixed=("t",), alloc=("G", "2"),
                          per="block", lead=(_BATCH,)),),
            reads=_lz_tile_reads("TH", "TW", False) + (
                Read("tile", ("bx",), ("B*n_tiles",)),
                Read("coledge", ("b*n_rt + ti", "tj*TW + c"), ("B*n_rt", "n1"),
                     ("", "<")),
                Read("rowedge", ("b*n0 + ti*TH + r", "tj"), ("B*n0", "n_ct"),
                     ("<", "")),
                Read("corners", ("b*n_rt + ti", "cg"), ("B*n_rt", "n_cb")),
                Read("T", ("wr", "c"), ("NWARP + 1", "LDT"), shared=True),
                Read("red", ("wr",), ("2*NWARP",), ("wr <= NWARP - 1",),
                     shared=True)),
            sums=(Sum("corners", (groups,)),)),),
        params={**_TILE_PARAMS, **_BPERSISTENT_PARAM,
                "n_cb": "cdiv(n1, SCOLS)"},
        smem_dynamic="PS_SMEM",
        notes="persistent grid over the tiles of every field of a batch; "
              "one (sum q, sum q^2) pair a block and field; the narrow "
              "kernel is launched only where no tile lies right of 128 "
              "corner sums (wide_stats: TGROUPS*(n_ct - 1) <= 128)")


_REDUCE = KernelSpec(
    name="prefix_stats_reduce_kernel", source="lorenzo_band.cu",
    function="prefix_stats_reduce_kernel", launch="hsz_prefix_stats",
    replaces=_PALLAS + "prefix_stats.py:56",
    grid="B",
    bounds={"kp": ("0", "n_pairs - 1"), "ch": ("0", "1"),
            "wr": ("0", "NT//32 - 1"), "G": ("1", "B*n_tiles"),
            "n_tiles": ("1", None), "B": ("1", None)},
    facts=("n_pairs == G",),
    branches=(Branch(
        "0", "B", Cover(_d(("b", "1", "B")), "B", clip=False),
        writes=(Write("out", (Cover(_d(("ch", "1", "2")), "2", clip=False),),
                      threads=("t",), fixed=("t",), lead=(_BATCH,)),),
        reads=(Read("partials", ("b*G + kp", "ch"), ("B*G", "2")),
               Read("red", ("ch", "wr"), ("2", "NT//32"), shared=True)),
        sums=(Sum("partials", (Cover(_d(("t", "1", "NT"), ("it", "NT", None)),
                                     "n_pairs"),)),)),),
    params={"n_tiles": "cdiv(n0, TH) * cdiv(n1, TW)",
            "G": "min(B * cdiv(n0, TH) * cdiv(n1, TW), sms * per_sm)",
            "n_pairs": "min(B * cdiv(n0, TH) * cdiv(n1, TW), sms * per_sm)"},
    smem_static="2*(NT//32)*8",
    notes="one block a field, launched early by programmatic dependent "
          "launch (griddepcontrol.wait before it reads the partials); "
          "n_pairs is the tile pass's grid")

# -- blockmean_band.cu ----------------------------------------------------------------

_WHATS_BM = ("DERIV0", "DERIV1", "GRAD", "LAP_P", "LAP_Q")


def _blockmean(payload: bool, what: str) -> KernelSpec:
    flag = "true" if payload else "false"
    outs = ("out0", "out1") if what == "GRAD" else ("out0",)
    tiles = "2" if what == "LAP_P" else "1"
    src = (Read("words", ("w",), ("B*n_words",), ("<",)) if payload else
           Read("p", ("b*n0 + ti*TH - 1 + r", "tj*TW - 1 + c"),
                ("B*n0", "n1"), ("clip", "clip")))
    return KernelSpec(
        name=f"blockmean_kernel<{flag}, {what}>", source="blockmean_band.cu",
        function="blockmean_kernel", launch="launch",
        replaces=_PALLAS + ("fused.py:464" if payload else "fused.py:412"),
        grid="G",
        bounds={"r": ("0", "HR - 1"), "c": ("0", "HC - 1"),
                "rw": ("0", "TH + 1"), "bi": ("0", "g0 - 1"),
                "bj": ("0", "ng1 - 1"), "w": ("0", None),
                **_BPERSISTENT_BOUNDS, **_TILE_BOUNDS,
                "g0": ("1", None), "ng1": ("1", None)},
        facts=_TILE_FACTS,
        branches=(Branch(
            "0", "G", _BPERSISTENT, _BCOORDS,
            writes=tuple(_plane_write(a) for a in outs),
            reads=(src,
                   Read("tile", ("bx",), ("B*n_tiles",)),
                   Read("meta", ("b*g0 + bi", "bj"), ("B*g0", "ng1")),
                   Read("R", ("r", "3 + c"), ("HR", "LD"), shared=True),
                   Read("S", ("rw", "3 + c"), ("HR", "LD"), shared=True))),),
        params={**_TILE_PARAMS, **_BPERSISTENT_PARAM, "g0": "n0 // b0",
                "ng1": "n1 // b1"},
        smem_dynamic=f"4*(TILE*({tiles} + 2) + HC + HR)",
        staging="blockmean" if payload else "",
        notes="persistent grid over the tiles of every field of a batch; "
              "the tile and its halo staged once; block rows / columns of "
              "halo rows / columns divided once per tile")


#: every instantiation, in the order of the sources' tables
#: (``hsz_func_attrs``'s kernel ids).
KERNEL_SPECS: tuple[KernelSpec, ...] = (
    _PACK, _QUANT, _BLOCK_STATS, _GRAD2D, _LAP2D,
    _unpack(False), _unpack(True),
    _edges(False), _edges(True), _scan(False), _scan(True),
    *(_stencil(p, w) for p in (False, True) for w in _WHATS_LZ),
    _stats_tile(False), _stats_tile(True), _REDUCE,
    *(_blockmean(p, w) for p in (False, True) for w in _WHATS_BM),
)

KERNEL_IDS: tuple[str, ...] = tuple(s.name for s in KERNEL_SPECS)


def spec(name: str) -> KernelSpec:
    """The spec of one instantiation by its table name."""
    for s in KERNEL_SPECS:
        if s.name == name:
            return s
    raise KeyError(f"no kernel spec named {name!r}")


def evaluate(expr: str, source: str, env: dict | None = None) -> int:
    """An expression of the spec language (plus ``cdiv`` / ``min`` / ``max``)
    as an integer, with the source's constants and ``env``."""
    scope = {"cdiv": lambda a, b: -(-a // b), "min": min, "max": max,
             **CONSTANTS[source], **(env or {})}
    return int(eval(expr, {"__builtins__": {}}, scope))  # noqa: S307


def smem_bytes(s: KernelSpec) -> tuple[int, int]:
    """(static, dynamic) shared memory of one instantiation, in bytes."""
    return evaluate(s.smem_static, s.source), evaluate(s.smem_dynamic, s.source)


def func_attrs(name: str) -> tuple[int, int, int, int]:
    """(static shared memory, dynamic shared memory, registers per thread,
    resident blocks per SM) of one instantiation, read from the library
    (``hsz_func_attrs``)."""
    from . import build

    vals = [ctypes.c_int() for _ in range(4)]
    build.call("hsz_func_attrs", KERNEL_IDS.index(name),
               *(ctypes.addressof(v) for v in vals))
    return tuple(v.value for v in vals)


def smem_optin() -> int:
    """The card's shared memory per block with the opt-in, in bytes."""
    from . import build

    v = ctypes.c_int()
    build.call("hsz_smem_optin", ctypes.addressof(v))
    return v.value
