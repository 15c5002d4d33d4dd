"""Kernel sites of the PyTorch port against the JAX reference's kernels.

On the CPU each wrapper in ``repro_torch.kernels`` runs its plain PyTorch
version; these tests hold those plain versions *bitwise* equal to the
reference's Pallas kernels (run in interpret mode, as the reference's own
tests run them on the CPU), for the unpack kernel and all four fused band
kernels with every ``what``.  The plain versions are what ``chip_smoke.py``
and the ``gpu``-marked tests below hold the Hopper kernels against on the
card; those tests skip when no CUDA device is present.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import by_name as jax_by_name
from repro.core import encode as jax_encode
from repro.kernels import bitpack as jax_bitpack
from repro.kernels import fused as jax_fk
from repro_torch import convert
from repro_torch import kernels as K
from repro_torch.core import encode
from repro_torch.kernels import bitpack, fused, ops

# field (397, 45) padded to (400, 48) by (16, 16) blocks: two Lorenzo bands
# and five block-mean bands in the reference kernels
SHAPE, BLOCK = (397, 45), (16, 16)
LZ_CASES = [(src, w) for src in ("payload", "plane")
            for w in fused.LORENZO_WHATS]
BM_CASES = [(src, w) for src in ("payload", "plane")
            for w in fused.BLOCKMEAN_WHATS]
# block -> a field shape that does not fill whole blocks (two or more bands
# in the reference kernels; tiles of the Hopper kernel straddle blocks)
BM_BLOCKS = {BLOCK: SHAPE, (8, 8): (397, 59), (4, 16): (301, 77),
             (5, 7): (398, 68)}
BM_BLOCK_CASES = [(b, src, w) for b in BM_BLOCKS for src, w in BM_CASES]
CARD_CASES = [(scheme, b) for scheme in ("hszp_nd", "hszx_nd")
              for b in BM_BLOCKS]


def _block_id(block) -> str:
    """'' for the default block (the ids it had before), else '5x7-'."""
    return "" if block == BLOCK else f"{block[0]}x{block[1]}-"


def _t(a: np.ndarray) -> torch.Tensor:
    """numpy -> torch, uint32 words as their int32 bit pattern."""
    a = np.array(a)  # a writable copy (jax hands out read-only buffers)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.as_tensor(a)


def _same(want, got, what):
    want = want if isinstance(want, (tuple, list)) else (want,)
    got = got if isinstance(got, (tuple, list)) else (got,)
    assert len(want) == len(got), what
    for w, g in zip(want, got):
        w = np.asarray(w)
        g = g.numpy()
        assert (w.shape, w.dtype) == (g.shape, g.dtype), (what, w.dtype, g.dtype)
        assert w.tobytes() == g.tobytes(), what


@functools.lru_cache(maxsize=None)
def _field(scheme: str, block: tuple = BLOCK):
    """The reference's Compressed + Encoded of one smooth 2-D field (of the
    shape :data:`BM_BLOCKS` gives ``block``)."""
    rng = np.random.default_rng(11)
    d = rng.normal(0, 1, BM_BLOCKS[block])
    d = (np.cumsum(np.cumsum(d, 0), 1) * 0.05).astype(np.float32)
    comp = jax_by_name(scheme, block)
    c = comp.compress(jnp.asarray(d), abs_eb=1e-2)
    e = comp.encode(c)
    assert 0 < e.bits < 32
    return c, e


# ===========================================================================
# unpack (Pallas row 1)
# ===========================================================================

@pytest.mark.parametrize("bits", list(range(0, 33)))
def test_unpack_matches_reference_kernel(bits):
    """Every width 0..32 at tail lengths that are not a multiple of the
    reference kernel's 4096-value grid step (``test_bitpack_tail_shapes``)."""
    n = (100, 4097, 5000)[bits % 3]
    rng = np.random.default_rng(bits * 101 + n)
    maxv = (1 << bits) - 1 if bits < 32 else 0xFFFFFFFF
    u = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    u &= np.uint32(maxv)
    words = np.asarray(jax_encode.pack_uniform(jnp.asarray(u), bits))
    want = jax_bitpack.unpack(jnp.asarray(words), n, bits, interpret=True)
    got = bitpack.unpack(_t(words), n, bits)
    _same(np.asarray(want).view(np.int32), got, f"unpack bits={bits}")
    np.testing.assert_array_equal(got.numpy().view(np.uint32), u)


#: (threads, 4-value steps per thread) of a span: the Hopper unpack
#: kernel's 256 threads x 2 steps (2048 values, 16 chunks of 128), and a
#: small tiling whose spans of one chunk put several spans in short inputs
UNPACK_TILINGS = ((256, 2), (16, 2))
#: words the kernel's buffers hold past a span's last word (PAD in
#: csrc/unpack.cu): the windows of the last values reach into them
UNPACK_PAD = 4
UNPACK_WIDTHS = (1, 2, 7, 13, 16, 17, 31)
UNPACK_NS = (1, 127, 128, 129, 128 * 37 - 1, 128 * 37 + 1, 2401 * 3599)
UNPACK_CASES = [(b, n) for b in UNPACK_WIDTHS for n in UNPACK_NS]
_U32 = 0xFFFFFFFF


def _funnel(lo: torch.Tensor, hi: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``__funnelshift_r(lo, hi, s)`` on uint32 values held in int64."""
    return (((hi << 32) | lo) >> (s & 31)) & _U32


def _pattern(u: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> their int32 bit patterns."""
    return torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32)


def _unpack_emulated(words: torch.Tensor, n: int, bits: int, tiling,
                     residuals: bool = False) -> torch.Tensor:
    """The Hopper unpack kernel's decomposition with torch int64 ops: spans
    of ``threads * 4 * steps`` values (whole chunks of 128 values = 4·bits
    words, so each span's words start 16-byte aligned) staged in a buffer
    of ``span_words + UNPACK_PAD`` words, of which those past the span or
    past the payload's last needed word hold stale bits (here a hash, so a
    value that read them would differ); each thread takes 4 consecutive
    values from a window of staged words (up to 16 bits one 64-bit window
    of two funnel shifts, above that a funnel shift each), then unzigzags
    them for ``residuals``; the values past ``n`` (the masked tail) are
    dropped."""
    threads, steps = tiling
    span = threads * 4 * steps
    assert span % 128 == 0
    sw = span // 32 * bits
    n_need = -(-n * bits // 32)
    w = words[:n_need].to(torch.int64) & _U32
    v0 = 4 * torch.arange(-(-n // 4), dtype=torch.int64)   # each thread's first
    s, off = v0 // span, (v0 % span) * bits

    def staged(k: torch.Tensor) -> torch.Tensor:
        assert int(k.max()) < sw + UNPACK_PAD
        idx = s * sw + k
        copied = (k < sw) & (idx < n_need)
        stale = (idx * 0x9E3779B1 + 0x7F4A7C15) & _U32
        return torch.where(copied, w[idx.clamp(max=n_need - 1)], stale)

    mask = (1 << bits) - 1
    if bits <= 16:
        k = off >> 5
        w0, w1, w2 = staged(k), staged(k + 1), staged(k + 2)
        x = (_funnel(w1, w2, off) << 32) | _funnel(w0, w1, off)
        u = [(x >> (e * bits)) & mask for e in range(4)]
    else:
        u = [_funnel(staged(o >> 5), staged((o >> 5) + 1), o) & mask
             for o in (off + e * bits for e in range(4))]
    out = _pattern(torch.stack(u, 1).reshape(-1)[:n])
    return encode.unzigzag(out) if residuals else out


@pytest.mark.parametrize("bits,n", UNPACK_CASES,
                         ids=[f"{b}bits-{n}" for b, n in UNPACK_CASES])
def test_unpack_spans_rebuild_values(bits, n):
    """The Hopper unpack kernel's spans, windows and masked tail, emulated
    at both tilings, equal the plain unpack and the reference's Pallas
    kernel (interpret mode) bitwise: zigzag values and, with the unzigzag
    fused in, residuals; also from a payload sliced one word in (an
    address that is not 16-byte aligned, so the kernel copies 4-byte
    pieces)."""
    rng = np.random.default_rng(bits * 7919 + n)
    u = torch.as_tensor(rng.integers(0, 1 << bits, n, dtype=np.int64)
                        .astype(np.int32))
    words = encode.pack_uniform(u, bits)
    want = jax_bitpack.unpack(jnp.asarray(words.numpy().view(np.uint32)), n,
                              bits, interpret=True)
    plain = bitpack.unpack_plain(words, n, bits)
    _same(np.asarray(want).view(np.int32), plain, "plain vs reference")
    assert torch.equal(plain, u)
    shifted = torch.empty((words.numel() + 1,), dtype=torch.int32)
    shifted[1:] = words
    sliced = shifted[1:]
    assert sliced.data_ptr() % 16 != 0 or words.numel() == 0
    for tiling in UNPACK_TILINGS:
        for src in (words, sliced):
            assert torch.equal(_unpack_emulated(src, n, bits, tiling), plain)
            assert torch.equal(_unpack_emulated(src, n, bits, tiling,
                                                residuals=True),
                               encode.unzigzag(plain))
    assert torch.equal(bitpack.unpack(sliced, n, bits), plain)
    assert torch.equal(bitpack.unpack_residuals(sliced, n, bits),
                       encode.unzigzag(plain))


@pytest.mark.parametrize("bits", [0, 1, 7, 13, 16, 17, 31, 32])
def test_unpack_residuals_matches_reference(bits):
    """``unpack_residuals`` (the decode's unpack, unzigzag fused in) on the
    CPU equals ``unzigzag`` of the reference's Pallas unpack bitwise, at
    every width class (0 and 32 are fast paths) and a ragged tail."""
    n = (100, 4097, 5000)[bits % 3]
    rng = np.random.default_rng(bits * 101 + n + 1)
    maxv = (1 << bits) - 1 if bits < 32 else 0xFFFFFFFF
    u = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    u &= np.uint32(maxv)
    words = np.asarray(jax_encode.pack_uniform(jnp.asarray(u), bits))
    want = jax_encode.unzigzag(
        jax_bitpack.unpack(jnp.asarray(words), n, bits, interpret=True))
    got = bitpack.unpack_residuals(_t(words), n, bits)
    _same(np.asarray(want).view(np.int32), got, f"residuals bits={bits}")
    assert torch.equal(got, bitpack.unpack_residuals_plain(_t(words), n, bits))


@pytest.mark.parametrize("scheme", ["hszp_nd", "hszx_nd"])
def test_decode_device_matches_reference(scheme):
    """``decode_device`` (now one ``unpack_residuals`` call) equals the
    reference's decode of the same container bitwise, and on the CPU
    launches nothing."""
    _, e = _field(scheme)
    arrays = {k: np.asarray(getattr(e, k)) for k in
              ("payload", "metadata", "bitwidths", "eps", "valid_counts")}
    meta = {"scheme": e.scheme.value, "shape": e.shape,
            "padded_shape": e.padded_shape, "block": e.block,
            "orig_dtype": np.dtype(e.orig_dtype).name, "bits": e.bits}
    te = convert.from_arrays("Encoded", arrays, meta, device="cpu")
    ops.reset_launches()
    got = encode.decode_device(te)
    assert set(ops.LAUNCHES.values()) == {0}
    want = jax_encode.decode_device(e)
    _same(np.asarray(want.residuals), got.residuals, f"{scheme} residuals")


# ===========================================================================
# fused band kernels (Pallas rows 2-6)
# ===========================================================================

@pytest.mark.parametrize("src,what", LZ_CASES, ids=[f"{s}-{w}" for s, w in LZ_CASES])
def test_lorenzo_matches_reference_kernel(src, what):
    c, e = _field("hszp_nd")
    if src == "payload":
        want = jax_fk.lorenzo_enc2d(e.payload, tuple(e.padded_shape), e.bits,
                                    what=what, interpret=True)
        got = fused.lorenzo_enc2d(_t(np.asarray(e.payload)),
                                  tuple(e.padded_shape), e.bits, what=what)
    else:
        want = jax_fk.lorenzo2d(c.residuals, what=what, interpret=True)
        got = fused.lorenzo2d(_t(np.asarray(c.residuals)), what=what)
    _same(want, got, f"lorenzo {src} {what}")


@pytest.mark.parametrize("block,src,what", BM_BLOCK_CASES,
                         ids=[f"{_block_id(b)}{s}-{w}" for b, s, w in BM_BLOCK_CASES])
def test_blockmean_matches_reference_kernel(block, src, what):
    c, e = _field("hszx_nd", block)
    meta = _t(np.asarray(c.metadata))
    if src == "payload":
        want = jax_fk.blockmean_enc2d(e.payload, e.metadata,
                                      tuple(e.padded_shape), block, e.bits,
                                      what=what, interpret=True)
        got = fused.blockmean_enc2d(_t(np.asarray(e.payload)), meta,
                                    tuple(e.padded_shape), block, e.bits,
                                    what=what)
    else:
        want = jax_fk.blockmean2d(c.residuals, c.metadata, block, what=what,
                                  interpret=True)
        got = fused.blockmean2d(_t(np.asarray(c.residuals)), meta, block,
                                what=what)
    _same(want, got, f"blockmean {block} {src} {what}")


@pytest.mark.parametrize("tile", [(4, 8), (32, 128), (7, 5)])
def test_lorenzo_tile_edges_compose_to_prefixes(tile):
    """The Hopper Lorenzo kernels cut the plane into tiles and start each
    tile's scans from edge prefixes (exclusive prefixes of the per-tile row
    and column sums).  Emulating that tiling here with the plain edge pass
    must rebuild ``cumsum(p, 1)`` and ``cumsum(p, 0)`` exactly, including
    int32 wrap-around."""
    rng = np.random.default_rng(sum(tile))
    p = torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, (45, 37), dtype=np.int64)
                        .astype(np.int32))
    rowsum, colsum = fused.lorenzo_edges_plain(p, tile)
    rowedge = fused.exclusive_prefix(rowsum, 1)
    coledge = fused.exclusive_prefix(colsum, 0)
    th, tw = tile
    d0 = torch.empty_like(p)
    d1 = torch.empty_like(p)
    for ti in range(coledge.shape[0]):
        for tj in range(rowedge.shape[1]):
            rs, cs = slice(ti * th, (ti + 1) * th), slice(tj * tw, (tj + 1) * tw)
            blk = p[rs, cs]
            d0[rs, cs] = (rowedge[rs, tj:tj + 1]
                          + torch.cumsum(blk, 1, dtype=torch.int32))
            d1[rs, cs] = (coledge[ti:ti + 1, cs]
                          + torch.cumsum(blk, 0, dtype=torch.int32))
    _same(torch.cumsum(p, 1, dtype=torch.int32).numpy(), d0, "D0")
    _same(torch.cumsum(p, 0, dtype=torch.int32).numpy(), d1, "D1")


#: (warps, rows per warp, lanes, columns per lane) -> plane shapes: the
#: Hopper Lorenzo kernels' 32 x 128 tile (8 warps of 4 rows, 32 lanes of 4
#: columns) at ragged tiles, a plane shorter than one tile row, and small
#: tilings with odd counts
LZ_TILINGS = {(8, 4, 32, 4): [(70, 300), (5, 300), (33, 129)],
              (3, 2, 4, 3): [(45, 37), (100, 37)],
              (2, 4, 5, 2): [(23, 41), (23, 341)]}
LZ_TILING_CASES = [(t, s) for t, shapes in LZ_TILINGS.items() for s in shapes]
#: column segments of the edge scan kernel (256 threads / 32 columns a
#: block); at 17 tile rows (100 x 37 above) segments of 3 rows leave the
#: last two empty, and 35 tile columns (23 x 341) take two row-scan steps
SCAN_SEGMENTS = 8


def _lorenzo_tiles_emulated(p: torch.Tensor, tiling):
    """The Hopper Lorenzo kernels' decomposition written with torch ops
    (int64 sums, read modulo 2**32 at the end): the edge pass's per-thread
    4 x 4 sums, warp reductions and cross-warp column sums (two threads a
    column, each over half the warps); the edge scan kernel that turns them
    into edge prefixes (a warp per row of row sums, 32 tile columns a step
    with a carry; per column of column sums, ``SCAN_SEGMENTS`` segments of
    ceil(n_rt / SCAN_SEGMENTS) tile rows, each started from the totals of
    the segments before it); and the stencil pass's in-thread prefixes,
    lane scans, cross-warp column scan and halo row and column.  Returns
    the edges and, per tile, D0 with its next row and D1 with its next
    column."""
    W, R, L, C = tiling
    th, tw = W * R, L * C
    n0, n1 = p.shape
    n_rt, n_ct = -(-n0 // th), -(-n1 // tw)
    z = torch.zeros((n_rt * th + 1, n_ct * tw + 1), dtype=torch.int64)
    z[:n0, :n1] = p
    rowsum = torch.zeros((n0, n_ct), dtype=torch.int64)
    colsum = torch.zeros((n_rt, n1), dtype=torch.int64)
    for ti in range(n_rt):
        for tj in range(n_ct):
            i0, j0 = ti * th, tj * tw
            blk = z[i0:i0 + th, j0:j0 + tw].reshape(W, R, L, C)
            rows = blk.sum(3).sum(2).reshape(th)      # in-thread, then warp
            wcol = blk.sum(1)                         # in-thread, (W, L, C)
            cols = (wcol[:W // 2].sum(0) + wcol[W // 2:].sum(0)).reshape(tw)
            r1, c1 = min(th, n0 - i0), min(tw, n1 - j0)
            rowsum[i0:i0 + r1, tj] = rows[:r1]
            colsum[ti, j0:j0 + c1] = cols[:c1]
    # edge scan, row sums: per row, a lane's inclusive scan over 32 tile
    # columns less its own value plus the carry of the steps before
    rowedge = torch.zeros_like(rowsum)
    carry = torch.zeros((n0, 1), dtype=torch.int64)
    for c0 in range(0, n_ct, 32):
        step = rowsum[:, c0:c0 + 32]
        rowedge[:, c0:c0 + 32] = carry + torch.cumsum(step, 1) - step
        carry = carry + step.sum(1, keepdim=True)
    # edge scan, column sums: segment g holds tile rows [lo, hi) with
    # lo = min(g * seg, n_rt), hi = min(lo + seg, n_rt); each sums its rows,
    # then runs down them from the sums of the segments before it
    seg = -(-n_rt // SCAN_SEGMENTS)
    bounds = [(min(g * seg, n_rt), min(min(g * seg, n_rt) + seg, n_rt))
              for g in range(SCAN_SEGMENTS)]
    totals = [colsum[lo:hi].sum(0) for lo, hi in bounds]
    coledge = torch.zeros_like(colsum)
    for g, (lo, hi) in enumerate(bounds):
        run = sum(totals[:g], torch.zeros(n1, dtype=torch.int64))
        for r in range(lo, hi):
            coledge[r] = run
            run = run + colsum[r]
    re = torch.zeros((n_rt * th + 1, n_ct), dtype=torch.int64)
    re[:n0] = rowedge
    ce = torch.zeros((n_rt, n_ct * tw + 1), dtype=torch.int64)
    ce[:, :n1] = coledge
    tiles = {}
    for ti in range(n_rt):
        for tj in range(n_ct):
            i0, j0 = ti * th, tj * tw
            blk = z[i0:i0 + th + 1, j0:j0 + tw + 1]
            P = blk[:th, :tw].reshape(W, R, L, C)
            # D0: in-thread prefix, lane scan of the lanes' totals, row edge
            s = torch.cumsum(P, 3)
            tot = s[..., -1]
            d0 = (s + (torch.cumsum(tot, 2) - tot)[..., None]
                  + re[i0:i0 + th, tj].reshape(W, R, 1, 1)).reshape(th, tw)
            h = torch.cumsum(blk[th, :tw].reshape(L, C), 1)   # the next row
            ht = h[:, -1]
            d0h = (h + (torch.cumsum(ht, 0) - ht)[:, None] + re[i0 + th, tj])
            # D1: in-thread prefix down the rows, scan over the warps'
            # column totals, column edge; lane L-1 also the next column
            c1 = torch.cumsum(P, 1)
            wt = c1[:, -1]
            base = (torch.cumsum(wt, 0) - wt
                    + ce[ti, j0:j0 + tw].reshape(L, C))
            d1 = (c1 + base[:, None]).reshape(th, tw)
            x = torch.cumsum(blk[:th, tw].reshape(W, R), 1)
            xt = x[:, -1]
            d1x = (x + (torch.cumsum(xt, 0) - xt + ce[ti, j0 + tw])[:, None])
            tiles[ti, tj] = (torch.cat([d0, d0h.reshape(1, tw)], 0),
                             torch.cat([d1, d1x.reshape(th, 1)], 1))
    return rowedge, coledge, tiles


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32)  # modulo 2**32, as the kernels' uint32 sums


@pytest.mark.parametrize("tiling,shape", LZ_TILING_CASES,
                         ids=[f"{'x'.join(map(str, t))}-{s[0]}x{s[1]}"
                              for t, s in LZ_TILING_CASES])
def test_lorenzo_register_tiles_rebuild_prefixes(tiling, shape):
    """The redesigned Hopper Lorenzo kernels: 4 x 4 register blocks, lane
    and cross-warp scans and the edge prefixes made on the card, emulated
    with torch ops on full-range int32 planes (so sums wrap).  The edges
    equal the plain edge pass, every tile's D0 / D1 (with its next row /
    column) equals cumsum(p, 1) / cumsum(p, 0) bitwise (0 outside the
    plane), and the planes built from the tiles equal ``lorenzo_core`` for
    every ``what``."""
    W, R, L, C = tiling
    th, tw = W * R, L * C
    rng = np.random.default_rng(shape[0] * shape[1] + th)
    p = torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, shape, dtype=np.int64)
                        .astype(np.int32))
    rowedge, coledge, tiles = _lorenzo_tiles_emulated(p, tiling)
    want_re, want_ce = fused.lorenzo_edge_prefixes_plain(p, (th, tw))
    _same(want_re.numpy(), _i32(rowedge), "row edge")
    _same(want_ce.numpy(), _i32(coledge), "column edge")
    n0, n1 = shape
    n_rt, n_ct = len({k[0] for k in tiles}), len({k[1] for k in tiles})
    z = torch.zeros((n_rt * th + 1, n_ct * tw + 1), dtype=torch.int32)
    z[:n0, :n1] = p
    d0_all = torch.cumsum(z, 1, dtype=torch.int32)
    d1_all = torch.cumsum(z, 0, dtype=torch.int32)
    d0_all[n0:] = 0  # D0 = 0 below the last row, D1 = 0 right of the last column
    d1_all[:, n1:] = 0
    planes = {w: [torch.empty((n_rt * th, n_ct * tw), dtype=torch.int32)
                  for _ in range(2 if w == "grad" else 1)]
              for w in fused.LORENZO_WHATS}
    for (ti, tj), (d0, d1) in tiles.items():
        i0, j0 = ti * th, tj * tw
        d0, d1 = _i32(d0), _i32(d1)
        _same(d0_all[i0:i0 + th + 1, j0:j0 + tw].numpy(), d0, f"D0 {ti},{tj}")
        _same(d1_all[i0:i0 + th, j0:j0 + tw + 1].numpy(), d1, f"D1 {ti},{tj}")
        d0c, d0n = d0[:-1], d0[1:]
        d1c, d1n = d1[:, :-1], d1[:, 1:]
        rs, cs = slice(i0, i0 + th), slice(j0, j0 + tw)
        planes["deriv0"][0][rs, cs] = d0n + d0c
        planes["deriv1"][0][rs, cs] = d1n + d1c
        planes["grad"][0][rs, cs] = d0n + d0c
        planes["grad"][1][rs, cs] = d1n + d1c
        planes["lap"][0][rs, cs] = (d0n - d0c) + (d1n - d1c)
    for what, outs in planes.items():
        want = fused.lorenzo_core(p, what)
        _same(want, tuple(o[:n0, :n1].contiguous() for o in outs),
              f"lorenzo {what} from register tiles")


def test_cpu_wrappers_launch_nothing():
    """On the CPU every wrapper takes its plain version: no counter moves."""
    c, e = _field("hszx_nd")
    ops.reset_launches()
    encode.unzigzag(bitpack.unpack(_t(np.asarray(e.payload)), 400 * 48, e.bits))
    bitpack.unpack_residuals(_t(np.asarray(e.payload)), 400 * 48, e.bits)
    fused.blockmean_enc2d(_t(np.asarray(e.payload)), _t(np.asarray(c.metadata)),
                          (400, 48), BLOCK, e.bits, what="grad")
    fused.lorenzo2d(_t(np.asarray(c.residuals)), what="lap")
    # the kernel entry point's six other wrappers
    x = _t(np.asarray(c.residuals)).to(torch.float32)
    p = K.quant_lorenzo2d(x, torch.tensor(0.5))
    K.pack(encode.zigzag(p.reshape(-1)), e.bits)
    K.block_stats(p.reshape(-1, BLOCK[0] * BLOCK[1]))
    K.grad2d(p, 1e-2)
    K.laplacian2d(p, 1e-2)
    K.prefix_stats2d(p)
    assert set(ops.LAUNCHES.values()) == {0}


def test_dispatch_rejects_mixed_devices_and_unknown_what():
    p = torch.zeros((16, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="one CUDA device or on the CPU"):
        fused.blockmean2d(p, torch.zeros((1, 1), dtype=torch.int32,
                                         device="meta"), BLOCK, what="grad")
    with pytest.raises(ValueError, match="what="):
        fused.lorenzo2d(p, what="lap_q")
    # the kernel entry point: an eps tensor takes part in the dispatch, and
    # one-tensor wrappers refuse a tensor on neither the CPU nor a card
    meta_eps = torch.tensor(1e-3, device="meta")
    x = torch.zeros((16, 16), dtype=torch.float32)
    for call in (lambda: K.quant_lorenzo2d(x, meta_eps),
                 lambda: K.grad2d(p, meta_eps),
                 lambda: K.laplacian2d(p, meta_eps),
                 lambda: K.pack(p.to("meta").reshape(-1), 5),
                 lambda: K.block_stats(p.to("meta")),
                 lambda: K.prefix_stats2d(p.to("meta"))):
        with pytest.raises(ValueError, match="one CUDA device or on the CPU"):
            call()


# ===========================================================================
# the Hopper kernels against their plain versions (card only)
# ===========================================================================

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [1, 5, 13, 31])
def test_unpack_kernel_matches_plain_on_card(bits):
    dev = _card()
    n = 1_000_003
    rng = np.random.default_rng(bits)
    u = rng.integers(0, 1 << bits, n, dtype=np.int64).astype(np.int32)
    words = encode.pack_uniform(torch.as_tensor(u, device=dev), bits)
    before = ops.LAUNCHES["unpack"]
    got = bitpack.unpack(words, n, bits)
    assert ops.LAUNCHES["unpack"] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, bitpack.unpack_plain(words, n, bits))


#: unpack on the card: the Ocean shape, the padded one, a short ragged
#: input, at several widths; each also from a payload sliced one word in
UNPACK_CARD_CASES = [(b, n) for b in (1, 7, 13, 16, 17, 31)
                     for n in (2400 * 3600, 2401 * 3599, 129)]


@pytest.mark.gpu
@pytest.mark.parametrize("bits,n", UNPACK_CARD_CASES,
                         ids=[f"{b}bits-{n}" for b, n in UNPACK_CARD_CASES])
def test_unpack_residuals_kernel_matches_plain_on_card(bits, n):
    """Both unpack instantiations against their plain versions, bitwise,
    aligned and sliced to a payload address that is not 16-byte aligned."""
    dev = _card()
    rng = np.random.default_rng(bits + n)
    u = torch.as_tensor(rng.integers(0, 1 << bits, n, dtype=np.int64)
                        .astype(np.int32), device=dev)
    words = encode.pack_uniform(u, bits)
    shifted = torch.empty((words.numel() + 1,), dtype=torch.int32, device=dev)
    shifted[1:] = words
    for src in (words, shifted[1:]):
        before = dict(ops.LAUNCHES)
        z = bitpack.unpack(src, n, bits)
        r = bitpack.unpack_residuals(src, n, bits)
        assert ops.LAUNCHES["unpack"] == before["unpack"] + 1
        assert ops.LAUNCHES["unpack.residuals"] == before["unpack.residuals"] + 1
        torch.cuda.synchronize()
        assert torch.equal(z, u)
        assert torch.equal(r, bitpack.unpack_residuals_plain(src, n, bits))


@pytest.mark.gpu
@pytest.mark.parametrize("scheme,block", CARD_CASES,
                         ids=[f"{s}" + (f"-{b[0]}x{b[1]}" if b != BLOCK else "")
                              for s, b in CARD_CASES])
def test_band_kernels_match_plain_on_card(scheme, block):
    dev = _card()
    c, e = _field(scheme, block)
    payload = _t(np.asarray(e.payload)).to(dev)
    plane = _t(np.asarray(c.residuals)).to(dev)
    meta = _t(np.asarray(c.metadata)).to(dev)
    shape = tuple(e.padded_shape)
    if scheme == "hszp_nd":
        for what in fused.LORENZO_WHATS:
            want = fused.lorenzo_core(plane, what)
            _same_card(want, fused.lorenzo2d(plane, what=what))
            _same_card(want, fused.lorenzo_enc2d(payload, shape, e.bits, what=what))
    else:
        for what in fused.BLOCKMEAN_WHATS:
            want = fused.blockmean_core(plane, meta, block, what)
            _same_card(want, fused.blockmean2d(plane, meta, block, what=what))
            _same_card(want, fused.blockmean_enc2d(payload, meta, shape, block,
                                                   e.bits, what=what))


#: the Lorenzo tiling check's planes: Ocean, ragged tiles, n1 % 4 != 0, a
#: tile row shorter than 32 rows
LZ_CARD_SHAPES = [(2400, 3600), (2401, 3599), (2400, 3598), (33, 129),
                  (31, 127), (5, 4099)]
LZ_CARD_CASES = [(s, b) for s in LZ_CARD_SHAPES for b in (1, 7, 13, 31)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,bits", LZ_CARD_CASES,
                         ids=[f"{s[0]}x{s[1]}-{b}bits" for s, b in LZ_CARD_CASES])
def test_lorenzo_kernels_match_plain_on_card(shape, bits):
    """Both Lorenzo passes, both sources and every ``what`` against their
    plain versions: a full-range int32 plane (sums wrap) and a payload packed
    at ``bits``."""
    dev = _card()
    rng = np.random.default_rng(shape[0] + bits)
    plane = torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, shape, dtype=np.int64)
                            .astype(np.int32), device=dev)
    lim = 1 << (bits - 1)
    p = torch.as_tensor(rng.integers(-lim, lim, shape, dtype=np.int64)
                        .astype(np.int32), device=dev)
    words = encode.pack_uniform(encode.zigzag(p.reshape(-1)), bits)
    tile = fused.lorenzo_tile()
    _same_card(fused.lorenzo_edge_prefixes_plain(plane, tile),
               fused.lorenzo_edges(plane, shape, 0, from_payload=False,
                                   site="lorenzo2d"))
    _same_card(fused.lorenzo_edge_prefixes_plain(p, tile),
               fused.lorenzo_edges(words, shape, bits, from_payload=True,
                                   site="lorenzo_enc2d"))
    for what in fused.LORENZO_WHATS:
        _same_card(fused.lorenzo_core(plane, what),
                   fused.lorenzo2d(plane, what=what))
        _same_card(fused.lorenzo_enc2d_plain(words, shape, bits, what=what),
                   fused.lorenzo_enc2d(words, shape, bits, what=what))


def _same_card(want, got):
    torch.cuda.synchronize()
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and torch.equal(w.view(torch.int32),
                                                  g.view(torch.int32))


#: region sub-planes of an Ocean field (2400 x 3600, blocks 16 x 16): a
#: transect's stage-② axis-0 band, one block, the hull of a window near the
#: origin, a transect's hull, a sub-basin's cover and hull, the far-corner
#: hull (the whole field); rows under the 32-row tile, planes narrower than
#: the 128-column tile; 16 x 16 blocks keep n1 % 4 == 0, so (48, 1810) at
#: blocks 16 x 5 adds a plane whose rows end off the 16-byte stores
REGION_PLANES = [(16, 3600), (16, 16), (32, 32), (1216, 3600), (1216, 1808),
                 (1808, 2704), (2400, 3600)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", REGION_PLANES + [(48, 1810)],
                         ids=[f"{a}x{b}" for a, b in REGION_PLANES + [(48, 1810)]])
def test_residual_plane_kernels_on_region_sub_planes(shape):
    """``lorenzo2d`` (both passes) and ``blockmean2d`` on the sub-planes a
    region plan gathers, every ``what``, bitwise against their plain
    versions: full-range int32 residuals (sums wrap) and random block
    means."""
    dev = _card()
    rng = np.random.default_rng(shape[0] * 7 + shape[1])
    plane = torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, shape, dtype=np.int64)
                            .astype(np.int32), device=dev)
    _same_card(fused.lorenzo_edge_prefixes_plain(plane, fused.lorenzo_tile()),
               fused.lorenzo_edges(plane, shape, 0, from_payload=False,
                                   site="lorenzo2d"))
    for what in fused.LORENZO_WHATS:
        _same_card(fused.lorenzo_core(plane, what),
                   fused.lorenzo2d(plane, what=what))
    block = BLOCK if shape[1] % BLOCK[1] == 0 else (16, 5)
    grid = (shape[0] // block[0], shape[1] // block[1])
    meta = torch.as_tensor(rng.integers(-2 ** 20, 2 ** 20, grid, dtype=np.int64)
                           .astype(np.int32), device=dev)
    for what in fused.BLOCKMEAN_WHATS:
        _same_card(fused.blockmean_core(plane, meta, block, what),
                   fused.blockmean2d(plane, meta, block, what=what))
