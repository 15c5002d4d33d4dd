"""The PyTorch port's kernel entry point against the JAX reference's.

``repro_torch.kernels`` exports the seven wrappers of the reference's
``repro.kernels`` (``quant_lorenzo2d``, ``pack``, ``unpack``, ``grad2d``,
``laplacian2d``, ``block_stats``, ``prefix_stats2d``) and ``kernels.ref``
binds their plain versions under the reference's oracle names.  On the CPU
every wrapper runs its plain version; these tests mirror
``tests/test_kernels.py`` on that path, against the reference's Pallas
kernels (interpret mode, as its own tests run them on the CPU) and its
``ref.py`` oracles, on the same seeded numpy inputs.  Tolerances: bitwise
everywhere, except the f32 sums of ``prefix_stats2d`` (rtol 1e-5, as the
reference's ``test_prefix_stats`` allows: the sums run in another order).

The port drops the reference's TPU tile contract, so the Ocean-like odd
shapes that the reference kernels refuse are held against its oracles.
The ``gpu``-marked tests hold each Hopper kernel against its plain version
on the card and skip without one.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, strategies as st
except ImportError:  # optional dep: property-based tests self-skip
    from repro.testing import given, st

from repro.core import blocking as jax_blocking
from repro.core import decorrelate as jax_decorrelate
from repro.core import encode as jax_encode
from repro.core import hszp_nd as jax_hszp_nd
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import kernels as K
from repro_torch.core import blocking, decorrelate, encode, hszp_nd
from repro_torch.kernels import fused, ops, prefix_stats, ref, stencil_dq

#: the reference's XLA packer, jitted per (n, bits) so the width sweeps stay
#: cheap; ``ops.pack`` (interpret mode) runs only at a handful of widths
_jax_pack = jax.jit(jax_encode.pack_uniform, static_argnums=1)


def _t(a) -> torch.Tensor:
    """numpy / jax -> torch, uint32 as its int32 bit pattern."""
    a = np.array(a)  # a writable copy (jax hands out read-only buffers)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.as_tensor(a)


def _same(want, got, what=""):
    """Bitwise equality of reference arrays and port tensors (uint32 compared
    as its int32 bit pattern)."""
    want = want if isinstance(want, (tuple, list)) else (want,)
    got = got if isinstance(got, (tuple, list)) else (got,)
    assert len(want) == len(got), what
    for w, g in zip(want, got):
        w = np.array(w)
        if w.dtype == np.uint32:
            w = w.view(np.int32)
        g = g.numpy()
        assert (w.shape, w.dtype) == (g.shape, g.dtype), (what, w.dtype, g.dtype)
        assert w.tobytes() == g.tobytes(), what


def _close(want, got, what=""):
    for w, g in zip(want, got, strict=True):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5, err_msg=what)


def _values(bits: int, n: int, seed: int) -> np.ndarray:
    """``n`` uint32 values below ``2^bits`` (the reference tests' inputs)."""
    rng = np.random.default_rng(seed)
    if bits == 0:
        return np.zeros((n,), np.uint32)
    maxv = (1 << bits) - 1 if bits < 32 else 0xFFFFFFFF
    return rng.integers(0, 2 ** 31, n, dtype=np.uint32) & np.uint32(maxv)


# ===========================================================================
# quant_lorenzo2d (Pallas row 8)
# ===========================================================================

@pytest.mark.parametrize("shape", [(128, 256), (256, 512), (384, 256)])
@pytest.mark.parametrize("eps", [1e-1, 1e-3])
def test_quant_lorenzo2d(shape, eps):
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(0, 3, shape).astype(np.float32)
    want = jops.quant_lorenzo2d(jnp.asarray(x), jnp.float32(eps))
    _same(want, K.quant_lorenzo2d(_t(x), torch.tensor(eps, dtype=torch.float32)))
    _same(jref.quant_lorenzo2d(jnp.asarray(x), jnp.float32(eps)),
          ref.quant_lorenzo2d(_t(x), eps))


def test_kernel_pipeline_consistency(field_2d):
    """quant_lorenzo2d reproduces the compressor's residuals, in both
    packages, and the two packages agree."""
    x = np.ascontiguousarray(field_2d[:128, :64])
    eps = np.float32(1e-3)
    got = K.quant_lorenzo2d(_t(x), torch.tensor(eps))
    c = hszp_nd.compress(x, eps=torch.tensor(eps), device="cpu")
    assert torch.equal(got, blocking.crop(c.residuals, x.shape))
    jc = jax_hszp_nd.compress(jnp.asarray(x), eps=jnp.float32(eps))
    _same(jax_blocking.crop(jc.residuals, x.shape), got)
    _same(jops.quant_lorenzo2d(jnp.asarray(x), jnp.float32(eps)), got)


# ===========================================================================
# pack / unpack (Pallas rows 7 and 1)
# ===========================================================================

@pytest.mark.parametrize("bits", list(range(0, 33)))
def test_bitpack_all_widths(bits):
    n = 8192
    u = _values(bits, n, bits)
    packed = K.pack(_t(u), bits)
    _same(_jax_pack(jnp.asarray(u), bits), packed, f"pack bits={bits}")
    _same(u, K.unpack(packed, n, bits), f"unpack bits={bits}")
    assert torch.equal(ref.pack_uniform(_t(u), bits), packed)


@pytest.mark.parametrize("bits", [1, 7, 13, 31])
def test_pack_matches_reference_kernel(bits):
    """The reference's Pallas pack itself (interpret mode), a handful of widths."""
    u = _values(bits, 8192 + 100, bits + 7)
    _same(jops.pack(jnp.asarray(u), bits), K.pack(_t(u), bits), f"bits={bits}")


@pytest.mark.parametrize("bits", list(range(1, 33)))
@pytest.mark.parametrize("n", [100, 4097, 5000])
def test_bitpack_tail_shapes(bits, n):
    """Word-layout parity with the reference's XLA packer at lengths that
    are not a multiple of its kernel's 4096-value grid step."""
    u = _values(bits, n, bits * 101 + n)
    packed = K.pack(_t(u), bits)
    _same(_jax_pack(jnp.asarray(u), bits), packed, f"pack bits={bits} n={n}")
    _same(u, K.unpack(packed, n, bits), f"unpack bits={bits} n={n}")
    _same(u, encode.unpack_uniform(packed, n, bits))


@pytest.mark.parametrize("bits", [1, 6, 17, 31])
def test_pack_masks_out_of_width_values(bits):
    """Values with bits above the width: each is masked to ``bits``, as the
    reference's bit matrix and both XLA packers do."""
    rng = np.random.default_rng(bits)
    u = rng.integers(0, 2 ** 32, 5000, dtype=np.uint64).astype(np.uint32)
    got = K.pack(_t(u), bits)
    _same(_jax_pack(jnp.asarray(u), bits), got, f"bits={bits}")
    _same(jops.pack(jnp.asarray(u), bits), got, f"bits={bits}")
    _same(u & np.uint32((1 << bits) - 1), K.unpack(got, 5000, bits))


@given(st.integers(1, 31), st.integers(1, 4))
def test_bitpack_roundtrip_property(bits, blocks):
    rng = np.random.default_rng(bits * 131 + blocks)
    n = 4096 * blocks
    u = rng.integers(0, 1 << bits, n, dtype=np.uint32)
    _same(u, K.unpack(K.pack(_t(u), bits), n, bits))


# ===========================================================================
# grad2d / laplacian2d (Pallas rows 10 and 11)
# ===========================================================================

@pytest.mark.parametrize("shape", [(130, 258), (258, 514)])
def test_stencils(shape):
    rng = np.random.default_rng(7)
    q = rng.integers(-10000, 10000, shape, dtype=np.int32)
    eps = np.float32(5e-3)
    jq, tq = jnp.asarray(q), _t(q)
    _same(jops.grad2d(jq, jnp.float32(eps)), K.grad2d(tq, torch.tensor(eps)))
    _same(jref.stencil_dq_grad2d(jq, jnp.float32(eps)),
          ref.stencil_dq_grad2d(tq, eps))
    _same(jops.laplacian2d(jq, jnp.float32(eps)),
          K.laplacian2d(tq, torch.tensor(eps)))
    _same(jref.stencil_dq_laplacian2d(jq, jnp.float32(eps)),
          ref.stencil_dq_laplacian2d(tq, eps))


def test_stencil_int_planes_wrap_like_int32():
    """The integer planes the kernels emit wrap modulo 2^32, like the
    reference's int32 stencils, at the extremes of the range."""
    rng = np.random.default_rng(5)
    q = rng.integers(-2 ** 31, 2 ** 31, (37, 29), dtype=np.int64).astype(np.int32)
    d0, d1 = stencil_dq.grad2d_int_plain(_t(q))
    q64 = q.astype(np.int64)
    want0 = (q64[2:, 1:-1] - q64[:-2, 1:-1]).astype(np.int32)
    want1 = (q64[1:-1, 2:] - q64[1:-1, :-2]).astype(np.int32)
    _same((want0, want1), (d0, d1))
    lap = (q64[2:, 1:-1] + q64[:-2, 1:-1] + q64[1:-1, 2:] + q64[1:-1, :-2]
           - 4 * q64[1:-1, 1:-1]).astype(np.int32)
    _same(lap, stencil_dq.laplacian2d_int_plain(_t(q)))


# ===========================================================================
# block_stats (Pallas row 9)
# ===========================================================================

@pytest.mark.parametrize("nb,s", [(256, 128), (512, 256), (1024, 64)])
def test_block_stats(nb, s):
    rng = np.random.default_rng(nb)
    qb = rng.integers(-50000, 50000, (nb, s), dtype=np.int32)
    want = jops.block_stats(jnp.asarray(qb))
    _same(want, K.block_stats(_t(qb)))
    _same(jref.block_stats(jnp.asarray(qb)), ref.block_stats(_t(qb)))


@pytest.mark.parametrize("block", [(4, 4), (8, 8), (8, 16)])
def test_block_stats_signed_parity_with_core(block):
    """The per-block rounded mean equals the stage-① metadata the compressor
    stores (``decorrelate.block_means``) in both packages on signed data:
    floor((2s + c) / (2c)), where flooring (not truncating) negative sums is
    the parity trap."""
    rng = np.random.default_rng(11)
    q = rng.integers(-50000, 50000, (64, 48), dtype=np.int32)
    blocked = blocking.to_blocked(_t(q), block)
    g0, g1, b0, b1 = blocked.shape
    rows = blocked.reshape(g0 * g1, b0 * b1).contiguous()
    gm, gx = K.block_stats(rows)
    assert torch.equal(gm.reshape(g0, g1), decorrelate.block_means(_t(q), block))
    _same(jax_decorrelate.block_means(jnp.asarray(q), block), gm.reshape(g0, g1))
    u = rows.numpy()
    zig = ((u << 1) ^ (u >> 31)).astype(np.uint32)
    _same(zig.max(axis=1), gx)


# ===========================================================================
# prefix_stats2d (Pallas row 12)
# ===========================================================================

@pytest.mark.parametrize("shape", [(128, 256), (256, 384)])
def test_prefix_stats(shape):
    rng = np.random.default_rng(3)
    p = rng.integers(-8, 8, shape, dtype=np.int32)
    got = K.prefix_stats2d(_t(p))
    _close(jops.prefix_stats2d(jnp.asarray(p)), got)
    _close(jref.prefix_stats2d(jnp.asarray(p)), ref.prefix_stats2d(_t(p)))


@pytest.mark.parametrize("tile", [(4, 8), (32, 128), (7, 5)])
def test_prefix_stats_tiles_rebuild_q(tile):
    """The Hopper stats pass rebuilds q tile by tile from the edge pass: the
    row-prefix edge starts each tile row's scan, and the row of q above the
    tile — the tile's corner (Σp above and left of it, from the corner sums
    of the column edge) plus a scan of its column edge — starts each
    column's.  Emulating that tiling with the plain edge pass must give
    ``cumsum(cumsum(p, 0), 1)`` exactly, int32 wrap-around included."""
    rng = np.random.default_rng(sum(tile))
    p = _t(rng.integers(-2 ** 31, 2 ** 31, (45, 37), dtype=np.int64)
           .astype(np.int32))
    th, tw = tile
    rowedge, coledge = fused.lorenzo_edge_prefixes_plain(p, tile)
    q = torch.empty_like(p)
    for ti in range(coledge.shape[0]):
        for tj in range(rowedge.shape[1]):
            rs, cs = slice(ti * th, (ti + 1) * th), slice(tj * tw, (tj + 1) * tw)
            corner = coledge[ti, :tj * tw].sum(dtype=torch.int64).to(torch.int32)
            top = corner + torch.cumsum(coledge[ti, cs], 0, dtype=torch.int32)
            d0 = rowedge[rs, tj:tj + 1] + torch.cumsum(p[rs, cs], 1,
                                                       dtype=torch.int32)
            q[rs, cs] = top + torch.cumsum(d0, 0, dtype=torch.int32)
    want = torch.cumsum(torch.cumsum(p, 0, dtype=torch.int32), 1,
                        dtype=torch.int32)
    assert torch.equal(q, want)


#: the stats pass's register tile: 8 warps of 4 rows, 32 lanes of 4 columns
PS_TILING = (8, 4, 32, 4)
#: columns per corner sum (the edge prefix kernel's column block)
PS_CORNER_COLS = 32
#: ragged tiles, a plane shorter than one tile row, many tile columns, odd
#: sizes, whole tiles; wider than 33 tiles (4224 columns), where a tile's
#: corner takes more than one step of 128 corner sums
PS_SHAPES = [(33, 129), (31, 127), (5, 4099), (97, 300), (64, 256),
             (33, 4225), (64, 8300)]


def _butterfly(x: np.ndarray) -> np.ndarray:
    """A warp's xor-shuffle sum (offsets 16, 8, 4, 2, 1) along the last axis
    (32 lanes), in that order, every lane ending with the same value."""
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        x = x + x[..., lanes ^ off]
    return x


def _corner_of(row: torch.Tensor, tj: int, groups: int) -> int:
    """The stats pass's corner of tile column ``tj`` from its tile row's
    corner sums ``row``: lane l adds groups l + 32·m (m < 4) below
    ``groups·tj``, then (the kernel's wide instantiation, launched where a
    tile lies right of the first 128 groups) groups 128 + l, 160 + l, ...
    below it; then a warp sum.  Not wrapped."""
    n = groups * tj
    r = row.to(torch.int64).numpy()
    lane = np.arange(32)
    lanes = np.zeros(32, dtype=np.int64)
    for m in range(4):
        b = lane + 32 * m
        lanes += np.where(b < n, r[np.minimum(b, len(r) - 1)], 0)
    for b0 in range(128, n, 32):
        b = b0 + lane
        lanes += np.where(b < n, r[np.minimum(b, len(r) - 1)], 0)
    return int(lanes.sum())


def _prefix_stats_emulated(p: torch.Tensor, grid: int):
    """The redesigned stats pass with torch and numpy ops: the corner sums
    that the edge prefix kernel writes (the column edge summed over each 32
    columns by a warp reduction), then per tile the register tile — D0 by an
    in-thread prefix, a lane scan of the lanes' totals and the row edge; the
    row of q above the tile as the corner plus an in-thread prefix and a
    lane scan of the column edge; q by an in-thread prefix of D0 down the
    warp's rows plus the totals of the warps above, biased by 2**31 and
    turned into a double by one f64 subtraction.  A persistent grid of
    ``grid`` blocks takes tiles b, b + grid, ...; each thread adds its valid
    q and q² to f64 sums (tile by tile, row by row, column by column); at
    the end a warp butterfly and the 8 warps in order give one pair per
    block; the reduction kernel: 256 threads each over blocks t, t + 256,
    ..., a butterfly, the 8 warps in order, one rounding to f32.  Returns
    (Σq, Σq²) and q."""
    W, R, L, C = PS_TILING
    th, tw = W * R, L * C
    n0, n1 = p.shape
    n_rt, n_ct = -(-n0 // th), -(-n1 // tw)
    rowedge, coledge = fused.lorenzo_edge_prefixes_plain(p, (th, tw))
    corners = prefix_stats.corner_sums_plain(coledge, PS_CORNER_COLS)
    z = torch.zeros((n_rt * th, n_ct * tw), dtype=torch.int64)
    z[:n0, :n1] = p
    re = torch.zeros((n_rt * th, n_ct), dtype=torch.int64)
    re[:n0] = rowedge
    ce = torch.zeros((n_rt, n_ct * tw), dtype=torch.int64)
    ce[:, :n1] = coledge
    valid = torch.zeros((n_rt * th, n_ct * tw), dtype=torch.bool)
    valid[:n0, :n1] = True
    q_all = torch.zeros((n_rt * th, n_ct * tw), dtype=torch.int64)
    groups = tw // PS_CORNER_COLS
    n_tiles = n_rt * n_ct
    grid = min(grid, n_tiles)
    partials = np.zeros((grid, 2))
    for b in range(grid):
        s1 = np.zeros((W, L))
        s2 = np.zeros((W, L))
        for tile in range(b, n_tiles, grid):
            ti, tj = divmod(tile, n_ct)
            i0, j0 = ti * th, tj * tw
            P = z[i0:i0 + th, j0:j0 + tw].reshape(W, R, L, C)
            s = torch.cumsum(P, 3)
            tot = s[..., -1]
            d0 = (s + (torch.cumsum(tot, 2) - tot)[..., None]
                  + re[i0:i0 + th, tj].reshape(W, R, 1, 1))
            d0 = torch.cumsum(d0, 1)                    # down the warp's rows
            wt = d0[:, -1]                              # (W, L, C) to T
            corner = _corner_of(corners[ti], tj, groups)
            pre = torch.cumsum(ce[ti, j0:j0 + tw].reshape(L, C), 1)
            pt = pre[:, -1]
            top = pre + (torch.cumsum(pt, 0) - pt)[:, None] + corner
            base = top + torch.cumsum(wt, 0) - wt       # warps above
            q = _i32(d0 + base[:, None])                # modulo 2**32
            q_all[i0:i0 + th, j0:j0 + tw] = q.reshape(th, tw)
            # q + 2**31 as the low word of a double 2**52 + qb, less 2**52 +
            # 2**31: the kernel's exact conversion
            qb = ((d0 + base[:, None] + 2 ** 31) % 2 ** 32).numpy()
            qd = (qb.astype(np.float64) + 2.0 ** 52) - (2.0 ** 52 + 2.0 ** 31)
            ok = valid[i0:i0 + th, j0:j0 + tw].reshape(W, R, L, C).numpy()
            for k in range(R):
                for e in range(C):
                    x = np.where(ok[:, k, :, e], qd[:, k, :, e], 0.0)
                    s1 = s1 + x
                    s2 = s2 + x * x   # the kernel's fma; exact at these |q|
        s1, s2 = _butterfly(s1)[:, 0], _butterfly(s2)[:, 0]
        x1 = x2 = 0.0
        for w in range(W):
            x1, x2 = x1 + s1[w], x2 + s2[w]
        partials[b] = (x1, x2)
    acc = np.zeros((2, 256))
    for t in range(0, grid, 256):
        chunk = partials[t:t + 256]
        acc[:, :len(chunk)] += chunk.T
    red = _butterfly(acc.reshape(2, 8, 32))[..., 0]
    out = [0.0, 0.0]
    for w in range(8):
        out = [out[0] + red[0, w], out[1] + red[1, w]]
    return (torch.tensor(np.float32(out[0])), torch.tensor(np.float32(out[1])),
            q_all[:n0, :n1])


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2**32, as the kernels' uint32 sums wrap."""
    return ((x + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


#: persistent grids of the emulation: fewer blocks than tiles (several
#: tiles a block, some blocks one more than others) and one block a tile
PS_GRIDS = (3, 660)
PS_CASES = [(s, g) for s in PS_SHAPES for g in PS_GRIDS]


@pytest.mark.parametrize("shape,grid", PS_CASES,
                         ids=[f"{a}x{b}-grid{g}" for (a, b), g in PS_CASES])
def test_prefix_stats_register_tiles(shape, grid):
    """The redesigned stats pass, emulated: q from the register tile equals
    ``cumsum(cumsum(p, 0), 1)`` bitwise; the sums equal the plain f32
    version and the reference (its kernel where it takes the shape, its
    oracle where not) within rtol 1e-5, and equal the exact int64 sums
    rounded once to f32 bitwise (|q| < 2**26, totals below 2**53)."""
    rng = np.random.default_rng(shape[0] * shape[1])
    p_np = rng.integers(-8, 8, shape, dtype=np.int32)
    p = _t(p_np)
    s1, s2, q = _prefix_stats_emulated(p, grid)
    want_q = torch.cumsum(torch.cumsum(p, 0, dtype=torch.int32), 1,
                          dtype=torch.int32)
    assert torch.equal(_i32(q), want_q)
    q64 = want_q.to(torch.int64)
    assert int(q64.abs().max()) < 2 ** 26
    exact = (int(q64.sum()), int((q64 * q64).sum()))
    assert max(map(abs, exact)) < 2 ** 53
    for got, ex in zip((s1, s2), exact):
        assert got.numpy().tobytes() == np.float32(np.float64(ex)).tobytes()
    _close(prefix_stats.prefix_stats2d_plain(p), (s1, s2))
    rows = min(64, shape[0])
    if shape[0] % rows == 0:
        _close(jops.prefix_stats2d(jnp.asarray(p_np)), (s1, s2))
    else:
        with pytest.raises(ValueError, match="multiple"):
            jops.prefix_stats2d(jnp.asarray(p_np))
        _close(jref.prefix_stats2d(jnp.asarray(p_np)), (s1, s2))


def test_corner_sums_make_tile_corners():
    """Σ of the corner sums left of a tile, ``corners[ti, :4·tj]``, is the sum
    of p above and left of the tile, int32 wrap-around included."""
    rng = np.random.default_rng(7)
    p = _t(rng.integers(-2 ** 31, 2 ** 31, (100, 700), dtype=np.int64)
           .astype(np.int32))
    th, tw = 32, 128  # the kernels' tile
    _, coledge = fused.lorenzo_edge_prefixes_plain(p, (th, tw))
    corners = prefix_stats.corner_sums_plain(coledge, PS_CORNER_COLS)
    assert corners.shape == (4, -(-700 // PS_CORNER_COLS))
    groups = tw // PS_CORNER_COLS
    for ti in range(4):
        for tj in range(-(-700 // tw)):
            want = p[:ti * th, :tj * tw].sum(dtype=torch.int64)
            got = corners[ti, :groups * tj].sum(dtype=torch.int64)
            assert _i32(got) == _i32(want)


@pytest.mark.parametrize("n1", [4224, 4225, 8300, 17000])
def test_corner_of_reads_every_group(n1):
    """The stats pass's corner read (128 corner sums a step, 4 a lane) gives
    Σp above and left of every tile, on planes of up to 133 tile columns
    (several steps), int32 wrap-around included."""
    rng = np.random.default_rng(n1)
    p = _t(rng.integers(-2 ** 31, 2 ** 31, (70, n1), dtype=np.int64)
           .astype(np.int32))
    th, tw = 32, 128  # the kernels' tile
    _, coledge = fused.lorenzo_edge_prefixes_plain(p, (th, tw))
    corners = prefix_stats.corner_sums_plain(coledge, PS_CORNER_COLS)
    csum = torch.cumsum(torch.cumsum(p.to(torch.int64), 0), 1)
    for ti in range(1, coledge.shape[0]):
        for tj in range(1, -(-n1 // tw)):
            want = csum[ti * th - 1, tj * tw - 1]
            got = _corner_of(corners[ti], tj, tw // PS_CORNER_COLS)
            assert _i32(torch.tensor(got)) == _i32(want)


# ===========================================================================
# shapes the reference kernels refuse (no TPU tile contract in the port)
# ===========================================================================

#: Ocean's 2400 x 3600 cut by ten, plus one row and less one column
ODD = (241, 359)


def test_reference_kernels_refuse_odd_shapes():
    """Why the odd-shape tests below compare with the oracles only."""
    with pytest.raises(ValueError, match="multiple"):
        jops.quant_lorenzo2d(jnp.zeros(ODD, jnp.float32), jnp.float32(1e-3))
    with pytest.raises(ValueError, match="multiple"):
        jops.prefix_stats2d(jnp.zeros(ODD, jnp.int32))


@functools.lru_cache(maxsize=None)
def _odd_field() -> np.ndarray:
    rng = np.random.default_rng(2400)
    d = rng.normal(0, 1, ODD)
    return (np.cumsum(np.cumsum(d, 0), 1) * 0.05).astype(np.float32)


def test_odd_shape_quant_lorenzo2d():
    x, eps = _odd_field(), np.float32(2e-3)
    _same(jref.quant_lorenzo2d(jnp.asarray(x), jnp.float32(eps)),
          K.quant_lorenzo2d(_t(x), torch.tensor(eps)))


def test_odd_shape_stencils():
    q = np.round(_odd_field() * 250).astype(np.int32)
    eps = np.float32(2e-3)
    _same(jref.stencil_dq_grad2d(jnp.asarray(q), jnp.float32(eps)),
          K.grad2d(_t(q), torch.tensor(eps)))
    _same(jref.stencil_dq_laplacian2d(jnp.asarray(q), jnp.float32(eps)),
          K.laplacian2d(_t(q), torch.tensor(eps)))


@pytest.mark.parametrize("nb,s", [(3375, 256), (1000, 37)])
def test_odd_shape_block_stats(nb, s):
    """Ocean / 10 has 3375 blocks of 16 x 16: not a multiple of 256 rows."""
    rng = np.random.default_rng(nb + s)
    qb = rng.integers(-50000, 50000, (nb, s), dtype=np.int32)
    _same(jref.block_stats(jnp.asarray(qb)), K.block_stats(_t(qb)))


def test_odd_shape_prefix_stats():
    p = np.asarray(jref.quant_lorenzo2d(jnp.asarray(_odd_field()),
                                        jnp.float32(2e-3)))
    _close(jref.prefix_stats2d(jnp.asarray(p)), K.prefix_stats2d(_t(p)))


def test_odd_shape_pack():
    n = ODD[0] * ODD[1]
    u = _values(11, n, 11)
    _same(_jax_pack(jnp.asarray(u), 11), K.pack(_t(u), 11))


def test_ref_binds_every_reference_oracle():
    """``kernels.ref`` has the reference oracles' names, each a plain version."""
    names = {k for k, v in vars(jref).items()
             if callable(v) and not k.startswith("_")
             and getattr(v, "__module__", "") == jref.__name__}
    assert names == set(ref.__all__)
    assert set(K.__all__) == {"quant_lorenzo2d", "pack", "unpack", "grad2d",
                              "laplacian2d", "block_stats", "prefix_stats2d"}


def test_entry_point_on_cpu_launches_nothing():
    """CPU tensors take the plain versions: no counter moves."""
    rng = np.random.default_rng(0)
    x = _t(rng.normal(0, 1, (40, 50)).astype(np.float32))
    ops.reset_launches()
    p = K.quant_lorenzo2d(x, 1e-2)
    K.block_stats(p.reshape(-1, 40))
    K.unpack(K.pack(encode.zigzag(p.reshape(-1)), 9), p.numel(), 9)
    K.grad2d(p, 1e-2)
    K.laplacian2d(p, 1e-2)
    K.prefix_stats2d(p)
    prefix_stats.prefix_stats_batch(torch.stack([p, p]))
    assert set(ops.LAUNCHES.values()) == {0}


# ===========================================================================
# the Hopper kernels against their plain versions (card only)
# ===========================================================================

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _on(x: np.ndarray, dev) -> torch.Tensor:
    return _t(x).to(dev)


def _launched(site: str, fn):
    before = ops.LAUNCHES[site]
    out = fn()
    assert ops.LAUNCHES[site] == before + 1, site
    torch.cuda.synchronize()
    return out


def _same_card(want, got):
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for w, g in zip(want, got, strict=True):
        assert w.dtype == g.dtype and w.shape == g.shape
        assert torch.equal(w.view(torch.int32), g.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [ODD, (2400, 3600)])
def test_quant_lorenzo_and_stencil_kernels_on_card(shape):
    dev = _card()
    x = torch.as_tensor(np.random.default_rng(1).normal(0, 3, shape)
                        .astype(np.float32), device=dev)
    eps = torch.tensor(1e-3, device=dev)
    p = _launched("quant_lorenzo2d", lambda: K.quant_lorenzo2d(x, eps))
    _same_card(ref.quant_lorenzo2d(x, eps), p)
    q = torch.cumsum(torch.cumsum(p, 0, dtype=torch.int32), 1, dtype=torch.int32)
    _same_card(stencil_dq.grad2d_int_plain(q),
               _launched("grad2d", lambda: stencil_dq.grad2d_int(q)))
    _same_card(ref.stencil_dq_grad2d(q, eps), K.grad2d(q, eps))
    _same_card(stencil_dq.laplacian2d_int_plain(q),
               _launched("laplacian2d", lambda: stencil_dq.laplacian2d_int(q)))
    _same_card(ref.stencil_dq_laplacian2d(q, eps), K.laplacian2d(q, eps))


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [1, 5, 13, 31])
def test_pack_kernel_on_card(bits):
    dev = _card()
    n = 1_000_003
    u = np.random.default_rng(bits).integers(0, 2 ** 32, n, dtype=np.uint64)
    vals = _on(u.astype(np.uint32), dev)
    words = _launched("pack", lambda: K.pack(vals, bits))
    _same_card(ref.pack_uniform(vals, bits), words)
    _same_card(vals & ((1 << bits) - 1), K.unpack(words, n, bits))


@pytest.mark.gpu
@pytest.mark.parametrize("nb,s", [(33750, 256), (1000, 37)])
def test_block_stats_kernel_on_card(nb, s):
    dev = _card()
    rng = np.random.default_rng(nb)
    qb = _on(rng.integers(-2 ** 31, 2 ** 31, (nb, s), dtype=np.int64)
             .astype(np.int32), dev)
    _same_card(ref.block_stats(qb), _launched("block_stats",
                                              lambda: K.block_stats(qb)))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [ODD, (2400, 3600)])
def test_prefix_stats_kernels_on_card(shape):
    dev = _card()
    p = _on(np.random.default_rng(3).integers(-8, 8, shape, dtype=np.int32), dev)
    got = _launched("prefix_stats2d.stats", lambda: K.prefix_stats2d(p))
    _same_card(got, K.prefix_stats2d(p))
    _close(ref.prefix_stats2d(p), got)
    # q drifts to |q| ~ 4e6 here: Σq² overflows int64 but not f64's exact range
    q = torch.cumsum(torch.cumsum(p.to(torch.int64), 0), 1).to(torch.float64)
    _close((q.sum(), (q * q).sum()), got)


PS_CARD_SHAPES = PS_SHAPES + [(2400, 3600), (2401, 3599), (2400, 8200)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", PS_CARD_SHAPES,
                         ids=[f"{a}x{b}" for a, b in PS_CARD_SHAPES])
def test_prefix_stats_register_tiles_on_card(shape):
    """The redesigned stats pass on the card: the edge pass's corner sums
    equal their plain version, and (Σq, Σq²) equals the exact int64 sums
    rounded once to f32 bitwise, the plain f32 version within rtol 1e-5,
    and itself on a second launch."""
    dev = _card()
    # p = the Lorenzo residuals of a bounded q, so that |q| < 2**26 and both
    # totals stay below 2**53 at every shape (random residuals drift)
    q0 = np.random.default_rng(shape[1]).integers(-2 ** 12, 2 ** 12, shape)
    d = np.diff(np.pad(q0, ((1, 0), (1, 0))), axis=0)
    p = _on(np.diff(d, axis=1).astype(np.int32), dev)
    rowedge, coledge, corners = prefix_stats.stats_edges(p)
    th, tw = fused.lorenzo_tile()
    _same_card(fused.lorenzo_edge_prefixes_plain(p, (th, tw)) + (
        prefix_stats.corner_sums_plain(coledge, prefix_stats.corner_cols()),),
        (rowedge, coledge, corners))
    got = _launched("prefix_stats2d.stats", lambda: K.prefix_stats2d(p))
    _same_card(got, K.prefix_stats2d(p))
    q = torch.cumsum(torch.cumsum(p.to(torch.int64), 0), 1)
    assert torch.equal(q.cpu(), torch.as_tensor(q0))
    sums = (q.sum(), (q * q).sum())
    assert max(abs(int(x)) for x in sums) < 2 ** 53
    exact = tuple(x.to(torch.float64).to(torch.float32) for x in sums)
    _same_card(exact, got)
    _close(prefix_stats.prefix_stats2d_plain(p), got)
