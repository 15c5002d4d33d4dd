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
    tile (a cumsum of the column-prefix edge) starts each column's.
    Emulating that tiling with the plain edge pass must give
    ``cumsum(cumsum(p, 0), 1)`` exactly, int32 wrap-around included."""
    rng = np.random.default_rng(sum(tile))
    p = _t(rng.integers(-2 ** 31, 2 ** 31, (45, 37), dtype=np.int64)
           .astype(np.int32))
    rowedge, top = prefix_stats.tile_edges(
        *fused.lorenzo_edge_prefixes_plain(p, tile))
    th, tw = tile
    q = torch.empty_like(p)
    for ti in range(top.shape[0]):
        for tj in range(rowedge.shape[1]):
            rs, cs = slice(ti * th, (ti + 1) * th), slice(tj * tw, (tj + 1) * tw)
            d0 = rowedge[rs, tj:tj + 1] + torch.cumsum(p[rs, cs], 1,
                                                       dtype=torch.int32)
            q[rs, cs] = top[ti:ti + 1, cs] + torch.cumsum(d0, 0,
                                                          dtype=torch.int32)
    want = torch.cumsum(torch.cumsum(p, 0, dtype=torch.int32), 1,
                        dtype=torch.int32)
    assert torch.equal(q, want)


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
