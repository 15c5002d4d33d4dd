"""Parity of the PyTorch port's compression core with the JAX reference.

The same numpy inputs go through ``repro`` (JAX, CPU) and ``repro_torch``
(torch, ``device="cpu"``).  Integer leaves, payload words, ``HSZ2`` bytes
and decompressed stages are compared *bitwise*; stage ④ is one f32 multiply
of identical integers, so it is bitwise too.  The reference decodes on its
XLA path (``override_mode("off")``); its own tests hold that path equal to
its Pallas unpack kernel.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Stage as JStage
from repro.core import by_name as jax_by_name
from repro.core import encode as jax_encode
from repro.kernels import ops as jax_kops
from repro_torch.core import Stage, by_name, encode
from repro_torch.core.error_analysis import reconstruction_bound

SCHEMES = ["hszp", "hszx", "hszp_nd", "hszx_nd"]
# (shape, nd block): unpadded and padded in 1-D, 2-D and 3-D
SHAPES = {
    "1d": ((1024,), (256,)),
    "1d_pad": ((1000,), (256,)),
    "2d": ((40, 48), (8, 8)),
    "2d_pad": ((37, 45), (8, 8)),
    "3d": ((16, 16, 16), (8, 8, 8)),
    "3d_pad": ((13, 17, 9), (8, 8, 8)),
}
EPS = [1e-1, 1e-2, 1e-3]
GRID = [(s, k, e) for s in SCHEMES for k in SHAPES for e in EPS]
IDS = [f"{s}-{k}-{e:g}" for s, k, e in GRID]


def _data(shape_id: str) -> np.ndarray:
    shape, _ = SHAPES[shape_id]
    rng = np.random.default_rng(len(shape) * 1000 + sum(shape))
    d = rng.normal(0, 1, shape).astype(np.float32)
    for ax in range(len(shape)):
        d = np.cumsum(d, axis=ax)
    return (d * 0.05).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _pair(scheme: str, shape_id: str, eps: float):
    """(data, jax Compressed, jax Encoded, torch Compressed, torch Encoded)."""
    data = _data(shape_id)
    block = SHAPES[shape_id][1] if scheme.endswith("_nd") else None
    jcomp, tcomp = jax_by_name(scheme, block), by_name(scheme, block)
    jc = jcomp.compress(jnp.asarray(data), abs_eb=eps)
    tc = tcomp.compress(data, abs_eb=eps, device="cpu")
    return data, jc, jcomp.encode(jc), tc, tcomp.encode(tc)


def _eq(a, b, what):
    a, b = np.asarray(a), b.numpy() if isinstance(b, torch.Tensor) else b
    assert (a.shape, a.dtype) == (b.shape, b.dtype), (what, a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), what


@pytest.mark.parametrize("scheme,shape_id,eps", GRID, ids=IDS)
def test_containers_bitwise(scheme, shape_id, eps):
    _, jc, je, tc, te = _pair(scheme, shape_id, eps)
    for leaf in ("residuals", "metadata", "bitwidths", "valid_counts", "eps"):
        _eq(getattr(jc, leaf), getattr(tc, leaf), leaf)
    assert (tc.shape, tc.padded_shape, tc.block) == (
        jc.shape, jc.padded_shape, jc.block)
    assert te.bits == je.bits
    _eq(je.payload, te.payload.numpy().view(np.uint32), "payload")


@pytest.mark.parametrize("scheme,shape_id,eps", GRID, ids=IDS)
def test_serialize_bitwise_and_cross_deserialize(scheme, shape_id, eps):
    _, jc, _, tc, _ = _pair(scheme, shape_id, eps)
    blob = encode.serialize(tc)
    assert blob == jax_encode.serialize(jc)
    jd = jax_encode.deserialize(blob)
    td = encode.deserialize(blob, device="cpu")
    for leaf in ("residuals", "metadata", "bitwidths", "valid_counts", "eps"):
        _eq(getattr(jd, leaf), getattr(td, leaf), leaf)
    assert td.scheme.value == jd.scheme.value
    assert (td.shape, td.padded_shape, td.block) == (
        jd.shape, jd.padded_shape, jd.block)


@pytest.mark.parametrize("scheme,shape_id,eps", GRID, ids=IDS)
def test_decompress_bitwise(scheme, shape_id, eps):
    _, jc, je, tc, te = _pair(scheme, shape_id, eps)
    jcomp, tcomp = jax_by_name(scheme), by_name(scheme)
    with jax_kops.override_mode("off"):
        for stage in (Stage.P, Stage.Q, Stage.F):
            for jf, tf in ((jc, tc), (je, te)):
                want = jcomp.decompress(jf, JStage(int(stage)))
                _eq(want, tcomp.decompress(tf, stage), f"{stage!r}")
                if stage != Stage.P:
                    _eq(jcomp.decompress(jf, JStage(int(stage)), crop=False),
                        tcomp.decompress(tf, stage, crop=False), "uncropped")


@pytest.mark.parametrize("scheme,shape_id,eps", GRID, ids=IDS)
def test_error_bound(scheme, shape_id, eps):
    data, _, _, tc, te = _pair(scheme, shape_id, eps)
    comp = by_name(scheme)
    bound = reconstruction_bound(tc, float(np.abs(data).max()))
    for f in (tc, te):
        out = comp.decompress(f, Stage.F).numpy()
        assert out.shape == data.shape
        assert np.max(np.abs(out - data)) <= bound


@pytest.mark.parametrize("scheme", SCHEMES)
def test_rel_eb_and_accounting_match(scheme):
    """Relative error bounds resolve to the same eps, and the size
    accounting (serialized bits, compression ratio, device bytes) agrees."""
    data = _data("2d_pad")
    jcomp, tcomp = jax_by_name(scheme), by_name(scheme)
    jc = jcomp.compress(jnp.asarray(data), rel_eb=1e-3)
    tc = tcomp.compress(data, rel_eb=1e-3, device="cpu")
    _eq(jc.eps, tc.eps, "eps")
    _eq(jc.residuals, tc.residuals, "residuals")
    assert float(tcomp.serialized_bits(tc)) == float(jcomp.serialized_bits(jc))
    assert float(tcomp.compression_ratio(tc)) == pytest.approx(
        float(jcomp.compression_ratio(jc)), rel=1e-6)
    assert tc.device_bytes() == jc.device_bytes()
    assert tcomp.encode(tc).device_bytes() == jcomp.encode(jc).device_bytes()


def test_constant_field_and_max_bits():
    """A constant field quantizes to zeros: width 0 everywhere, empty
    payload, exact reconstruction."""
    data = np.full((24, 40), 3.25, np.float32)
    for scheme in SCHEMES:
        comp = by_name(scheme, (8, 8) if scheme.endswith("_nd") else None)
        c = comp.compress(data, rel_eb=1e-3, device="cpu")
        e = comp.encode(c)
        if comp.scheme.is_blockmean:
            assert comp.max_bits(c) == 0 and e.payload.numel() == 0
        out = comp.decompress(e, Stage.F).numpy()
        assert np.max(np.abs(out - data)) <= reconstruction_bound(c, 3.25)


@pytest.mark.parametrize("bits", [1, 7, 13, 31, 32])
def test_pack_uniform_words_match_reference(bits):
    rng = np.random.default_rng(bits)
    n = 4097 + 13 * bits
    u = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    if bits < 32:
        u &= np.uint32((1 << bits) - 1)
    want = np.asarray(jax_encode.pack_uniform(jnp.asarray(u), bits))
    got = encode.pack_uniform(torch.as_tensor(u.view(np.int32)), bits)
    _eq(want, got.numpy().view(np.uint32), "words")
    back = encode.unpack_uniform(got, n, bits).numpy().view(np.uint32)
    np.testing.assert_array_equal(back, u)


def test_cuda_request_without_card_raises():
    """An entry point asked for the card never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        by_name("hszp_nd").compress(_data("2d"), rel_eb=1e-2)
