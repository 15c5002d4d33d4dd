"""Batched execution in the port against the per-field port and the JAX
reference: ``batch_stack`` views, the batch axis of the decode and band
kernels, and ``BatchedAnalytics.run`` as one program over a batch.

What is held, with its tolerance:

* ``batch_stack`` / ``batch_size`` / ``batch_unstack``: the leaves, the
  round trip and the error messages of ``repro.core.stages``;
* the batched plain versions (what each batched kernel is held to on the
  card): **bitwise** the per-field plain calls and the reference's
  ``jax.vmap`` of its Pallas kernels (interpret mode), at one and three
  fields, on a payload of a ragged word count (``n_words % 4 != 0``), and
  on a batch whose second field is all zeros after a first of full-range
  residuals, where a carry leaking across fields would show;
* the batched engine (a full-field ``run``): **bitwise** the port's
  per-field calls for both n-D schemes, both containers, every feasible
  stage, the seven spatial ops, batches of 1, 3 and 5 fields of different
  ``eps`` and one rank-3 batch; against the reference's batched run (its
  fused rules off) the tolerances of ``tests/test_torch_analytics.py``:
  stencils bitwise, divergence / curl ``rtol=1e-6``, mean / std ``rtol
  1e-5`` or half the paper's bias bound (1e-3 of it where it is eps);
* on the CPU the batched run (full field or region) builds one stage
  context per component and launches no kernel; a batch view with
  pre-gathered payload words raises.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import analytics as janalytics
from repro.core import Stage as JStage
from repro.core import batch_size as jbatch_size
from repro.core import batch_stack as jbatch_stack
from repro.core import batch_unstack as jbatch_unstack
from repro.core import by_name as jax_by_name
from repro.core import encode as jencode
from repro.kernels import bitpack as jbitpack
from repro.kernels import fused as jfused
from repro.kernels import ops as jops
from repro_torch import analytics, convert
from repro_torch.core import (Stage, batch_size, batch_stack, batch_unstack,
                              error_analysis, oplib)
from repro_torch.core import encode
from repro_torch.core import homomorphic as H
from repro_torch.core.stages import LEAVES
from repro_torch.kernels import bitpack, fused, ops, prefix_stats

ND = ["hszp_nd", "hszx_nd"]
KINDS = ["Compressed", "Encoded"]
#: a plane whose payload at 7 bits is 429 words (n_words % 4 == 1), and a
#: block-mean plane of (5, 7) blocks whose payload is ragged too
LZ_SHAPE, BM_SHAPE, BM_BLOCK, BITS = (37, 53), (40, 49), (5, 7), 7
#: the cross-field case spans 3 x 3 of the card kernels' 32 x 128 tiles
LEAK_LZ, LEAK_BM = (70, 300), (70, 301)
LZ_CASES = [(src, w) for src in ("payload", "plane")
            for w in fused.LORENZO_WHATS]
BM_CASES = [(src, w) for src in ("payload", "plane")
            for w in fused.BLOCKMEAN_WHATS]
SET = ["mean", "std", "gradient", "laplacian"]
VECTOR_SET = ["divergence", "curl"]
FIELD_SHAPE = (24, 40)


def to_port(jc):
    """The reference container ``jc`` as the port's, on the CPU."""
    kind = type(jc).__name__
    arrays = {n: np.asarray(getattr(jc, n)) for n in LEAVES[kind]}
    meta = {"scheme": jc.scheme.value, "shape": jc.shape,
            "padded_shape": jc.padded_shape, "block": jc.block,
            "orig_dtype": np.dtype(jc.orig_dtype).name}
    if kind == "Encoded":
        meta["bits"] = jc.bits
    return convert.from_arrays(kind, arrays, meta, device="cpu")


def _fields(scheme, kind, n, shape=FIELD_SHAPE, seed=0):
    """``n`` same-layout reference fields of different ``eps`` (and their
    port twins); ``Encoded`` ones packed at the widest of their widths."""
    rng = np.random.default_rng(seed)
    comp = jax_by_name(scheme)
    js = []
    for i in range(n):
        d = np.cumsum(rng.normal(0, 1, shape), axis=0).astype(np.float32)
        js.append(comp.compress(jnp.asarray(d), abs_eb=1e-2 * (1 + i)))
    if kind == "Encoded":
        bits = max(comp.max_bits(c) for c in js)
        js = [comp.encode(c, bits=bits) for c in js]
    return js, [to_port(c) for c in js]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tup(x):
    return x if isinstance(x, tuple) else (x,)


def _bitwise(want, got, what=""):
    want, got = _tup(want), _tup(got)
    assert len(want) == len(got), what
    for w, g in zip(want, got):
        w, g = _np(w), _np(g)
        if w.dtype == np.uint32:
            w = w.view(np.int32)
        assert (w.shape, w.dtype) == (g.shape, g.dtype), what
        assert w.tobytes() == g.tobytes(), what


def _t(a) -> torch.Tensor:
    a = np.array(a)
    return torch.as_tensor(a.view(np.int32) if a.dtype == np.uint32 else a)


def _pack(planes: np.ndarray, bits: int) -> np.ndarray:
    """One payload row per plane (the port's packer, the reference's
    bits)."""
    return np.stack([encode.pack_uniform(encode.zigzag(
        torch.as_tensor(p.reshape(-1))), bits).numpy() for p in planes])


# ===========================================================================
# batch_stack / batch_size / batch_unstack
# ===========================================================================

@pytest.mark.parametrize("kind", KINDS)
def test_stack_round_trip_matches_reference(kind):
    js, ts = _fields("hszx_nd", kind, 3)
    jv, tv = jbatch_stack(js), batch_stack(ts)
    assert batch_size(tv) == jbatch_size(jv) == 3
    for name in LEAVES[kind]:
        _bitwise(getattr(jv, name), getattr(tv, name), name)
    assert (tv.shape, tv.padded_shape, tv.block) == (jv.shape, jv.padded_shape,
                                                     jv.block)
    for jc, tc in zip(jbatch_unstack(jv), batch_unstack(tv), strict=True):
        for name in LEAVES[kind]:
            _bitwise(getattr(jc, name), getattr(tc, name), name)
    for orig, back in zip(ts, batch_unstack(tv)):
        for name in LEAVES[kind]:
            assert torch.equal(getattr(orig, name), getattr(back, name))


def test_stack_messages_match_reference():
    (ja, jb), (ta, tb) = _fields("hszp_nd", "Compressed", 2)
    (jo,), (to,) = _fields("hszp_nd", "Compressed", 1, shape=(24, 48))
    for stack, a, o in ((jbatch_stack, ja, jo), (batch_stack, ta, to)):
        with pytest.raises(ValueError, match="cannot stack fields with "
                           "different layouts: field 0 has .*, field 1 has"):
            stack([a, o])
        with pytest.raises(ValueError, match="needs at least one field"):
            stack([])
    for size, c in ((jbatch_size, ja), (batch_size, ta)):
        with pytest.raises(ValueError, match="not a batch_stack view"):
            size(c)
    elsewhere = dataclasses.replace(tb, **{
        n: torch.empty_like(getattr(tb, n), device="meta")
        for n in LEAVES["Compressed"]})
    with pytest.raises(ValueError, match="cannot stack fields on different "
                       "devices: field 0 lies on cpu, field 1 on meta"):
        batch_stack([ta, elsewhere])


# ===========================================================================
# batched plain versions: the per-field calls and the reference's vmap
# ===========================================================================

def _lz_inputs(batch, rng, leak=False):
    """(planes, payload rows) of ``batch`` Lorenzo planes; ``leak``: field 0
    full-range residuals at 31 bits, field 1 zeros."""
    n0, n1 = LEAK_LZ if leak else LZ_SHAPE
    if leak:
        p = np.zeros((2, n0, n1), np.int32)
        p[0] = rng.integers(-2 ** 30, 2 ** 30, (n0, n1))
        return p, _pack(p, 31), 31
    p = rng.integers(-60, 60, (batch, n0, n1)).astype(np.int32)
    return p, _pack(p, BITS), BITS


def _lz_plain(src, what, planes, words, bits):
    if src == "payload":
        return fused.lorenzo_enc2d(torch.as_tensor(words), planes.shape[-2:],
                                   bits, what=what)
    return fused.lorenzo2d(torch.as_tensor(planes), what=what)


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("src,what", LZ_CASES,
                         ids=[f"{s}-{w}" for s, w in LZ_CASES])
def test_batched_lorenzo_matches_fields_and_vmap(src, what, batch):
    planes, words, bits = _lz_inputs(batch, np.random.default_rng(batch))
    assert words.shape[-1] % 4 != 0
    got = _lz_plain(src, what, planes, words, bits)
    for b in range(batch):
        one = _lz_plain(src, what, planes[b], words[b], bits)
        _bitwise(one, tuple(g[b] for g in _tup(got)), f"field {b}")
    if src == "payload":
        ref = jax.vmap(functools.partial(
            jfused.lorenzo_enc2d, shape=LZ_SHAPE, bits=bits, what=what,
            interpret=True))(jnp.asarray(words.view(np.uint32)))
    else:
        ref = jax.vmap(functools.partial(jfused.lorenzo2d, what=what,
                                         interpret=True))(jnp.asarray(planes))
    _bitwise(ref, got, f"vmap lorenzo {src} {what}")


def _bm_inputs(batch, rng, leak=False):
    (n0, n1), (b0, b1) = LEAK_BM if leak else BM_SHAPE, BM_BLOCK
    grid = (n0 // b0, n1 // b1)
    if leak:
        p = np.zeros((2, n0, n1), np.int32)
        m = np.zeros((2,) + grid, np.int32)
        p[0] = rng.integers(-2 ** 29, 2 ** 29, (n0, n1))
        m[0] = rng.integers(-2 ** 29, 2 ** 29, grid)
        return p, m, _pack(p, 31), 31
    p = rng.integers(-60, 60, (batch, n0, n1)).astype(np.int32)
    m = rng.integers(-500, 500, (batch,) + grid).astype(np.int32)
    return p, m, _pack(p, BITS), BITS


def _bm_plain(src, what, planes, meta, words, bits):
    if src == "payload":
        return fused.blockmean_enc2d(torch.as_tensor(words),
                                     torch.as_tensor(meta), planes.shape[-2:],
                                     BM_BLOCK, bits, what=what)
    return fused.blockmean2d(torch.as_tensor(planes), torch.as_tensor(meta),
                             BM_BLOCK, what=what)


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("src,what", BM_CASES,
                         ids=[f"{s}-{w}" for s, w in BM_CASES])
def test_batched_blockmean_matches_fields_and_vmap(src, what, batch):
    planes, meta, words, bits = _bm_inputs(batch,
                                           np.random.default_rng(batch))
    assert words.shape[-1] % 4 != 0
    got = _bm_plain(src, what, planes, meta, words, bits)
    for b in range(batch):
        one = _bm_plain(src, what, planes[b], meta[b], words[b], bits)
        _bitwise(one, tuple(g[b] for g in _tup(got)), f"field {b}")
    if src == "payload":
        ref = jax.vmap(functools.partial(
            jfused.blockmean_enc2d, shape=BM_SHAPE, block=BM_BLOCK, bits=bits,
            what=what, interpret=True))(jnp.asarray(words.view(np.uint32)),
                                        jnp.asarray(meta))
    else:
        ref = jax.vmap(functools.partial(
            jfused.blockmean2d, block=BM_BLOCK, what=what, interpret=True))(
                jnp.asarray(planes), jnp.asarray(meta))
    _bitwise(ref, got, f"vmap blockmean {src} {what}")


def test_batched_edges_restart_at_every_field():
    """The edge prefixes of a batch (what the edge and scan kernels write)
    are each field's own: field 1, all zeros, has zero edges after a field
    0 of full-range residuals, and every plane of field 1 is zero."""
    rng = np.random.default_rng(7)
    planes, words, bits = _lz_inputs(2, rng, leak=True)
    p = torch.as_tensor(planes)
    tile = (32, 128)
    rowedge, coledge = fused.lorenzo_edge_prefixes_plain(p, tile)
    for b in range(2):
        want = fused.lorenzo_edge_prefixes_plain(p[b], tile)
        _bitwise(want, (rowedge[b], coledge[b]), f"edges of field {b}")
    assert rowedge[0].abs().sum() > 0 and coledge[0].abs().sum() > 0
    assert not rowedge[1].any() and not coledge[1].any()
    for src in ("payload", "plane"):
        for what in fused.LORENZO_WHATS:
            out = _tup(_lz_plain(src, what, planes, words, bits))
            assert all(not o[1].any() for o in out), (src, what)
            assert all(o[0].any() for o in out), (src, what)
    bplanes, meta, bwords, bbits = _bm_inputs(2, rng, leak=True)
    for src in ("payload", "plane"):
        for what in fused.BLOCKMEAN_WHATS:
            out = _tup(_bm_plain(src, what, bplanes, meta, bwords, bbits))
            assert all(not o[1].any() for o in out), (src, what)


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("bits", [1, 7, 17, 31])
def test_batched_unpack_matches_fields_and_vmap(bits, batch):
    rng = np.random.default_rng(bits + batch)
    n = LZ_SHAPE[0] * LZ_SHAPE[1]
    planes = rng.integers(-(1 << (bits - 1)), 1 << (bits - 1),
                          (batch,) + LZ_SHAPE).astype(np.int32)
    words = torch.as_tensor(_pack(planes, bits))
    got_u = bitpack.unpack(words, n, bits)
    got = bitpack.unpack_residuals(words, n, bits)
    _bitwise(planes.reshape(batch, n), got, "residuals")
    for b in range(batch):
        _bitwise(bitpack.unpack(words[b], n, bits), got_u[b], f"zigzag {b}")
        _bitwise(bitpack.unpack_residuals(words[b], n, bits), got[b],
                 f"residuals {b}")
    ref = jax.vmap(functools.partial(jbitpack.unpack, n=n, bits=bits,
                                     interpret=True))(
        jnp.asarray(words.numpy().view(np.uint32)))
    _bitwise(ref, got_u, "vmap unpack")
    _bitwise(jencode.unzigzag(ref), got, "vmap unpack + unzigzag")


@pytest.mark.parametrize("scheme", ND)
def test_decode_device_on_a_batch_view(scheme):
    _, ts = _fields(scheme, "Encoded", 3)
    view = encode.decode_device(batch_stack(ts))
    want = batch_stack([encode.decode_device(e) for e in ts])
    for name in LEAVES["Compressed"]:
        _bitwise(getattr(want, name), getattr(view, name), name)


def test_batched_wrappers_on_the_cpu_launch_nothing():
    planes, words, bits = _lz_inputs(3, np.random.default_rng(0))
    ops.reset_launches()
    bitpack.unpack_residuals(torch.as_tensor(words), planes[0].size, bits)
    for src in ("payload", "plane"):
        _lz_plain(src, "grad", planes, words, bits)
    bplanes, meta, bwords, bbits = _bm_inputs(3, np.random.default_rng(0))
    for src in ("payload", "plane"):
        _bm_plain(src, "lap_q", bplanes, meta, bwords, bbits)
    assert set(ops.LAUNCHES.values()) == {0}


# ===========================================================================
# the batched engine
# ===========================================================================

def _match_reference(op, want, got, field, stage, what):
    """The slice tolerances (``tests/test_torch_analytics.py``)."""
    if op in ("mean", "std"):
        w, g = float(_np(want)), float(_np(got))
        bound = (error_analysis.mean_bias_bound if op == "mean"
                 else error_analysis.std_bias_bound)(field, stage)
        eps = float(field.eps.item())
        tol = max(1e-5 * abs(w), (1e-3 if bound >= eps else 0.5) * bound)
        assert abs(g - w) <= tol, (what, abs(g - w), tol)
    elif op in ("divergence", "curl"):
        for w, g in zip(_tup(want), _tup(got), strict=True):
            w, g = _np(w), _np(g)
            np.testing.assert_allclose(g, w, rtol=1e-6,
                                       atol=1e-6 * float(np.abs(w).max()),
                                       err_msg=what)
    else:
        _bitwise(want, got, what)


def _one(op, c, stage, axis=0):
    """The per-field call a batched result is held to."""
    if op == "derivative":
        return H.derivative(c, stage, axis)
    if op in ("divergence", "curl"):
        return getattr(H, op)(list(c), stage)
    return getattr(H, op)(c, stage)


def _item(batched, i):
    return (tuple(x[i] for x in batched) if isinstance(batched, tuple)
            else batched[i])


def _runs(scheme, ts, pairs):
    """(op set, stage, axis, items) of every feasible batched run."""
    out = [(SET, st, 0, ts) for st in (Stage.P, Stage.Q, Stage.F)]
    out += [(["derivative"], st, 1, ts) for st in (Stage.P, Stage.Q, Stage.F)]
    out += [(VECTOR_SET, st, 0, pairs) for st in (Stage.P, Stage.Q, Stage.F)]
    if scheme == "hszx_nd":
        out.append((["mean"], Stage.M, 0, ts))
    return out


@pytest.mark.parametrize("batch", [1, 3, 5])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("scheme", ND)
def test_batched_engine_matches_per_field(scheme, kind, batch):
    """Every feasible run over ``batch`` fields of different eps equals the
    per-field calls bitwise; at three fields also the reference's batched
    run (its fused rules off) within the slice tolerances."""
    js, ts = _fields(scheme, kind, 2 * batch, seed=batch)
    jpairs = list(zip(js[0::2], js[1::2]))
    pairs = list(zip(ts[0::2], ts[1::2]))
    js, ts = js[:batch], ts[:batch]
    eng, jeng = analytics.BatchedAnalytics(), janalytics.BatchedAnalytics()
    for (names, stage, axis, items), (_, _, _, jitems) in zip(
            _runs(scheme, ts, pairs), _runs(scheme, js, jpairs)):
        res = eng.run(items, names, stage, axis=axis)
        if batch == 3:
            with jops.override_mode("off"):
                jres = jeng.run(jitems, names, JStage(int(stage)), axis=axis)
        for op in names:
            for i, item in enumerate(items):
                what = f"{scheme} {kind} {op}@{stage.name} field {i}"
                got = _item(res[op], i)
                _bitwise(_one(op, item, stage, axis), got, what)
                if batch == 3:
                    field = item[0] if isinstance(item, tuple) else item
                    _match_reference(op, _item(jres[op], i), got, field,
                                     stage, what)


def test_batched_engine_rank3():
    js, ts = _fields("hszp_nd", "Compressed", 3, shape=(9, 10, 12))
    eng = analytics.BatchedAnalytics()
    for stage in (Stage.P, Stage.Q):
        res = eng.run(ts, SET, stage)
        with jops.override_mode("off"):
            jres = janalytics.BatchedAnalytics().run(js, SET,
                                                     JStage(int(stage)))
        for op in SET:
            for i, c in enumerate(ts):
                what = f"rank 3 {op}@{stage.name} field {i}"
                got = _item(res[op], i)
                _bitwise(_one(op, c, stage), got, what)
                _match_reference(op, _item(jres[op], i), got, c, stage, what)


def test_batched_run_builds_one_context_per_component(monkeypatch):
    built = []
    real = oplib.StageContext.__init__

    def counting(self, c, *args, **kw):
        built.append(type(c).__name__)
        real(self, c, *args, **kw)

    monkeypatch.setattr(oplib.StageContext, "__init__", counting)
    _, ts = _fields("hszp_nd", "Encoded", 6)
    eng = analytics.BatchedAnalytics()
    ops.reset_launches()
    eng.run(ts, SET, Stage.P)
    assert len(built) == 1
    built.clear()
    eng.run(list(zip(ts[0::2], ts[1::2])), VECTOR_SET, Stage.Q)
    assert len(built) == 2
    built.clear()
    # a region program is one program over the batch too
    eng.run(ts, SET, Stage.Q, region=((2, 20), (3, 30)))
    assert len(built) == 1
    assert set(ops.LAUNCHES.values()) == {0}


def test_batch_view_runs_full_field_only():
    """Pre-gathered payload words take one field at a time: a batch view
    with ``payload_words=`` still raises."""
    _, ts = _fields("hszx_nd", "Encoded", 2)
    view = batch_stack(ts)
    with pytest.raises(ValueError, match="one field at a time"):
        oplib.compute(view, "mean", Stage.P, region=((0, 8), (0, 8)),
                      payload_words=view.payload)


# ===========================================================================
# Lorenzo stage-② mean and std: the prefix-stats kernels' path
# ===========================================================================

@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("shape", [LZ_SHAPE, LEAK_LZ])
def test_batched_prefix_stats_plain_matches_fields(shape, batch):
    """The batched prefix-stats wrapper on the CPU (its plain version, what
    the kernels are held to on the card) is each plane's
    ``prefix_stats2d_plain``, bitwise, and launches nothing."""
    rng = np.random.default_rng(batch + shape[1])
    p = torch.as_tensor(rng.integers(-2 ** 12, 2 ** 12, (batch,) + shape)
                        .astype(np.int32))
    ops.reset_launches()
    got = prefix_stats.prefix_stats_batch(p)
    assert got.shape == (batch, 2) and got.dtype == torch.float32
    for b in range(batch):
        _bitwise(torch.stack(prefix_stats.prefix_stats2d_plain(p[b])), got[b],
                 f"field {b}")
        _bitwise(prefix_stats.prefix_stats_batch(p[b]), got[b],
                 f"field {b} alone")
    assert set(ops.LAUNCHES.values()) == {0}


#: contexts of Lorenzo stage-② statistics: (scheme, shape, region, does the
#: prefix-stats path apply where the residuals lie on the card)
MOMENT_CASES = {
    "full": ("hszp_nd", (32, 48), None, True),
    "padded": ("hszp_nd", FIELD_SHAPE, None, True),
    "region": ("hszp_nd", FIELD_SHAPE, ((2, 20), (3, 30)), False),
    "rank3": ("hszp_nd", (9, 10, 12), None, False),
    "flat": ("hszp", FIELD_SHAPE, None, False),
}


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("case", list(MOMENT_CASES))
def test_lorenzo_moments_path(case, batch, monkeypatch):
    """Which path ``mean`` / ``std`` @② take: with the residuals on the
    card (its device check answered yes) a 2-D full Lorenzo field calls the
    batched prefix-stats wrapper once per context, on the residuals' valid
    crop, and its answers are the batch's fields' own (batch == lone,
    bitwise) and within the slice tolerances of the torch path; a region, a
    rank-3 field and a 1-D scheme never call it and answer bit for bit what
    they answer on the CPU, where no field calls it."""
    scheme, shape, region, applies = MOMENT_CASES[case]
    _, ts = _fields(scheme, "Compressed", batch, shape=shape, seed=batch)
    items = [batch_stack(ts)] + ts
    cpu = [oplib.compute(c, ["mean", "std"], Stage.P, region=region)
           for c in items]
    closure = oplib.set_closure(["mean", "std"], ts[0].scheme, Stage.P)
    for c in items:
        assert oplib.StageContext(c, Stage.P, region,
                                  closure).lorenzo_moments is None
    calls = []

    def moments(p):
        calls.append((tuple(p.shape), p.is_contiguous()))
        return prefix_stats.prefix_stats_batch_plain(p)

    monkeypatch.setattr(oplib, "kernel_ops", type("Card", (), {
        "on_card": staticmethod(lambda *t: True),
        "kernels_enabled": staticmethod(ops.kernels_enabled)}))
    monkeypatch.setattr(oplib, "kernel_stats", type("Stats", (), {
        "prefix_stats_batch": staticmethod(moments)}))
    card = [oplib.compute(c, ["mean", "std"], Stage.P, region=region)
            for c in items]
    if not applies:
        assert calls == []
        for want, got in zip(cpu, card):
            for op in ("mean", "std"):
                _bitwise(want[op], got[op], f"{case} {op}")
        return
    assert calls == [((batch,) + shape, True)] + [(shape, True)] * batch
    for op in ("mean", "std"):
        for i, c in enumerate(ts):
            what = f"{case} {op} field {i}"
            _bitwise(card[1 + i][op], _item(card[0][op], i), what)
            _match_reference(op, cpu[1 + i][op], card[1 + i][op], c, Stage.P,
                             what)
