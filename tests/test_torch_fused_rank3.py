"""The Lorenzo derivative of a rank-3 field through the fused rule.

``kernels.fused.lorenzo_enc3d`` (its plain version on the CPU) against the
torch rule (``override_mode("off")``), bit for bit: every axis, stages ②
③ ④, one field and a ``batch_stack`` batch of three with their own eps,
shapes off the kernels' tiles and a padded layout, widths 1, 9 and 31, and
payloads whose partial sums pass 2^31 (the int32 wrap).  The coverage
predicate judges rank 2 as before and declines rank-3 regions, seeds,
``Compressed`` containers and block-mean fields; an axis wider than the
kernels take runs the torch rule's ops under the ``hsz.op.torch`` span.
"""
import dataclasses
import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import Stage, by_name, fused as fused_mod, oplib
from repro_torch.core.stages import batch_stack
from repro_torch.kernels import bitpack, fused, ops
from repro_torch.store import materialize

BLOCK = (8, 8, 8)
#: (valid shape, block): off every tile of the kernels, and a padded
#: layout (20 x 27 x 33 in 8^3 blocks is 24 x 32 x 40)
SHAPES = {"odd": ((13, 21, 37), (1, 1, 1)), "padded": ((20, 27, 33), BLOCK)}
STAGES = (Stage.P, Stage.Q, Stage.F)


def _raw(shape, i: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(300 + i)
    return torch.randn(shape, generator=g).cumsum(0).cumsum(2) * 0.1


def _field(shape, block, bits: int, i: int):
    """An HSZp-nd field whose payload is replaced by seeded random words at
    ``bits``: every residual the width allows, the same payload for both
    rules (the eps, shape and layout of a compressed field)."""
    comp = by_name("hszp_nd", block)
    e = comp.encode(comp.compress(_raw(shape, i), rel_eb=1e-3, device="cpu"))
    n = 1
    for s in e.padded_shape:
        n *= s
    g = torch.Generator().manual_seed(700 + 31 * i + bits)
    words = torch.randint(-2**31, 2**31, (-(-n * bits // 32),),
                          generator=g, dtype=torch.int64).to(torch.int32)
    return dataclasses.replace(e, payload=words, bits=bits)


def _derivative(target, stage, axis):
    return oplib.compute(target, "derivative", stage, axis=axis)["derivative"]


def _both(target, stage, axis):
    ops.reset_launches()
    got = _derivative(target, stage, axis)
    with ops.override_mode("off"):
        want = _derivative(target, stage, axis)
    return got, want


def _bitwise(got, want):
    assert got.dtype == want.dtype == torch.float32
    assert got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("batched", [False, True], ids=["one", "batch3"])
@pytest.mark.parametrize("stage", STAGES, ids=lambda s: s.name)
@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_fused_rule_equals_torch_rule(shape, axis, stage, batched,
                                     monkeypatch):
    dims, block = SHAPES[shape]
    fields = [_field(dims, block, 9, i) for i in range(3 if batched else 1)]
    target = batch_stack(fields) if batched else fields[0]
    calls = []
    real = fused.lorenzo_enc3d
    monkeypatch.setattr(fused, "lorenzo_enc3d",
                        lambda *a: calls.append(a[4]) or real(*a))
    got, want = _both(target, stage, axis)
    assert calls == [axis]  # the fused rule ran, once; the torch rule not
    lead = (3,) if batched else ()
    assert got.shape == lead + tuple(n - 2 for n in dims)
    _bitwise(got, want)
    if batched:  # each field's own eps: the batch is its fields alone
        for b, f in enumerate(fields):
            _bitwise(got[b], _derivative(f, stage, axis))


@pytest.mark.parametrize("bits", [1, 9, 31])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_every_width(bits, axis):
    dims, block = SHAPES["padded"]
    for stage in (Stage.P, Stage.Q):
        _bitwise(*_both(_field(dims, block, bits, 0), stage, axis))


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_partial_sums_past_2_31_wrap_alike(axis):
    """At 31 bits the residuals reach 2^30: the 2-D prefixes pass 2^31 and
    wrap modulo 2^32 in both rules."""
    dims, block = SHAPES["odd"]
    f = _field(dims, block, 31, 1)
    p = fused._unzigzag(bitpack.unpack_plain(f.payload, f.payload.numel() * 32
                                             // 31, 31))
    n = 1
    for s in f.padded_shape:
        n *= s
    d = p[:n].reshape(f.padded_shape).to(torch.int64)
    for a in range(3):
        if a != axis:
            d = d.cumsum(a)
    assert d.abs().max() > 2**31
    for stage in STAGES:
        _bitwise(*_both(f, stage, axis))


def test_gradient_divergence_and_curl_take_the_rule():
    """Rank-3 gradients, divergences and curls reach the rule through
    ``_derivative_at``: bitwise the torch rules."""
    dims, block = SHAPES["padded"]
    u, v, w = (_field(dims, block, 9, i) for i in range(3))
    for stage in STAGES:
        got = oplib.compute(u, "gradient", stage)["gradient"]
        with ops.override_mode("off"):
            want = oplib.compute(u, "gradient", stage)["gradient"]
        for g, x in zip(got, want):
            _bitwise(g, x)
        for op in ("divergence", "curl"):
            got = oplib.compute([u, v, w], op, stage)[op]
            with ops.override_mode("off"):
                want = oplib.compute([u, v, w], op, stage)[op]
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            for g, x in zip(got, want):
                _bitwise(g, x)


def test_cpu_runs_the_plain_version():
    dims, block = SHAPES["odd"]
    f = _field(dims, block, 9, 2)
    ops.reset_launches()
    out = fused.lorenzo_enc3d(f.payload, f.padded_shape, f.shape, f.bits, 2,
                              f.eps)
    _bitwise(out, fused.lorenzo_enc3d_plain(f.payload, f.padded_shape,
                                            f.shape, f.bits, 2, f.eps))
    assert ops.LAUNCHES["lorenzo_enc3d.edges"] == 0
    assert ops.LAUNCHES["lorenzo_enc3d.stencil"] == 0


def test_empty_interior():
    f = _field((2, 9, 9), (1, 1, 1), 9, 0)
    for axis in range(3):
        got, want = _both(f, Stage.P, axis)
        assert got.shape == want.shape == (0, 7, 7)


def _ctx(field, stage=Stage.P, region=None, seed=None):
    closure = oplib.set_closure(["derivative"], field.scheme, stage, 0)
    return oplib.StageContext(field, stage, region, closure, seed=seed)


def _rule(stage=Stage.P):
    return fused_mod.DERIVATIVE[(stage, "lorenzo")]


def test_rank2_is_judged_as_before():
    comp = by_name("hszp_nd", (8, 8))
    c = comp.compress(torch.randn(24, 40).cumsum(0), rel_eb=1e-3,
                      device="cpu")
    e = comp.encode(c)
    ctxs = [_ctx(e), _ctx(c), _ctx(e, region=((2, 20), (3, 30))),
            _ctx(e, seed=materialize(e, Stage.P)),
            _ctx(e, Stage.Q, seed=materialize(e, Stage.Q))]
    for ctx in ctxs:
        assert _rule().covers(ctx) == fused_mod._covers_2d(ctx) is True


def test_rank3_declines_what_the_kernels_do_not_serve():
    dims, block = SHAPES["padded"]
    comp = by_name("hszp_nd", block)
    c = comp.compress(_raw(dims, 0), rel_eb=1e-3, device="cpu")
    e = comp.encode(c)
    assert _rule().covers(_ctx(e))
    assert _rule(Stage.F).covers(_ctx(e, Stage.F))
    assert not _rule().covers(_ctx(c))  # a Compressed container
    assert not _rule().covers(_ctx(e, region=((2, 12), (3, 20), (4, 30))))
    assert not _rule().covers(_ctx(e, seed=materialize(e, Stage.P)))
    assert not _rule(Stage.Q).covers(
        _ctx(e, Stage.Q, seed=materialize(e, Stage.Q)))
    for bits in (0, 32):
        assert not _rule().covers(_ctx(dataclasses.replace(e, bits=bits)))
    bm = by_name("hszx_nd", block)
    x = bm.encode(bm.compress(_raw(dims, 0), rel_eb=1e-3, device="cpu"))
    assert not fused_mod.DERIVATIVE[(Stage.P, "blockmean")].covers(_ctx(x))


#: (valid shape, the axes the kernels take): interior rows of 1032 columns
#: pass the plane kernels' widest (axes 0, 1); 514 interior rows of axis 1
#: pass the lane kernel's most (axis 2)
WIDE = {"columns": ((4, 4, 1034), (2,)), "rows": ((4, 516, 4), (0, 1))}


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("wide", sorted(WIDE))
def test_an_axis_wider_than_the_kernels_runs_the_torch_ops(wide, axis):
    """The field is covered; an axis the kernels do not take runs the torch
    rule's ops under one ``hsz.op.torch`` span, the others none.  Bitwise
    the torch rule either way."""
    dims, fits = WIDE[wide]
    f = _field(dims, (1, 1, 1), 9, 0)
    assert fused.lorenzo3d_fits(f.shape, axis) == (axis in fits)
    assert _rule().covers(_ctx(f))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            got = _derivative(f, Stage.P, axis)
    spans = sum(e.name == "hsz.op.torch" for e in prof.events())
    assert spans == (axis not in fits)
    with ops.override_mode("off"):
        _bitwise(got, _derivative(f, Stage.P, axis))


# ===========================================================================
# the kernels on the card against the plain version
# ===========================================================================

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _words(lead, padded, bits, seed, dev):
    n = -(-padded[0] * padded[1] * padded[2] * bits // 32)
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-2**31, 2**31, lead + (n,), generator=g,
                         dtype=torch.int64).to(torch.int32).to(dev)


#: (shape, padded layout, bits, batch): Miranda's shape with B = 16, the
#: odd and padded shapes above, the widths of the CPU tests
CARD_CASES = [((256, 384, 384), (256, 384, 384), 9, 16),
              ((13, 21, 37), (13, 21, 37), 1, 1),
              ((13, 21, 37), (13, 21, 37), 31, 1),
              ((20, 27, 33), (24, 32, 40), 9, 3)]


@pytest.mark.gpu
@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("shape,padded,bits,batch", CARD_CASES,
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else str(v))
def test_lorenzo_enc3d_matches_plain_on_card(shape, padded, bits, batch, axis):
    dev = _card()
    lead = (batch,) if batch > 1 else ()
    words = _words(lead, padded, bits, sum(shape) + bits, dev)
    eps = (torch.rand(lead, generator=torch.Generator().manual_seed(bits))
           * 1e-2 + 1e-4).to(dev)
    before = dict(ops.LAUNCHES)
    got = fused.lorenzo_enc3d(words, padded, shape, bits, axis, eps)
    assert ops.LAUNCHES["lorenzo_enc3d.stencil"] == \
        before["lorenzo_enc3d.stencil"] + 1
    assert ops.LAUNCHES["lorenzo_enc3d.edges"] == \
        before["lorenzo_enc3d.edges"] + (axis == 2)
    torch.cuda.synchronize()
    for b in range(batch):   # field by field: the plain version's int64
        w = words[b] if lead else words
        e = eps[b] if lead else eps
        _bitwise(got[b] if lead else got,
                 fused.lorenzo_enc3d_plain(w, padded, shape, bits, axis, e))


@pytest.mark.gpu
def test_lorenzo_enc3d_rejects_bad_payloads_on_card():
    dev = _card()
    shape = (13, 21, 37)
    words = _words((), shape, 9, 0, dev)
    eps = torch.tensor(1e-3, device=dev)
    with pytest.raises(ValueError):          # not contiguous
        fused.lorenzo_enc3d(torch.stack([words, words], 1)[:, 0], shape,
                            shape, 9, 0, eps)
    with pytest.raises(TypeError):           # not int32
        fused.lorenzo_enc3d(words.to(torch.int64), shape, shape, 9, 0, eps)
    with pytest.raises(ValueError):          # too short
        fused.lorenzo_enc3d(words[:-1], shape, shape, 9, 0, eps)
    with pytest.raises(ValueError):          # wider than the kernels take
        fused.lorenzo_enc3d(_words((), (3, 3, 771), 9, 0, dev), (3, 3, 771),
                            (3, 3, 771), 9, 0, eps)


@pytest.mark.gpu
def test_the_served_rule_launches_the_kernels_on_card():
    """A rank-3 derivative, divergence and curl at ② on the card: the
    kernels, bitwise the torch rules, and no torch rule under the span."""
    dev = _card()
    dims, block = SHAPES["padded"]
    fields = []
    for i in range(3):
        f = _field(dims, block, 9, i)
        fields.append(dataclasses.replace(
            f, payload=f.payload.to(dev), metadata=f.metadata.to(dev),
            bitwidths=f.bitwidths.to(dev), eps=f.eps.to(dev),
            valid_counts=f.valid_counts.to(dev)))
    for stage in STAGES:
        for axis in range(3):
            before = ops.LAUNCHES["lorenzo_enc3d.stencil"]
            got, want = _both(fields[0], stage, axis)
            torch.cuda.synchronize()
            _bitwise(got, want)
        got = oplib.compute(fields, "curl", stage)["curl"]
        with ops.override_mode("off"):
            want = oplib.compute(fields, "curl", stage)["curl"]
        for g, x in zip(got, want):
            _bitwise(g, x)
    assert ops.LAUNCHES["lorenzo_enc3d.stencil"] > before
