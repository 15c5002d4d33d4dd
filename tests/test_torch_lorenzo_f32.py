"""The 2-D Lorenzo stencil pass's f32 epilogue and the accumulated vector
compositions.

On the CPU the wrappers (``kernels.fused.lorenzo2d`` / ``lorenzo_enc2d``
with ``eps``) run their plain versions: the int32 planes, then
``lorenzo_scale_plain``.  Those equal the tail the lowering rules ran in
torch, ``plane.float() * eps`` and its ``+`` / ``-``, bit for bit: every
``what``, both containers, a lone field and a batch whose fields carry
their own eps, in every mode.  The rules (derivative, gradient, laplacian;
full field and a region window) and the 2-D divergence and curl, served by
the frontend, through ``oplib.compute`` and through ``expr.lower``, equal
``override_mode("off")`` bit for bit, and ``kernels.ops.TAILS`` says where
each float tail ran.  The ``gpu``-marked tests hold each kernel mode to its
plain version on the card (Ocean's size, a batch of 16, tiles cut off at
ragged edges, accumulation onto random values) and check that the served
Ocean ``multi`` path runs no torch float tail.
"""
import warnings

import numpy as np
import pytest
import torch

from repro_torch.core import Stage, by_name, encode, expr, oplib
from repro_torch.core.stages import batch_stack
from repro_torch.kernels import fused, ops
from repro_torch.serve import AnalyticsFrontend, AnalyticsRequest
from repro_torch.store import FieldStore, materialize

SHAPE = (37, 70)
BLOCK = (8, 8)
REGION = ((5, 29), (9, 61))
VECTOR_OPS = ("divergence", "curl")


def _raw(shape, i: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(500 + i)
    return (torch.randn(shape, generator=g).cumsum(0).cumsum(1) * 0.1
            * (1 + i))


def _field(scheme: str, i: int, container: str, shape=SHAPE):
    """A compressed field; encoded at 16 bits, so that any of them stack."""
    comp = by_name(scheme, BLOCK)
    c = comp.compress(_raw(shape, i), rel_eb=1e-3, device="cpu")
    return comp.encode(c, bits=16) if container == "Encoded" else c


def _bitwise(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.float32
        assert g.shape == w.shape
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


def _packed(p: torch.Tensor, bits: int) -> torch.Tensor:
    """Each plane of ``p`` zigzagged and packed at ``bits``: one payload row
    a plane."""
    return torch.stack([encode.pack_uniform(encode.zigzag(x.reshape(-1)), bits)
                        for x in p.reshape((-1,) + tuple(p.shape[-2:]))])


def _planes(batch: bool, bits: int = 9):
    """``(residual planes, payload, shape, eps)``: one (37, 70) plane, or a
    batch of three with eps of different sizes."""
    g = torch.Generator().manual_seed(7)
    n = 3 if batch else 1
    lim = 1 << (bits - 1)
    p = torch.randint(-lim, lim, (n,) + SHAPE, generator=g, dtype=torch.int32)
    words = _packed(p, bits)
    eps = torch.tensor([1e-3, 3.7e-2, 5.5][:n], dtype=torch.float32)
    if not batch:
        return p[0], words[0], SHAPE, eps[0]
    return p, words, SHAPE, eps


def _wrapper(container: str, p, words, shape, bits=9):
    if container == "payload":
        return lambda **kw: fused.lorenzo_enc2d(words, shape, bits, **kw)
    return lambda **kw: fused.lorenzo2d(p, **kw)


def _torch_tail(planes, eps):
    """The rules' tail as torch ran it: ``plane.float() * eps`` with eps
    broadcast over each field's plane."""
    scale = eps.reshape(eps.shape + (1, 1)) if eps.ndim else eps
    if isinstance(planes, tuple):
        return tuple(d.to(torch.float32) * scale for d in planes)
    return planes.to(torch.float32) * scale


@pytest.mark.parametrize("batch", [False, True], ids=["one", "batch3"])
@pytest.mark.parametrize("container", ["payload", "plane"])
@pytest.mark.parametrize("what", fused.LORENZO_WHATS)
def test_write_mode_plain_is_the_torch_tail(what, container, batch):
    p, words, shape, eps = _planes(batch)
    run = _wrapper(container, p, words, shape)
    ints = run(what=what)
    _bitwise(run(what=what, eps=eps), _torch_tail(ints, eps))
    # the laplacian's 2 eps, as the rule passes it
    _bitwise(run(what=what, eps=2.0 * eps), _torch_tail(ints, 2.0 * eps))
    # the window interior of the plane is the tail of the window interior
    w = (slice(4, 30), slice(9, 61))
    got = run(what=what, eps=eps)
    got = got if isinstance(got, tuple) else (got,)
    ints = ints if isinstance(ints, tuple) else (ints,)
    for g, d in zip(got, ints):
        _bitwise(g[(Ellipsis,) + w], _torch_tail(d[(Ellipsis,) + w], eps))


@pytest.mark.parametrize("batch", [False, True], ids=["one", "batch3"])
@pytest.mark.parametrize("container", ["payload", "plane"])
@pytest.mark.parametrize("mode", ["add", "sub"])
@pytest.mark.parametrize("what", ["deriv0", "deriv1"])
def test_accumulate_modes_plain_are_the_torch_tail(what, mode, container,
                                                   batch):
    p, words, shape, eps = _planes(batch)
    run = _wrapper(container, p, words, shape)
    g = torch.Generator().manual_seed(11)
    prior = torch.randn(tuple(p.shape), generator=g) * 3.0
    term = _torch_tail(run(what=what), eps)
    want = prior + term if mode == "add" else prior - term
    out = prior.clone()
    got = run(what=what, eps=eps, mode=mode, out=out)
    assert got is out  # in place
    _bitwise(got, want)


def test_modes_are_checked():
    p, words, shape, eps = _planes(False)
    out = torch.zeros(shape)
    for kw in ({"mode": "add"}, {"mode": "mix", "eps": eps},
               {"mode": "add", "eps": eps},
               {"mode": "add", "eps": eps, "out": out, "what": "grad"},
               {"mode": "write", "eps": eps, "out": out},
               {"out": out}):
        kw = {"what": "deriv0", **kw}
        with pytest.raises(ValueError):
            fused.lorenzo2d(p, **kw)
        with pytest.raises(ValueError):
            fused.lorenzo_enc2d(words, shape, 9, **kw)


def _off(fn):
    with ops.override_mode("off"):
        return fn()


def _target(container: str, batch: bool, offset: int = 0):
    fields = [_field("hszp_nd", offset + i, container)
              for i in range(3 if batch else 1)]
    return batch_stack(fields) if batch else fields[0]


@pytest.mark.parametrize("region", [None, REGION], ids=["full", "region"])
@pytest.mark.parametrize("batch", [False, True], ids=["one", "batch3"])
@pytest.mark.parametrize("container", ["Encoded", "Compressed"])
@pytest.mark.parametrize("op,axis", [("derivative", 0), ("derivative", 1),
                                     ("gradient", 0), ("laplacian", 0)])
def test_rules_equal_the_torch_rules(op, axis, container, batch, region):
    target = _target(container, batch)
    run = lambda: oplib.compute(target, op, Stage.P, axis=axis,  # noqa: E731
                                region=region)[op]
    ops.reset_tails()
    got = run()
    assert ops.TAILS == {"kernel": 2 if op == "gradient" else 1, "torch": 0}
    ops.reset_tails()
    _bitwise(got, _off(run))
    assert ops.TAILS == {"kernel": 0, "torch": 2 if op == "gradient" else 1}


#: float tails of one derivative-family op: one an output
TAIL_OPS = {"derivative": 1, "gradient": 2, "laplacian": 1}


@pytest.mark.parametrize("mode", ["on", "off"])
@pytest.mark.parametrize("stage", ["P", "Q", "F", "Q seeded"])
@pytest.mark.parametrize("scheme", ["hszp_nd", "hszx_nd"])
@pytest.mark.parametrize("op", sorted(TAIL_OPS))
def test_every_derivative_rule_counts_its_tail(op, scheme, stage, mode):
    """Every derivative-family rule, fused or torch, of each stage, family
    and ③ seed counts one float tail an output in ``TAILS``: a rule that
    lost its count reads short.  (A fused seeded derivative scales both of
    the gradient kernel's outputs and keeps one: two.)"""
    f = _field(scheme, 0, "Encoded")
    kw = {}
    if stage == "Q seeded":
        kw["seed"] = materialize(f, Stage.Q)
    ops.reset_tails()
    with ops.override_mode(mode):
        oplib.compute(f, op, Stage[stage[0]], axis=1, **kw)
    seeded_deriv = (op, stage, mode) == ("derivative", "Q seeded", "on")
    assert sum(ops.TAILS.values()) == (2 if seeded_deriv else TAIL_OPS[op])


@pytest.mark.parametrize("stage", [Stage.P, Stage.Q, Stage.F],
                         ids=lambda s: s.name)
@pytest.mark.parametrize("batch", [False, True], ids=["one", "batch3"])
@pytest.mark.parametrize("container", ["Encoded", "Compressed"])
@pytest.mark.parametrize("op", VECTOR_OPS)
def test_vector_ops_accumulate_in_the_epilogue(op, container, batch, stage):
    """Both terms take the Lorenzo rule: the first written, the second added
    (divergence) or subtracted (curl) in the epilogue, bitwise the torch
    rules' ``t0 + t1`` / ``dv/dx - du/dy``."""
    comps = [_target(container, batch, 0), _target(container, batch, 3)]
    run = lambda: oplib.compute(comps, op, stage)[op]  # noqa: E731
    modes = []
    real = {n: getattr(fused, n) for n in ("lorenzo2d", "lorenzo_enc2d")}

    def spy(name):
        def call(*a, **kw):
            modes.append(kw.get("mode"))
            return real[name](*a, **kw)
        return call

    ops.reset_tails()
    with pytest.MonkeyPatch.context() as mp:
        for n in real:
            mp.setattr(fused, n, spy(n))
        got = run()
    assert modes == ["write", "add" if op == "divergence" else "sub"]
    assert ops.TAILS == {"kernel": 3, "torch": 0}
    ops.reset_tails()
    _bitwise(got, _off(run))
    assert ops.TAILS == {"kernel": 0, "torch": 3}


@pytest.mark.parametrize("op", VECTOR_OPS)
def test_vector_ops_through_expr_lower(op):
    comps = (_field("hszp_nd", 0, "Encoded"), _field("hszp_nd", 3, "Encoded"))
    node = expr.op(op, expr.leaf(comps)) + expr.op(op, expr.leaf(comps))
    for stage in (Stage.P, Stage.Q):
        # the node's value feeds a sum: the expression's value is 2x it
        run = lambda: oplib.compute_exprs(node, stage)  # noqa: E731
        ops.reset_tails()
        got = run()
        assert ops.TAILS == {"kernel": 3, "torch": 0}
        _bitwise(got, _off(run))


#: TAILS of one 2-D divergence or curl whose sum stays in torch: block-mean
#: terms; a Lorenzo term (its own epilogue) and a block-mean one; region
#: windows, where the components' closures (axis 0 vs 1) gather planes of
#: different shapes; stage-③ seeds (both differences of each term, as
#: before); the fused rules off
TORCH_SUM = {"blockmean": {"kernel": 0, "torch": 3},
             "mixed": {"kernel": 1, "torch": 2},
             "region": {"kernel": 2, "torch": 1},
             "seeded3": {"kernel": 0, "torch": 5},
             "off": {"kernel": 0, "torch": 3}}


@pytest.mark.parametrize("case", sorted(TORCH_SUM))
def test_vector_ops_keep_the_torch_sum_elsewhere(case):
    """Where a term leaves the 2-D Lorenzo rule, or the terms' planes
    differ, the sum runs in torch as before: bitwise the torch rules."""
    u = _field("hszp_nd", 0, "Encoded")
    v = _field("hszp_nd", 3, "Encoded")
    kw, stage = {}, Stage.P
    if case == "blockmean":
        u, v = (_field("hszx_nd", i, "Encoded") for i in (0, 3))
    if case == "mixed":
        v = _field("hszx_nd", 3, "Encoded")
    if case == "region":
        kw["region"] = REGION
    if case == "seeded3":
        kw["seed"] = [materialize(c, Stage.Q) for c in (u, v)]
        stage = Stage.Q
    for op in VECTOR_OPS:
        run = lambda: oplib.compute([u, v], op, stage, **kw)[op]  # noqa: E731
        ops.reset_tails()
        got = _off(run) if case == "off" else run()
        assert ops.TAILS == TORCH_SUM[case]
        _bitwise(got, _off(run))


# -- served ----------------------------------------------------------------

def _serve(encoded: dict, kinds, device="cpu"):
    store = FieldStore(cache_bytes=0)
    for fid, e in encoded.items():
        store.put(fid, e)
    fe = AnalyticsFrontend(store=store)
    for i, (op, axis, ids) in enumerate(kinds):
        fe.add_request(AnalyticsRequest(uid=i, fields=ids, op=op, axis=axis,
                                        stage="auto"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        done = fe.step()
    assert all(r.error is None for r in done), [r.error for r in done]
    return {r.uid: r.result for r in done}


def _multi_kinds(n: int = 3):
    return [(op, 0, ("u", "v")) for op in VECTOR_OPS for _ in range(n)]


@pytest.mark.parametrize("scheme", ["hszp_nd", "hszx_nd"])
def test_served_multi_group(scheme):
    """A step of divergence and curl requests over (u, v): a Lorenzo group
    runs every float tail in the epilogue, a block-mean group every one in
    torch; the answers equal the fused rules off."""
    encoded = {fid: _field(scheme, i, "Encoded")
               for i, fid in enumerate(("u", "v"))}
    ops.reset_tails()
    got = _serve(encoded, _multi_kinds())
    tails = dict(ops.TAILS)
    want = _off(lambda: _serve(encoded, _multi_kinds()))
    if scheme == "hszp_nd":
        assert tails["torch"] == 0 and tails["kernel"] > 0
    else:
        assert tails["kernel"] == 0 and tails["torch"] > 0
    for uid, r in got.items():
        _bitwise(r, want[uid])


# -- on the card -----------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


#: (shape, batch, bits): Ocean with 16 fields and alone, and planes whose
#: rows and columns end off the 32 x 128 tile and the 16-byte stores
CARD_CASES = [((2400, 3600), 16, 9), ((2400, 3600), 1, 9),
              ((2401, 3599), 3, 13), ((33, 129), 2, 31), ((31, 127), 1, 7),
              ((5, 4099), 4, 1)]


def _card_planes(shape, batch, bits, dev):
    rng = np.random.default_rng(shape[0] * 7 + batch + bits)
    lim = 1 << (bits - 1)
    lead = (batch,) if batch > 1 else ()
    p = torch.as_tensor(rng.integers(-lim, lim, lead + shape, dtype=np.int64)
                        .astype(np.int32), device=dev)
    words = _packed(p, bits)
    words = words if lead else words[0]
    eps = torch.as_tensor(rng.uniform(1e-4, 1.0, batch).astype(np.float32),
                          device=dev)
    return p, words, eps if lead else eps[0]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,batch,bits", CARD_CASES,
                         ids=[f"{s[0]}x{s[1]}-B{b}-{k}bits"
                              for s, b, k in CARD_CASES])
def test_f32_modes_match_plain_on_card(shape, batch, bits):
    dev = _card()
    p, words, eps = _card_planes(shape, batch, bits, dev)
    rng = torch.Generator(device=dev).manual_seed(batch)
    for container in ("payload", "plane"):
        run = _wrapper(container, p, words, shape, bits)
        plain = (fused.lorenzo_enc2d_plain if container == "payload" else
                 None)
        for what in fused.LORENZO_WHATS:
            ints = (plain(words, shape, bits, what=what) if plain else
                    fused.lorenzo_core(p, what))
            _bitwise(run(what=what, eps=eps),
                     fused.lorenzo_scale_plain(ints, eps))
            if what in ("deriv0", "deriv1"):
                for mode in ("add", "sub"):
                    prior = torch.randn(tuple(p.shape), generator=rng,
                                        device=dev) * 100.0
                    want = fused.lorenzo_scale_plain(ints, eps, mode,
                                                     prior.clone())
                    got = run(what=what, eps=eps, mode=mode, out=prior)
                    torch.cuda.synchronize()
                    _bitwise(got, want)
            del ints
        torch.cuda.empty_cache()


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["derivative", "gradient", "laplacian",
                                "divergence", "curl"])
def test_served_rules_equal_the_torch_rules_on_card(op):
    """The rules and compositions on the card, lone and batched, payload and
    residual planes, bitwise ``override_mode("off")``."""
    dev = _card()
    shape = (241, 363)
    comp = by_name("hszp_nd", (16, 16))
    fields = {}
    for container in ("Encoded", "Compressed"):
        cs = [comp.compress(_raw(shape, i).to(dev), rel_eb=1e-3, device=dev)
              for i in range(6)]
        fields[container] = ([comp.encode(c, bits=16) for c in cs]
                             if container == "Encoded" else cs)
    for container, fs in fields.items():
        for batch in (False, True):
            u = batch_stack(fs[:3]) if batch else fs[0]
            v = batch_stack(fs[3:]) if batch else fs[3]
            target = [u, v] if op in VECTOR_OPS else u
            run = lambda: oplib.compute(target, op, Stage.P)[op]  # noqa: E731
            _bitwise(run(), _off(run))


@pytest.mark.gpu
def test_served_ocean_multi_runs_no_torch_tail_on_card():
    dev = _card()
    comp = by_name("hszp_nd", (16, 16))
    encoded = {fid: comp.encode(comp.compress(
        _raw((2400, 3600), i).to(dev), rel_eb=1e-3, device=dev), bits=9)
        for i, fid in enumerate(("u", "v"))}
    ops.reset_tails()
    got = _serve(encoded, _multi_kinds(8))
    assert ops.TAILS["torch"] == 0 and ops.TAILS["kernel"] == 2 * 3
    want = _off(lambda: _serve(encoded, _multi_kinds(8)))
    for uid, r in got.items():
        _bitwise(r, want[uid])
