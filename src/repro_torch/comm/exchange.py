"""Peer exchanges over one mesh axis, as ``jax.lax`` defines them, and the
counters the dry run reads.

A peer axis is a list: item ``i`` is peer ``i``'s tensor, on its own
device (a device may repeat).  One controller drives every peer, as the
sharded store and the ``hom`` step do (``repro_torch/shard/exec.py``,
``comm/hom_collectives.py``), so an exchange is a set of ``.to(device)``
copies and no process group is involved:

* :func:`all_to_all` is ``lax.all_to_all(x, axis, 0, 0, tiled=True)``:
  every peer splits its tensor into ``n`` equal chunks along dim 0, and
  chunk ``i`` of peer ``j`` lands on peer ``i``'s device at position ``j``;
* :func:`all_gather` is ``lax.all_gather(x, axis, axis=0, tiled=True)``:
  every peer receives the peers' tensors concatenated along dim 0;
* :func:`all_reduce` is ``lax.psum``: every peer receives the sum.

All three count one call per exchange under its HLO name, with the bytes
one peer receives (the per-device output, as
``repro/launch/hlo_analysis.py`` counts a collective); :func:`record`
counts the ``hom`` collectives' int16 sums and all-gathers the same way.
The all-to-all and the all-gather are differentiable: their backward is
the transposed exchange (an all-to-all; a reduce-scatter), counted too.
Work an exchange issues (slices, copies, concatenations) runs under
:data:`IN_COLLECTIVE`, which the dry run's op counter skips, as the
reference's byte count skips collectives.

:func:`map_peers` runs one function per peer.  Under :func:`symmetric_peers`
(the dry run, on ``meta`` tensors, whose peers all do work of the same
shapes) it runs peer 0's alone and hands its result to every peer; the op
counter weighs what peer 0 did by the number of peers
(:data:`PEER_WEIGHT`), in the forward and, through hooks on the autograd
nodes it made, in the backward.
"""
from __future__ import annotations

import contextlib
from collections.abc import Callable

import torch

#: collective kind (HLO name) -> {"count": calls, "bytes": per-peer bytes}
COUNTS: dict[str, dict[str, int]] = {}
#: True while an exchange issues its copies (the op counter skips them)
IN_COLLECTIVE = False
#: how many peers the work being issued stands for (the op counter's weight)
PEER_WEIGHT = 1
#: how many sequential calls the exchanges being issued stand for
REPEATS = 1
_SYMMETRIC = False


def record(kind: str, nbytes: int) -> None:
    """Count one collective of ``kind`` whose per-peer output is ``nbytes``
    (``REPEATS`` times: see :func:`map_peers`)."""
    c = COUNTS.setdefault(kind, {"count": 0, "bytes": 0})
    c["count"] += REPEATS
    c["bytes"] += int(nbytes) * REPEATS


def reset_counts() -> None:
    COUNTS.clear()


def counts() -> dict[str, dict[str, int]]:
    """A copy of the counters."""
    return {k: dict(v) for k, v in COUNTS.items()}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@contextlib.contextmanager
def _collective():
    global IN_COLLECTIVE
    old, IN_COLLECTIVE = IN_COLLECTIVE, True
    try:
        yield
    finally:
        IN_COLLECTIVE = old


@contextlib.contextmanager
def symmetric_peers():
    """Within the block, :func:`map_peers` over ``meta`` tensors runs peer
    0 alone and the exchanges copy peer 0's tensor (the dry run)."""
    global _SYMMETRIC
    old, _SYMMETRIC = _SYMMETRIC, True
    try:
        yield
    finally:
        _SYMMETRIC = old


def _symmetric(items) -> bool:
    """Symmetric mode applies: on, and every tensor (in nested containers)
    or device among ``items`` (at least one) is ``meta``."""
    if not _SYMMETRIC:
        return False
    devs = [t.device for t in tensors_of(items)] + [
        x for x in items if isinstance(x, torch.device)]
    return bool(devs) and all(d.type == "meta" for d in devs)


def tensors_of(x) -> list[torch.Tensor]:
    """The tensors in nested lists / tuples / dicts / dataclasses.  A loop,
    not a recursive closure: that would be a reference cycle holding the
    tensors until the garbage collector runs (the op counter's live bytes
    would count them)."""
    out, todo = [], [x]
    while todo:
        y = todo.pop()
        if isinstance(y, torch.Tensor):
            out.append(y)
        elif isinstance(y, (list, tuple)):
            todo.extend(y)
        elif isinstance(y, dict):
            todo.extend(y.values())
        elif hasattr(y, "__dataclass_fields__"):
            todo.extend(vars(y).values())
    return out


def _next_sequence_nr() -> int:
    """The sequence number the next autograd node made on this thread
    takes."""
    with _collective():
        t = torch.empty((), device="meta", requires_grad=True).clone()
    return t.grad_fn._sequence_nr() + 1


def _weigh_backward(out, first_nr: int, weight: int) -> None:
    """Weigh the backward of every autograd node made since ``first_nr``
    that ``out`` depends on: its hooks set :data:`PEER_WEIGHT` while it
    runs (the engine runs one node at a time on a thread)."""
    def pre(grad_outputs):
        global PEER_WEIGHT
        _WEIGHTS.append(PEER_WEIGHT)
        PEER_WEIGHT = weight

    def post(grad_inputs, grad_outputs):
        global PEER_WEIGHT
        PEER_WEIGHT = _WEIGHTS.pop()

    seen: set = set()
    todo = [t.grad_fn for t in tensors_of(out) if t.grad_fn is not None]
    while todo:
        node = todo.pop()
        if (node is None or node in seen or node._sequence_nr() < first_nr
                or type(node).__name__ == "AccumulateGrad"):
            continue
        seen.add(node)
        node.register_prehook(pre)
        node.register_hook(post)
        todo.extend(f for f, _ in node.next_functions)


_WEIGHTS: list[int] = []


def _clone(x):
    """A copy of nested lists / tuples / dicts of tensors (new storage)."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, (list, tuple)):
        return type(x)(_clone(y) for y in x)
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    return x


def map_peers(fn: Callable, *per_peer, sequential: bool = False) -> list:
    """``[fn(*args) for args in zip(*per_peer)]``; under
    :func:`symmetric_peers` with ``meta`` tensors, ``[fn(*peer 0's args)] *
    n``, peer 0's work, forward and backward, weighed by ``n``.

    ``sequential`` calls run one after another on one device, each result
    held (a train step's microbatches).  In symmetric mode the first call
    runs alone, ``n - 2`` copies of its result stand for the middle ones
    (their memory, uncounted as work), and a last call, weighed by ``n -
    1`` with its exchanges counted ``n - 1`` times (a device issues each
    call's own), runs beside them: the peak of the full loop, at the
    cost of two calls."""
    global PEER_WEIGHT, REPEATS
    n = len(per_peer[0])
    first = [a[0] for a in per_peer]
    if not _symmetric(first):
        return [fn(*args) for args in zip(*per_peer)]
    if sequential:
        if n == 1:
            return [fn(*first)]
        outs = [fn(*first)]
        with _collective():
            outs += [_clone(outs[0]) for _ in range(n - 2)]
        old, old_r = PEER_WEIGHT, REPEATS
        PEER_WEIGHT, REPEATS = old * (n - 1), old_r * (n - 1)
        try:
            outs.append(fn(*first))
        finally:
            PEER_WEIGHT, REPEATS = old, old_r
        return outs
    first_nr = _next_sequence_nr()
    old, PEER_WEIGHT = PEER_WEIGHT, PEER_WEIGHT * n
    try:
        out = fn(*first)
    finally:
        PEER_WEIGHT = old
    if torch.is_grad_enabled():
        _weigh_backward(out, first_nr, old * n)
    return [out] * n


@contextlib.contextmanager
def weight(w: int):
    """Within the block :data:`PEER_WEIGHT` is ``w``."""
    global PEER_WEIGHT
    old, PEER_WEIGHT = PEER_WEIGHT, w
    try:
        yield
    finally:
        PEER_WEIGHT = old


def _a2a(xs) -> list[torch.Tensor]:
    n = len(xs)
    c = xs[0].shape[0] // n
    with _collective():
        out = [torch.cat([xs[j][i * c:(i + 1) * c].to(xs[i].device)
                          for j in range(n)]) for i in range(n)]
    record("all-to-all", _nbytes(out[0]))
    return out


def _gather(xs) -> list[torch.Tensor]:
    with _collective():
        out = [torch.cat([x.to(y.device) for x in xs]) for y in xs]
    record("all-gather", _nbytes(out[0]))
    return out


def _scatter_sum(gs, like) -> list[torch.Tensor]:
    """Reduce-scatter on dim 0: peer ``j`` receives chunk ``j`` of the sum
    of the peers' tensors (the transpose of a tiled all-gather)."""
    n = len(like)
    c = gs[0].shape[0] // n
    with _collective():
        out = []
        for j, x in enumerate(like):
            acc = gs[0][j * c:(j + 1) * c].to(x.device)
            for g in gs[1:]:
                acc = acc + g[j * c:(j + 1) * c].to(x.device)
            out.append(acc)
    record("reduce-scatter", _nbytes(out[0]))
    return out


class _AllToAll(torch.autograd.Function):
    """Tiled all-to-all; its transpose is itself."""

    @staticmethod
    def forward(ctx, *xs):
        return tuple(_a2a(xs))

    @staticmethod
    def backward(ctx, *gs):
        return tuple(_a2a(gs))


class _AllGather(torch.autograd.Function):
    """Tiled all-gather; its transpose is a reduce-scatter."""

    @staticmethod
    def forward(ctx, *xs):
        ctx.like = [torch.empty((0,), device=x.device) for x in xs]
        return tuple(_gather(xs))

    @staticmethod
    def backward(ctx, *gs):
        return tuple(_scatter_sum(gs, ctx.like))


class _Symmetric(torch.autograd.Function):
    """Peer 0's side of an exchange among symmetric ``meta`` peers: a new
    tensor of the received shape (``n`` copies of ``x`` stacked on dim 0 for
    an all-gather), whose transpose is recorded in the backward."""

    @staticmethod
    def forward(ctx, x, n: int, kind: str):
        ctx.n, ctx.kind = n, kind
        with _collective():
            out = x.clone() if kind == "all-to-all" else torch.cat([x] * n)
        record(kind, _nbytes(out))
        return out

    @staticmethod
    def backward(ctx, g):
        with _collective():
            if ctx.kind == "all-to-all":
                out = g.clone()
            else:
                c = g.shape[0] // ctx.n
                out = sum(g[j * c:(j + 1) * c] for j in range(1, ctx.n)) + g[:c]
        record("all-to-all" if ctx.kind == "all-to-all" else "reduce-scatter",
               _nbytes(out))
        return out, None, None


def all_to_all(xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """Tiled all-to-all on dim 0: peer ``i`` receives chunk ``i`` of every
    peer ``j`` at position ``j``, on its own device."""
    n = len(xs)
    rows = xs[0].shape[0]
    if rows % n or any(x.shape != xs[0].shape for x in xs):
        raise ValueError(f"all_to_all over {n} peers needs equal shapes with "
                         f"dim 0 divisible by {n}, got "
                         f"{[tuple(x.shape) for x in xs]}")
    if _symmetric(xs):
        return [_Symmetric.apply(xs[0], n, "all-to-all")] * n
    return list(_AllToAll.apply(*xs))


def all_reduce(xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """Sum over the peers (``lax.psum``), added in peer order on peer 0's
    device; every peer receives the sum on its own device."""
    n = len(xs)
    with _collective():
        if _symmetric(xs):
            total = xs[0].clone()
        else:
            total = xs[0]
            for x in xs[1:]:
                total = total + x.to(total.device)
        out = [total.to(x.device) for x in xs]
    record("all-reduce", _nbytes(out[0]))
    return out


def all_gather(xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """Tiled all-gather on dim 0: every peer receives the peers' tensors
    concatenated in peer order, on its own device."""
    if _symmetric(xs):
        return [_Symmetric.apply(xs[0], len(xs), "all-gather")] * len(xs)
    return list(_AllGather.apply(*xs))
