"""Operation counts of a step run eagerly on ``meta`` tensors: the port's
counterpart of ``repro/launch/hlo_analysis.py``.

The reference parses the post-SPMD HLO text of a compiled program.  The
port compiles nothing, so there is no HLO and its text parser does not
apply.  Instead :class:`OpCounter`, a ``TorchDispatchMode``, sees every aten
op a step issues on ``meta`` tensors (no storage, no card): the forward, the
remat recomputation, autograd's backward and the optimizer.  Every layer
and every combine gather runs eagerly, so loop trip counts come for free:
each iteration is dispatched and counted, where the reference multiplies a
``while`` body by its trip count.  Expert peers and microbatches, whose
iterations do work of one shape, may run as one weighed by their count
(``comm.exchange.symmetric_peers``, the dry run).

What it counts, under the reference's output keys:

* ``dot_flops``: 2·M·N·K over ``mm``, ``addmm``, ``bmm`` and ``baddbmm``
  (``x @ w`` and the attention's einsums lower to them), plus ``mv`` /
  ``dot`` and ``convolution`` (2 · output elements · input channels per
  group · kernel elements);
* ``bytes_proxy``: each op's output bytes, except the reference's
  ``ELEMENTWISE`` ops mapped to their aten names (:data:`ELEMENTWISE`) and
  metadata-only views (:data:`VIEWS`); a matmul adds its operands' bytes;
  an in-place or out-of-place slice write (``index_put_``, ``index_copy``,
  ``slice_scatter``, ... — the KV cache's ``_cache_write``) adds the written
  slice, not the buffer (``hlo_analysis.py:165-175``);
* ``collectives``: ``comm.exchange``'s counters over the step, by kind, with
  ``count``, ``bytes`` and ``wire_bytes`` (an all-reduce moves its bytes
  twice), and ``wire_bytes_total``;
* ``peak_live_bytes``: the peak of the live bytes of the storages the step
  makes (a storage first seen as an op's input, such as a parameter or the
  batch, is the caller's and is not counted), optionally each at a
  per-shape share (``shares``: the bytes of a tensor of that shape, or of
  that shape under one more leading dim, count divided by its share);
  ``end_live_bytes``: what is live after the step.

Ops that ``comm.exchange`` issues inside an exchange are skipped (the
reference's byte count skips collectives), and ops issued for a peer under
``exchange.symmetric_peers()`` are weighed by the number of peers that peer
stands for.
"""
from __future__ import annotations

import math

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode

from ..comm import exchange

#: the reference's ``ELEMENTWISE`` set (ops whose outputs stay on chip under
#: fusion), as aten op names (``OpOverloadPacket`` names)
ELEMENTWISE = frozenset({
    "add", "add_", "sub", "sub_", "rsub", "mul", "mul_", "div", "div_",
    "maximum", "minimum", "clamp_min", "clamp_max", "neg", "abs", "exp",
    "expm1", "log", "log1p", "tanh", "sigmoid", "rsqrt", "sqrt", "pow",
    "where", "eq", "ne", "lt", "le", "gt", "ge", "logical_and", "logical_or",
    "logical_xor", "logical_not", "bitwise_and", "bitwise_or", "bitwise_xor",
    "bitwise_not", "__lshift__", "__rshift__", "bitwise_left_shift",
    "bitwise_right_shift", "_to_copy", "expand", "arange", "view",
    "_unsafe_view", "reshape", "round", "floor", "ceil", "sign", "clamp",
    "clamp_", "isfinite", "sin", "cos", "remainder", "floor_divide",
    "atan2", "constant_pad_nd", "slice", "cat", "flip", "fill_", "fill",
    "masked_fill", "masked_fill_", "silu", "gelu", "reciprocal", "square",
    "lerp", "addcmul", "addcdiv", "softplus", "exp2", "copysign", "trunc",
    "_log_softmax_backward_data", "silu_backward", "gelu_backward",
    "sigmoid_backward", "tanh_backward", "threshold_backward",
    # constants (XLA's broadcast of a scalar)
    "zeros", "zeros_like", "ones", "ones_like", "full", "full_like",
    "new_zeros", "new_ones", "new_full", "scalar_tensor",
})
#: views and metadata ops: no bytes (XLA's bitcasts)
VIEWS = frozenset({
    "t", "transpose", "permute", "unsqueeze", "squeeze", "select", "alias",
    "as_strided", "detach", "split", "split_with_sizes", "unbind", "chunk",
    "narrow", "diagonal", "unfold", "view_as_real", "view_as_complex",
    "lift_fresh", "_reshape_alias", "expand_as", "view_as", "empty",
    "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "_local_scalar_dense", "is_same_size", "sym_size", "sym_stride",
    "sym_numel", "sym_storage_offset",
})
#: slice writes: (op name, index of the argument holding the written values)
SLICE_WRITES = {
    "index_put_": 2, "index_put": 2, "_index_put_impl_": 2,
    "index_copy": 3, "index_copy_": 3, "slice_scatter": 1,
    "select_scatter": 1, "scatter": 3, "scatter_": 3, "index_add": 3,
    "index_add_": 3, "copy_": 1,
}
DOTS = {"mm", "addmm", "bmm", "baddbmm"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def dot_flops(name: str, args) -> float:
    """2·M·N·K of one matmul-class op (0 for any other op)."""
    if name in ("mm", "addmm"):
        a, b = (args[0], args[1]) if name == "mm" else (args[1], args[2])
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
    if name in ("bmm", "baddbmm"):
        a, b = (args[0], args[1]) if name == "bmm" else (args[1], args[2])
        return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    if name == "mv":
        return 2.0 * args[0].shape[0] * args[0].shape[1]
    if name == "dot":
        return 2.0 * args[0].shape[0]
    return 0.0


def _conv_flops(args, out: torch.Tensor) -> float:
    """2 · output elements · (input channels per group · kernel elements)."""
    w = args[1]
    return 2.0 * out.numel() * math.prod(w.shape[1:])


class OpCounter(TorchDispatchMode):
    """Counts the ops dispatched inside ``with OpCounter() as c:``; read
    :meth:`result` after the block, while the step's outputs are held."""

    def __init__(self, shares: dict[tuple, float] | None = None):
        super().__init__()
        self.shares = shares or {}
        self.dot_flops = 0.0
        self.bytes = 0.0
        self.n_ops = 0
        # storage -> weak ref, for every storage seen (a weak ref keeps its
        # address from being reused while it is held): the caller's, and
        # the step's own until they die
        self._known: dict[int, StorageWeakRef] = {}
        self._live: dict[int, float] = {}
        self.live_bytes = 0.0
        self.peak_live_bytes = 0.0
        self._coll0: dict = {}

    def __enter__(self):
        self._coll0 = exchange.counts()
        return super().__enter__()

    # -- live storages -------------------------------------------------------
    def _see_input(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()
        if s._cdata not in self._known:
            self._known[s._cdata] = StorageWeakRef(s)

    def _see_output(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()
        key = s._cdata
        if key in self._known:
            return
        self._known[key] = StorageWeakRef(s)
        shape = tuple(t.shape)
        b = s.nbytes() / self.shares.get(shape, self.shares.get(shape[1:], 1))
        self._live[key] = b
        self.live_bytes += b
        if self.live_bytes > self.peak_live_bytes * (1 + 1e-3):
            self._sweep()
            self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)

    def _sweep(self) -> None:
        """Drop the step's storages that died (``live_bytes`` is an upper
        bound between sweeps; the peak is exact to 0.1 %)."""
        for key in [k for k in self._live if self._known[k].expired()]:
            self.live_bytes -= self._live.pop(key)
            del self._known[key]

    # -- dispatch --------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = exchange.tensors_of((args, kwargs))
        for t in ins:
            self._see_input(t)
        out = func(*args, **kwargs)
        outs = exchange.tensors_of(out)
        if not exchange.IN_COLLECTIVE:
            self._count(func, args, outs)
        for t in outs:
            self._see_output(t)
        return out

    def _count(self, func, args, outs) -> None:
        name = func._overloadpacket.__name__
        w = exchange.PEER_WEIGHT
        self.n_ops += 1
        if name in DOTS or name in ("mv", "dot"):
            self.dot_flops += w * dot_flops(name, args)
            operands = args[:2] if name in ("mm", "bmm", "mv", "dot") else args[1:3]
            self.bytes += w * (sum(_nbytes(a) for a in operands)
                               + sum(_nbytes(o) for o in outs))
            return
        if name == "convolution":
            self.dot_flops += w * _conv_flops(args, outs[0])
            self.bytes += w * sum(_nbytes(o) for o in outs)
            return
        if name in ELEMENTWISE or name in VIEWS:
            return
        if name in SLICE_WRITES:
            i = SLICE_WRITES[name]
            vals = args[i] if len(args) > i else None
            self.bytes += w * sum(_nbytes(v) for v in exchange.tensors_of(vals))
            return
        self.bytes += w * sum(_nbytes(o) for o in outs)

    # -- result ------------------------------------------------------------------
    def result(self) -> dict:
        """The counts under the reference's keys, plus ``peak_live_bytes``,
        ``end_live_bytes`` and ``ops``."""
        self._sweep()
        now = exchange.counts()
        coll = {}
        wire = 0.0
        for kind, c in now.items():
            c0 = self._coll0.get(kind, {"count": 0, "bytes": 0})
            n, b = c["count"] - c0["count"], c["bytes"] - c0["bytes"]
            if n == 0:
                continue
            factor = 2.0 if kind == "all-reduce" else 1.0
            coll[kind] = {"count": float(n), "bytes": float(b),
                          "wire_bytes": b * factor}
            wire += b * factor
        return {
            "dot_flops": self.dot_flops,
            "bytes_proxy": self.bytes,
            "collectives": coll,
            "wire_bytes_total": wire,
            "peak_live_bytes": self.peak_live_bytes,
            "end_live_bytes": self.live_bytes,
            "ops": self.n_ops,
        }
