"""Carry compressed containers across packages as numpy arrays.

This system has no weights: its state is the compressed containers.  A
container crosses between the JAX reference and the port as a kind
(``"Compressed"`` or ``"Encoded"``), a dict of numpy data leaves and a dict
of layout metadata.  Payload words are ``uint32`` on the numpy side and the
``int32`` bit pattern on the torch side.  (The serialized ``HSZ2`` blob of
``core.encode`` is the second bridge.)  A materialized seed
(``store.MaterializedStage``) crosses as its key — stage, closure, region —
and either its stage-② sub-field as such a container triple or its stage-③
integers as one numpy array, so a seed the reference materialized serves
the port's ``compute(..., seed=)``.  A temporal stream crosses as its slabs'
container triples plus its pinned quantization step, payload-width policy,
headroom and measured |q| bound (:func:`temporal_from_arrays`), and a
``TemporalSummary`` as its six integer leaves (:func:`summary_from_arrays`).
"""
from __future__ import annotations

import numpy as np
import torch

from collections.abc import Sequence

from .core import by_name
from .core.oplib import TemporalSummary
from .core.stages import LEAVES, Compressed, Encoded, Scheme, Stage
from .kernels import ops as kernel_ops
from .store import MaterializedStage
from .stream import TemporalField

_KINDS = {"Compressed": Compressed, "Encoded": Encoded}


def from_arrays(kind: str, arrays: dict[str, np.ndarray], meta: dict,
                device="cuda") -> Compressed | Encoded:
    """Build the port's container from numpy leaves and layout metadata.

    ``meta`` holds ``scheme`` (a string), ``shape``, ``padded_shape``,
    ``block``, ``orig_dtype`` (a string such as ``"float32"``) and, for
    ``Encoded``, ``bits``.
    """
    if kind not in _KINDS:
        raise ValueError(f"kind {kind!r}: expected one of {tuple(_KINDS)}")
    dev = kernel_ops.resolve_device(device)
    leaves = {}
    for name in LEAVES[kind]:
        a = np.ascontiguousarray(arrays[name])
        if name == "payload":
            a = a.astype(np.uint32).view(np.int32)
        elif name == "eps":
            a = a.astype(np.float32).reshape(())
        else:
            a = a.astype(np.int32)
        leaves[name] = torch.as_tensor(a, device=dev)
    extra = {"bits": int(meta["bits"])} if kind == "Encoded" else {}
    return _KINDS[kind](
        **leaves, scheme=Scheme(meta["scheme"]), shape=tuple(meta["shape"]),
        padded_shape=tuple(meta["padded_shape"]), block=tuple(meta["block"]),
        orig_dtype=getattr(torch, str(meta["orig_dtype"])), **extra)


def to_arrays(c: Compressed | Encoded) -> tuple[str, dict[str, np.ndarray], dict]:
    """Inverse of :func:`from_arrays`: ``(kind, arrays, meta)`` on the host."""
    kind = type(c).__name__
    arrays = {}
    for name in LEAVES[kind]:
        a = getattr(c, name).cpu().numpy()
        arrays[name] = a.view(np.uint32) if name == "payload" else a
    meta = {"scheme": c.scheme.value, "shape": tuple(c.shape),
            "padded_shape": tuple(c.padded_shape), "block": tuple(c.block),
            "orig_dtype": str(c.orig_dtype).removeprefix("torch.")}
    if kind == "Encoded":
        meta["bits"] = c.bits
    return kind, arrays, meta


def _key(closure, region):
    """The seed key in the port's canonical form: closures ``"cover"`` /
    ``"hull"`` / ``("band", axis)``, regions tuples of int pairs."""
    if not isinstance(closure, str):
        closure = (str(closure[0]), int(closure[1]))
    if region is not None:
        region = tuple((int(s), int(e)) for s, e in region)
    return closure, region


def seed_from_arrays(stage, closure, region, *, sub=None, q_spatial=None,
                     device="cuda") -> MaterializedStage:
    """Build the port's :class:`~repro_torch.store.MaterializedStage` from a
    seed's key and its numpy data: ``sub`` a ``(kind, arrays, meta)``
    triple as :func:`from_arrays` takes (stage ②), or ``q_spatial`` an
    integer array (stage ③).  Exactly one of them is given."""
    if (sub is None) == (q_spatial is None):
        raise ValueError("a seed holds exactly one of sub and q_spatial")
    closure, region = _key(closure, region)
    dev = kernel_ops.resolve_device(device)
    if sub is not None:
        sub = from_arrays(*sub, device=dev)
    else:
        q_spatial = torch.as_tensor(
            np.ascontiguousarray(q_spatial).astype(np.int32), device=dev)
    return MaterializedStage(sub=sub, q_spatial=q_spatial,
                             stage=Stage(int(stage)), closure=closure,
                             region=region)


def temporal_from_arrays(scheme: str, slabs: Sequence[tuple], *, eps,
                         bits: str | int | None, headroom: int = 2,
                         q_abs_max: int = 0, block=None,
                         device="cuda") -> TemporalField:
    """Build the port's :class:`~repro_torch.stream.TemporalField` from a
    stream's state: ``slabs`` as ``(kind, arrays, meta)`` triples in append
    order (each taken through :func:`from_arrays`), the pinned ``eps``, the
    payload-width policy ``bits`` as the stream holds it after its appends
    (``"auto"`` is resolved to an int at the first append), ``headroom``
    and the measured |q| bound ``q_abs_max`` the capacity guard runs
    against.  Appends to the result continue the stream."""
    dev = kernel_ops.resolve_device(device)
    comp = by_name(scheme, None if block is None else tuple(block))
    tf = TemporalField(comp, eps=None if eps is None else float(eps),
                       bits=bits, headroom=headroom, device=dev)
    tf.slabs = [from_arrays(*s, device=dev) for s in slabs]
    if tf.slabs:
        first = tf.slabs[0]
        tf._spatial_shape = tuple(first.shape[1:])
        tf._dtype = first.orig_dtype
    tf._q_abs_max = int(q_abs_max)
    return tf


def summary_from_arrays(arrays: dict[str, np.ndarray],
                        device="cuda") -> TemporalSummary:
    """Build a :class:`~repro_torch.core.oplib.TemporalSummary` from its
    numpy leaves (``count``, ``q_sum``, ``q_sumsq``, ``q_min``, ``q_max``,
    ``last2``), as int32 tensors on ``device``."""
    dev = kernel_ops.resolve_device(device)
    return TemporalSummary(**{
        name: torch.as_tensor(np.array(arrays[name], dtype=np.int32),
                              device=dev)
        for name in ("count", "q_sum", "q_sumsq", "q_min", "q_max", "last2")})
