"""Carry compressed containers across packages as numpy arrays.

This system has no weights: its state is the compressed containers.  A
container crosses between the JAX reference and the port as a kind
(``"Compressed"`` or ``"Encoded"``), a dict of numpy data leaves and a dict
of layout metadata.  Payload words are ``uint32`` on the numpy side and the
``int32`` bit pattern on the torch side.  (The serialized ``HSZ2`` blob of
``core.encode`` is the second bridge.)
"""
from __future__ import annotations

import numpy as np
import torch

from .core.stages import Compressed, Encoded, Scheme
from .kernels import ops as kernel_ops

_KINDS = {"Compressed": Compressed, "Encoded": Encoded}
_LEAVES = {
    "Compressed": ("residuals", "metadata", "bitwidths", "eps", "valid_counts"),
    "Encoded": ("payload", "metadata", "bitwidths", "eps", "valid_counts"),
}


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
    for name in _LEAVES[kind]:
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
    for name in _LEAVES[kind]:
        a = getattr(c, name).cpu().numpy()
        arrays[name] = a.view(np.uint32) if name == "payload" else a
    meta = {"scheme": c.scheme.value, "shape": tuple(c.shape),
            "padded_shape": tuple(c.padded_shape), "block": tuple(c.block),
            "orig_dtype": str(c.orig_dtype).removeprefix("torch.")}
    if kind == "Encoded":
        meta["bits"] = c.bits
    return kind, arrays, meta
