"""Homomorphic compressed collectives (the paper's technique on the wire).

The paper's stage-②/③ homomorphism (sums commute with quantization and
linear decorrelation) lets a gradient all-reduce add integer residuals hop
by hop and dequantize once at the end.  The wire container is int16, so each
worker's quantizer gets ``b = 15 - ceil(log2(world))`` magnitude bits and the
accumulator cannot overflow across the reduction; the audit's
``sharddisjoint`` analyzer sweeps that promise over every supported world
size.  A *shared* error bound (the max over workers of their ``max|v|``)
keeps every worker's quantizer identical, and error feedback carries each
worker's quantization residual into its next step.

One controller drives every worker, as the sharded store does
(``repro_torch/shard/exec.py``): a worker axis is a :class:`PerWorker` list,
worker ``w``'s tensors on ``mesh.devices[w]`` (a device may repeat), and
each sum runs hop by hop on ``devices[0]`` in the wire's dtype, so it wraps
where the reference's would.  Given the same per-worker inputs every output
is bitwise the reference's (``repro/comm/hom_collectives.py``).
:func:`packed_allgather` bit-packs its payload with the port's Hopper
``pack`` / ``unpack`` kernels (their plain versions on the CPU).  Each
collective is counted in ``comm.exchange``'s counters under its HLO name
with its per-worker bytes: the shared-eps ``pmax`` (an f32 all-reduce), the
int16 sum (an all-reduce) and the packed words' all-gather.
"""
from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..core import encode
from . import exchange
from ..kernels import bitpack
from ..models.common import tree_flatten_with_paths, tree_leaves, tree_map

#: largest magnitude an int16 psum accumulator may reach (the wire dtype's
#: positive range).  The audit's ``sharddisjoint`` collective sweep proves
#: :func:`worst_case_psum` stays under this for every supported world size.
PSUM_CONTAINER_MAX = 2**15 - 1


def bit_budget(world: int, container_bits: int = 16) -> int:
    """Per-worker magnitude bits so the psum cannot overflow the container.

    The ``max(2, ...)`` floor keeps the quantizer usable at absurd world
    sizes — which also means the overflow-freedom guarantee holds only up
    to ``world < 2**(container_bits - 3)`` (32768 for int16); the audit
    sweeps the supported range and documents the cliff.
    """
    return max(2, container_bits - 1 - math.ceil(math.log2(max(world, 1))))


def worst_case_psum(world: int, container_bits: int = 16) -> int:
    """Largest magnitude the compressed psum accumulator can reach: every
    worker contributing the clipping bound of its bit budget."""
    return world * (2 ** (bit_budget(world, container_bits) - 1) - 1)


class PerWorker(list):
    """One value per worker of a data axis: item ``w`` is worker ``w``'s,
    its tensors on ``mesh.devices[w]`` — what a ``shard_map`` body holds on
    each device.  A checkpoint stores worker 0's item, which is what the
    reference's host reads from a per-device buffer returned under
    ``out_specs=P()``, and restores it onto every worker."""


def _rebuild(tree, leaves):
    """``tree`` with its leaves (in :func:`tree_leaves` order) replaced."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _f32_recip(c: float) -> float:
    """``1/c`` rounded once to f32."""
    return float(np.float32(1.0) / np.float32(c))


def _shared_delta(vs, qmax: float) -> torch.Tensor:
    """The shared quantizer bin ``2·eps`` on the first worker's device, from
    the max over workers of ``max|v|`` (the reference's ``pmax``).

    The reference writes ``eps = max(vmax / qmax, 1e-30) * 0.5`` and
    divides by ``2.0 * eps``; its compiled program (XLA's algebraic
    simplifier) multiplies by the f32 reciprocal of the constant ``qmax``
    and folds ``* 0.5`` and ``2.0 *`` away.  These are its bits:
    ``max(vmax · f32(1/qmax), 1e-30)`` in f32, so ``|v| <= 2·eps·qmax`` up
    to that rounding (the clip takes the rest)."""
    dev0 = vs[0].device
    vmax = torch.stack([torch.max(torch.abs(v)).to(dev0) for v in vs]).max()
    exchange.record("all-reduce", 4)                # the pmax of max|v|
    return torch.clamp(vmax * _f32_recip(qmax), min=1e-30)


def _quantize(v: torch.Tensor, delta: torch.Tensor, qmax: float,
              dtype: torch.dtype) -> torch.Tensor:
    """``clip(round(v / 2eps), ±qmax)`` in ``dtype`` (half to even, as
    ``jnp.round``)."""
    return torch.clamp(torch.round(v / delta), -qmax, qmax).to(dtype)


def _residual(v: torch.Tensor, q: torch.Tensor,
              delta: torch.Tensor) -> torch.Tensor:
    """``v - q·2eps`` rounded once, as the reference's compiled program
    contracts it into a fused multiply-add: exact in f64 (``q·2eps`` has at
    most 15 + 24 significant bits, and so does the difference where q is
    not 0), then rounded to f32."""
    return (v.double() - q.double() * delta.double()).to(torch.float32)


def _leaf_compressed_psum(vs, bits: int):
    """One leaf over the workers: shared-eps quantize -> int16 sum on the
    first worker's device -> dequantize.

    Returns (summed value on ``vs[0]``'s device, each worker's quantization
    residual on its own device)."""
    qmax = float(2 ** (bits - 1) - 1)
    delta = _shared_delta(vs, qmax)
    dev0 = delta.device
    qsum, residuals = None, PerWorker()
    for v in vs:
        delta_w = delta.to(v.device)
        q = _quantize(v, delta_w, qmax, torch.int16)
        residuals.append(_residual(v, q, delta_w))
        q = q.to(dev0)
        qsum = q if qsum is None else qsum + q      # int16 on the wire
    exchange.record("all-reduce", qsum.numel() * qsum.element_size())
    summed = qsum.to(torch.float32) * delta
    return summed, residuals


def compressed_psum_tree(per_worker_grads, per_worker_residuals, mesh,
                         world: int, container_bits: int = 16):
    """Error-feedback compressed all-reduce over a gradient tree.

    ``per_worker_grads`` holds one tree per worker (worker ``w``'s on
    ``mesh.devices[w]``), ``per_worker_residuals`` the same or ``None``
    (zeros).  Returns (mean gradients on ``mesh.devices[0]``, a
    :class:`PerWorker` of new residual trees)."""
    if len(per_worker_grads) != world or len(mesh.devices) < world:
        raise ValueError(f"{len(per_worker_grads)} workers' gradients on a "
                         f"mesh of {len(mesh.devices)} devices for world {world}")
    bits = bit_budget(world, container_bits)
    flat = [tree_leaves(g) for g in per_worker_grads]
    res = ([tree_leaves(r) for r in per_worker_residuals]
           if per_worker_residuals is not None
           else [[torch.zeros_like(l) for l in f] for f in flat])
    out, new_res = [], [[] for _ in range(world)]
    for i in range(len(flat[0])):
        gs = [f[i] for f in flat]
        vs = [g.to(torch.float32) + r[i] for g, r in zip(gs, res)]
        s, nr = _leaf_compressed_psum(vs, bits)
        # the reference's ``/ world``, compiled as a multiply by the f32
        # reciprocal of the constant
        out.append((s * _f32_recip(world)).to(gs[0].dtype))
        for w in range(world):
            new_res[w].append(nr[w])
    template = per_worker_grads[0]
    return _rebuild(template, out), PerWorker(
        _rebuild(template, r) for r in new_res)


def init_residuals(params) -> Any:
    """Zero error-feedback state matching the parameter tree (f32, on each
    leaf's device)."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


# ---------------------------------------------------------------------------
# bit-packed all-gather (weight/activation broadcast path)
# ---------------------------------------------------------------------------

def wire_values(x: torch.Tensor, delta: torch.Tensor, qmax: float,
                ) -> torch.Tensor:
    """The values one worker packs: ``x`` quantized with the shared bin
    ``delta`` (``2·eps``), flattened, padded with zeros to a multiple of 32
    and zigzagged (int32 bit patterns)."""
    q = _quantize(x.reshape(-1), delta, qmax, torch.int32)
    return encode.zigzag(F.pad(q, (0, (-q.shape[0]) % 32)))


def packed_allgather(per_worker_x, mesh, bits: int) -> torch.Tensor:
    """All-gather one tensor per worker in HSZ fixed-rate packed form.

    Quantizes with a shared eps, zigzag bit-packs to ``bits`` per value
    (``kernels.bitpack.pack``: bits/32 words per value on the wire), moves
    the words to ``mesh.devices[0]`` and unpacks them there
    (``kernels.bitpack.unpack``).  Returns ``(world, *x.shape)`` f32 on
    ``mesh.devices[0]``."""
    world = len(per_worker_x)
    if len(mesh.devices) < world:
        raise ValueError(f"{world} workers on a mesh of "
                         f"{len(mesh.devices)} devices")
    qmax = float(2 ** (bits - 1) - 1)
    delta = _shared_delta(per_worker_x, qmax)
    dev0 = delta.device
    n = per_worker_x[0].numel()
    words = [bitpack.pack(wire_values(x, delta.to(x.device), qmax), bits)
             for x in per_worker_x]
    gathered = [w.to(dev0) for w in words]         # packed on the wire
    exchange.record("all-gather", sum(w.numel() * w.element_size()
                                      for w in gathered))
    vals = torch.stack([encode.unzigzag(bitpack.unpack(w, n + (-n) % 32, bits))
                        for w in gathered])
    out = vals[:, :n].to(torch.float32) * delta
    return out.reshape((world,) + tuple(per_worker_x[0].shape))


# ---------------------------------------------------------------------------
# stage-① telemetry (paper §V-A.1 applied to gradients)
# ---------------------------------------------------------------------------

def stage1_stats(grads, block: int = 4096) -> dict[str, torch.Tensor]:
    """Metadata-only gradient statistics: global mean and 2nd moment derived
    from per-block sums (the paper's D_m), never touching full precision.
    f32 block sums, added leaf by leaf in jax's leaf order."""
    total, total_sq, count = 0.0, 0.0, 0
    for g in tree_flatten_with_paths(grads)[1]:
        v = g.reshape(-1).to(torch.float32)
        n = v.shape[0]
        vb = F.pad(v, (0, (-n) % block)).reshape(-1, block)
        bsum = torch.sum(vb, dim=1)       # block metadata (D_m)
        bsq = torch.sum(vb * vb, dim=1)   # second-moment metadata
        total = total + torch.sum(bsum)
        total_sq = total_sq + torch.sum(bsq)
        count += n
    mean = total / count
    var = torch.clamp(total_sq / count - mean * mean, min=0.0)
    return {"mean": mean, "rms": torch.sqrt(total_sq / count),
            "std": torch.sqrt(var), "norm": torch.sqrt(total_sq)}
