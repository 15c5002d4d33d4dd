"""Train step construction: the single-program baseline and homomorphic-
compressed data parallelism.

Two gradient-synchronization modes, as the reference's
``repro/train/train_step.py``:

* ``gspmd`` (baseline): one ``torch.autograd.grad`` of ``model.loss_fn``
  over the global batch on the params' device; under an active mesh with a
  ``model`` axis the MoE layers take manual expert parallelism
  (``models/ffn.moe_manual_ep``) over its peers.
* ``hom`` (the paper's technique on the wire): the global batch is split
  along dim 0 over the mesh's ``data`` workers, as ``P("data")`` splits it;
  each worker computes its loss and unreduced gradients on its own device
  with ``CTX.manual_dp`` set (the reference's ``shard_map`` body: no expert
  parallelism inside it, so a ``("data", "model")`` mesh gives the same
  bits as its ``data`` axis alone), then
  ``comm.compressed_psum_tree`` all-reduces them in the quantized integer
  domain (int16 wire, shared eps, error feedback) and one AdamW update
  runs on ``mesh.devices[0]``.  The error-feedback state is a
  :class:`~repro_torch.comm.PerWorker` list, one residual tree per worker:
  under the reference's ``out_specs=P()`` each device keeps its own
  residual too, and its host reads device 0's.

Params are plain tensors in a :class:`TrainState`; they take
``requires_grad`` only inside the step.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..comm import exchange
from ..comm import hom_collectives as hom
from ..models.common import CTX, tree_leaves, tree_map
from . import optimizer as opt_lib


class TrainState(NamedTuple):
    params: Any
    opt: opt_lib.OptState
    step: torch.Tensor                  # int32 scalar
    ef_residual: Any | None = None      # error-feedback state (hom mode)


def init_state(params, *, hom_mode: bool = False, mesh=None) -> TrainState:
    """Fresh optimizer state and step 0; in ``hom`` mode zero residuals
    for each of ``mesh``'s ``data`` workers on its device (workers on one
    device share the zeros: the step never writes a residual in place)."""
    residual = None
    if hom_mode:
        if mesh is None:
            raise ValueError("hom mode needs the mesh")
        zeros = hom.init_residuals(params)
        residual = hom.PerWorker(_on(zeros, dev)
                                 for dev in worker_devices(mesh))
    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    return TrainState(params=params, opt=opt_lib.init(params), step=step,
                      ef_residual=residual)


def worker_devices(mesh, dp_axes: tuple = ("data",)) -> list:
    """The data workers' devices: one per index of ``dp_axes`` (row-major),
    at index 0 of the mesh's other axes.  On a ``(2, 2)`` ``("data",
    "model")`` mesh these are devices 0 and 2."""
    return [row[0] for row in mesh.grid(tuple(dp_axes))]


def _on(tree, device):
    """``tree`` on ``device`` (no copy where a leaf is there already)."""
    return tree_map(lambda t: t.to(device), tree)


def value_and_grad(loss_fn, params, batch):
    """``(loss, grads)`` of ``loss_fn(params, batch)``: every params leaf
    takes ``requires_grad`` for the call; an unused leaf gets a zero
    gradient, as ``jax.grad`` gives it."""
    with torch.enable_grad():
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        leaves = tree_leaves(live)
        loss = loss_fn(live, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    it = iter(grads)
    return loss.detach(), tree_map(lambda _: next(it), params)


def split_batch(batch, n: int) -> list:
    """``n`` equal slices of every batch leaf along dim 0, in order."""
    for k, x in batch.items():
        if x.shape[0] % n:
            raise ValueError(f"batch leaf {k!r} of {x.shape[0]} rows does not "
                             f"split into {n}")
    return [{k: x[i * (x.shape[0] // n):(i + 1) * (x.shape[0] // n)]
             for k, x in batch.items()} for i in range(n)]


def make_train_step(model, opt_cfg: opt_lib.AdamWConfig, *,
                    mode: str = "gspmd", mesh=None,
                    dp_axes: tuple = ("data",), microbatch: int | None = None):
    """Returns ``train_step(state, batch) -> (state, metrics)``."""

    def grads_of(params, batch):
        if microbatch is None:
            return value_and_grad(model.loss_fn, params, batch)
        # gradient accumulation over leading-dim microbatch splits (the
        # dry run, on meta tensors, runs one and weighs it by their count)
        outs = exchange.map_peers(
            lambda b: value_and_grad(model.loss_fn, params, b),
            split_batch(batch, microbatch), sequential=True)
        losses, gs = zip(*outs)
        g = tree_map(lambda *xs: torch.mean(torch.stack(xs), dim=0), *gs)
        return torch.mean(torch.stack(losses)), g

    if mode == "gspmd":
        def train_step(state: TrainState, batch):
            loss, grads = grads_of(state.params, batch)
            new_params, new_opt, stats = opt_lib.update(
                opt_cfg, grads, state.opt, state.params)
            metrics = {"loss": loss, **stats}
            return TrainState(new_params, new_opt, state.step + 1,
                              state.ef_residual), metrics
        return train_step

    if mode != "hom":
        raise ValueError(f"unknown mode {mode}")
    if mesh is None:
        raise ValueError("hom mode needs the mesh")
    devices = worker_devices(mesh, dp_axes)
    world = len(devices)

    def local_grads(params, batch):
        """One worker's loss and unreduced grads, with the model's sharding
        rules rebased as inside the reference's manual-DP body."""
        old_rules, old_manual = dict(CTX.rules), CTX.manual_dp
        CTX.rules = {**old_rules, "batch": None, "expert_cap": None}
        CTX.manual_dp = True
        try:
            return grads_of(params, batch)
        finally:
            CTX.rules = old_rules
            CTX.manual_dp = old_manual

    def train_step(state: TrainState, batch):
        losses, per_worker = [], []
        for dev, b in zip(devices, split_batch(batch, world)):
            loss, g = local_grads(_on(state.params, dev), _on(b, dev))
            losses.append(loss.to(devices[0]))
            per_worker.append(g)
        # the paper's homomorphism: add in the quantized domain
        grads, new_residual = hom.compressed_psum_tree(
            per_worker, state.ef_residual, mesh, world)
        loss = torch.mean(torch.stack(losses))
        exchange.record("all-reduce", 4)            # the loss's pmean
        new_params, new_opt, stats = opt_lib.update(
            opt_cfg, grads, state.opt, state.params)
        metrics = {"loss": loss, **stats}
        return TrainState(new_params, new_opt, state.step + 1,
                          new_residual), metrics

    return train_step
