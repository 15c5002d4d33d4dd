"""The analytics mesh: one flat ``("shard",)`` axis over a list of devices.

A :class:`repro_torch.shard.ShardedFieldStore` partitions the *blocks* of
one encoded field over this axis.  The store is single-controller: one
process drives every shard, holds each shard's word stripe on that shard's
device and merges the shards' words on ``devices[0]`` (``repro_torch.shard
.exec``), so the mesh is a plain list of ``torch.device`` objects and no
process group is involved.  A device may repeat: eight shards on one card
run the same programs, merges and per-shard budgets as eight shards on
eight cards.
"""
from __future__ import annotations

import dataclasses

import torch

#: mesh axis name of the analytics block-shard dimension.
SHARD_AXIS = "shard"


@dataclasses.dataclass(frozen=True)
class AnalyticsMesh:
    """A 1-D mesh: ``devices[s]`` holds shard ``s``."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...] = (SHARD_AXIS,)

    @property
    def size(self) -> int:
        return len(self.devices)


def make_analytics_mesh(n_shards: int | None = None, *,
                        devices=None) -> AnalyticsMesh:
    """1-D ``("shard",)`` mesh for block-sharded analytics field stores.

    With ``devices=None`` the mesh takes the first ``n_shards`` CUDA cards
    (default: every card); asking for more shards than cards, or fewer than
    one, is an error — placement is physical, never oversubscribed, and
    there is no CPU mesh by default.  An explicit ``devices`` list is taken
    as given and may repeat a device (``["cpu"] * 8`` for tests on the CPU,
    ``["cuda:0"] * 8`` for eight shards on one card); ``n_shards``, if
    given, must equal its length.
    """
    if devices is None:
        n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = n_cards if n_shards is None else int(n_shards)
        if not (1 <= n <= n_cards):
            raise ValueError(
                f"n_shards must be in [1, {n_cards}] (CUDA devices), got "
                f"{n_shards}; pass devices=[...] to place shards explicitly")
        return AnalyticsMesh(tuple(torch.device("cuda", i) for i in range(n)))
    devs = tuple(_indexed(torch.device(d)) for d in devices)
    if not devs:
        raise ValueError("devices must name at least one device")
    if n_shards is not None and int(n_shards) != len(devs):
        raise ValueError(
            f"n_shards={n_shards} but {len(devs)} devices were given")
    return AnalyticsMesh(devs)


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` as the card it means (the current one), so that a mesh
    device compares equal to the device a tensor reports."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev
