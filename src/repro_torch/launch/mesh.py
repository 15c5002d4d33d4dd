"""Device meshes as device lists: the analytics mesh (one flat
``("shard",)`` axis) and the training host mesh (``("data", "model")``).

A :class:`repro_torch.shard.ShardedFieldStore` partitions the *blocks* of
one encoded field over the analytics mesh; a ``hom``-mode train step splits
its batch over the host mesh's ``data`` axis.  Both are single-controller:
one process drives every shard or worker, holds its tensors on its device
and reduces on ``devices[0]`` (``repro_torch.shard.exec``,
``repro_torch.comm.hom_collectives``), so a mesh is a plain list of
``torch.device`` objects and no process group is involved.  A device may
repeat: eight shards (or four workers) on one card run the same programs
and reductions as on eight (four) cards.
"""
from __future__ import annotations

import dataclasses
import math

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


#: mesh axis names of the training host mesh (the reference's
#: ``make_host_mesh`` default).
HOST_AXES = ("data", "model")


@dataclasses.dataclass(frozen=True)
class HostMesh:
    """A ``data`` x ``model`` mesh over ``devices`` in row-major order."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> extent, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return len(self.devices)


def make_host_mesh(shape: tuple[int, ...] | None = None, axes=HOST_AXES, *,
                   devices=None) -> HostMesh:
    """``(n, 1)`` mesh over ``("data", "model")`` for training.

    With ``devices=None`` the mesh takes the CUDA cards: ``shape[0]`` of
    them, or every card without ``shape``; asking for more than there are,
    or for none, is an error, and there is no CPU mesh by default (the
    rules of :func:`make_analytics_mesh`).  An explicit ``devices`` list is
    taken as given and may repeat a device (``["cuda:0"] * 4``, ``["cpu"]
    * 4``).  Only data parallelism is ported: a ``model`` axis larger than
    1 raises (model sharding waits for the mesh-bound model code).
    """
    axes = tuple(axes)
    if devices is None:
        n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = n_cards if shape is None else int(shape[0])
        if not (1 <= n <= n_cards):
            raise ValueError(
                f"the data axis must hold 1 to {n_cards} CUDA devices, got "
                f"{n}; pass devices=[...] to place workers explicitly")
        devs = tuple(torch.device("cuda", i) for i in range(n))
    else:
        devs = tuple(_indexed(torch.device(d)) for d in devices)
        if not devs:
            raise ValueError("devices must name at least one device")
    sizes = (len(devs), 1) if shape is None else tuple(int(s) for s in shape)
    if len(sizes) != len(axes):
        raise ValueError(f"shape {sizes} does not match axes {axes}")
    if dict(zip(axes, sizes)).get("model", 1) != 1:
        raise NotImplementedError(
            "a model axis larger than 1 needs the mesh-bound model code, "
            "which is not ported")
    if math.prod(sizes) != len(devs):
        raise ValueError(f"mesh shape {sizes} needs {math.prod(sizes)} "
                         f"devices, got {len(devs)}")
    return HostMesh(devs, axes, sizes)
