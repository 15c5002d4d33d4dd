"""Device meshes as device lists, and the logical-axis sharding rules.

* the analytics mesh (one flat ``("shard",)`` axis): a
  :class:`repro_torch.shard.ShardedFieldStore` partitions the *blocks* of
  one encoded field over it;
* the host mesh (``("data", "model")``): a ``hom``-mode train step splits
  its batch over the ``data`` axis, and manual expert parallelism
  (``models/ffn.moe_manual_ep``) routes tokens between the peers of the
  ``model`` axis;
* the production mesh (16 x 16 over ``("data", "model")``, or 2 x 16 x 16
  over ``("pod", "data", "model")``): a logical mesh of ``meta`` devices,
  no card needed, on which :func:`tree_shardings` and
  :func:`batch_shardings` give each leaf's per-device shard as jax's
  ``NamedSharding`` gives it (``launch/dryrun.py``).

All are single-controller: one process drives every shard, worker or peer,
holds its tensors on its device and exchanges them with ``.to(device)``
(``repro_torch.shard.exec``, ``repro_torch.comm``), so a mesh is a plain
list of ``torch.device`` objects in row-major order over its axes and no
process group is involved.  A device may repeat: eight shards (or four
workers, or four expert peers) on one card run the same programs and
exchanges as on eight (four) cards.  The reference's ``auto_axis_types``
is a jax-version shim and has no counterpart.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..models import common as model_common

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
    """A mesh over ``devices`` in row-major order of ``axis_sizes``."""

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

    def grid(self, axes: tuple[str, ...]) -> list[tuple[torch.device, ...]]:
        """The devices along ``axes`` (the last one fastest), each entry a
        tuple over the mesh's remaining axes in their order; the mesh's
        row-major order.  ``grid(("data",))`` on a ``("data", "model")``
        mesh gives one tuple of model peers per data index."""
        names = list(self.axis_names)
        rest = [a for a in names if a not in axes]
        idx = np.arange(self.size).reshape(self.axis_sizes).transpose(
            [names.index(a) for a in tuple(axes) + tuple(rest)])
        lead = math.prod(self.shape[a] for a in axes)
        return [tuple(self.devices[i] for i in row)
                for row in idx.reshape(lead, -1)]


def make_host_mesh(shape: tuple[int, ...] | None = None, axes=HOST_AXES, *,
                   devices=None) -> HostMesh:
    """A mesh over ``("data", "model")`` (or ``axes``) for training and
    expert parallelism, its devices in row-major order of ``shape``.

    With ``devices=None`` the mesh takes the CUDA cards: ``prod(shape)`` of
    them, or every card as ``(n, 1)`` without ``shape``; asking for more
    than there are, or for none, is an error, and there is no CPU mesh by
    default (the rules of :func:`make_analytics_mesh`).  An explicit
    ``devices`` list is taken as given and may repeat a device
    (``shape=(1, 4), devices=["cuda:0"] * 4`` puts four expert peers on one
    card).  Unlike the reference's, whose ``shape`` is ignored (it always
    builds ``(n_devices, 1)``), the port honours ``shape``, so that a
    ``model`` axis larger than 1 can run on one card.
    """
    axes = tuple(axes)
    if devices is None:
        n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = n_cards if shape is None else math.prod(int(s) for s in shape)
        if not (1 <= n <= n_cards):
            raise ValueError(
                f"the mesh must hold 1 to {n_cards} CUDA devices, got {n}; "
                f"pass devices=[...] to place workers explicitly")
        devs = tuple(torch.device("cuda", i) for i in range(n))
    else:
        devs = tuple(_indexed(torch.device(d)) for d in devices)
        if not devs:
            raise ValueError("devices must name at least one device")
    sizes = (len(devs), 1) if shape is None else tuple(int(s) for s in shape)
    if len(sizes) != len(axes):
        raise ValueError(f"shape {sizes} does not match axes {axes}")
    if math.prod(sizes) != len(devs):
        raise ValueError(f"mesh shape {sizes} needs {math.prod(sizes)} "
                         f"devices, got {len(devs)}")
    return HostMesh(devs, axes, sizes)


def make_production_mesh(*, multi_pod: bool = False) -> HostMesh:
    """The production mesh as a logical mesh: 16 x 16 = 256 devices over
    ``("data", "model")``, or 2 x 16 x 16 = 512 over ``("pod", "data",
    "model")``, every device ``meta``.  Nothing is allocated and no card is
    needed: it carries the shape the sharding rules and the dry run read.
    The ``pod`` axis extends data parallelism across pods."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return HostMesh((torch.device("meta"),) * math.prod(shape), axes, shape)


# ---------------------------------------------------------------------------
# logical-axis sharding rules
# ---------------------------------------------------------------------------

def logical_rules(mesh, *, seq_shard: bool = False) -> dict:
    """Logical axis -> mesh axis mapping for the current mesh.

    ``seq_shard`` additionally maps kv_seq -> model (sequence parallelism
    for very long KV caches / states).
    """
    has_pod = "pod" in mesh.axis_names
    batch_axes = ("pod", "data") if has_pod else ("data",)
    rules = dict(model_common.DEFAULT_RULES)
    rules.update({
        "batch": batch_axes if len(batch_axes) > 1 else batch_axes[0],
        "embed_w": "data",      # FSDP weight shard over data
        "heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "vocab": "model",
        "experts": "model",
        "expert_cap": batch_axes if len(batch_axes) > 1 else batch_axes[0],
        "lora": None,
        "kv_seq": "model" if seq_shard else None,
    })
    return rules


def activate(mesh, *, seq_shard: bool = False):
    """Install the mesh + rules into the model sharding context."""
    model_common.CTX.activate(mesh, logical_rules(mesh, seq_shard=seq_shard))


def deactivate():
    model_common.CTX.deactivate()


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a partition spec: ``spec[i]`` is the mesh axis (or tuple
    of axes) dim ``i`` is split over, or ``None`` (replicated)."""

    mesh: HostMesh
    spec: tuple

    def shard_shape(self, shape: tuple[int, ...]) -> tuple[int, ...]:
        """One device's block of a global ``shape``, as jax's
        ``NamedSharding.shard_shape``: each split dim divided by the
        product of its mesh axes' extents (which must divide it)."""
        out = list(shape)
        for i, axis in enumerate(self.spec):
            if axis is None:
                continue
            size = math.prod(self.mesh.shape[a] for a in
                             (axis if isinstance(axis, tuple) else (axis,)))
            if out[i] % size:
                raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                                 f"into {size} over {axis}")
            out[i] //= size
        return tuple(out)

    def shard_nbytes(self, t: torch.Tensor) -> int:
        """Bytes of one device's block of ``t``."""
        return math.prod(self.shard_shape(tuple(t.shape))) * t.element_size()


def spec_to_sharding(mesh, logical_spec: tuple, shape: tuple[int, ...],
                     rules: dict) -> NamedSharding:
    """One logical spec -> NamedSharding with divisibility fallback."""
    axes = []
    used = set()
    for dim, name in zip(shape, logical_spec):
        mesh_axis = rules.get(name) if name else None
        if mesh_axis is None:
            axes.append(None)
            continue
        ax_tuple = mesh_axis if isinstance(mesh_axis, tuple) else (mesh_axis,)
        if any(a in used for a in ax_tuple):
            axes.append(None)  # an axis may shard only one dim
            continue
        size = math.prod(mesh.shape[a] for a in ax_tuple)
        if dim % size:
            axes.append(None)  # fallback: replicate non-divisible dims
        else:
            axes.append(mesh_axis)
            used.update(ax_tuple)
    return NamedSharding(mesh, tuple(axes))


def tree_shardings(mesh, spec_tree, shape_tree, *, seq_shard: bool = False):
    """Map a logical-spec tree + shape tree (tensors, ``meta`` or not) ->
    NamedSharding tree."""
    rules = logical_rules(mesh, seq_shard=seq_shard)
    return model_common.tree_map(
        lambda spec, leaf: spec_to_sharding(mesh, spec, tuple(leaf.shape),
                                            rules),
        spec_tree, shape_tree, is_leaf=model_common.is_spec)


def batch_shardings(mesh, batch_specs):
    """Batch inputs: leading dim over (pod,)data, rest replicated; a batch
    that does not divide over (pod, data) falls back to ``data`` alone,
    then to replication."""
    has_pod = "pod" in mesh.axis_names
    baxes = ("pod", "data") if has_pod else "data"

    def of(leaf):
        if leaf.ndim == 0:
            return NamedSharding(mesh, ())
        b = leaf.shape[0]
        size = math.prod(mesh.shape[a] for a in
                         (baxes if isinstance(baxes, tuple) else (baxes,)))
        if b % size == 0:
            return NamedSharding(mesh, (baxes,) + (None,) * (leaf.ndim - 1))
        if not isinstance(baxes, tuple) or b % mesh.shape["data"] != 0:
            return NamedSharding(mesh, (None,) * leaf.ndim)
        return NamedSharding(mesh, ("data",) + (None,) * (leaf.ndim - 1))

    return model_common.tree_map(of, batch_specs)
