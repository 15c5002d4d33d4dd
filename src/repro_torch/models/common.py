"""Shared model-building blocks: params-with-sharding builder, norms, RoPE.

* **Functional params**: nested dicts of tensors.  A :class:`Builder` creates
  each parameter together with its *logical sharding spec*; ``init`` returns
  ``(params, specs)`` trees of identical structure.
* **Stacked layers**: per-layer params are stacked on a leading ``layers``
  axis; the forward passes loop over it.
* **Logical axes**: ``batch, seq, embed, heads, kv_heads, head_dim, mlp,
  vocab, experts, layers, conv, state`` — resolved per mesh by
  :meth:`ShardingCtx.resolve`.  With no mesh active (the only mode this
  package runs models in), :func:`shard` is the identity.
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Callable, Sequence
from typing import Any

import torch
import torch.nn.functional as F

from ..kernels import ops as kernel_ops

Params = dict[str, Any]
Specs = dict[str, Any]

# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------


def tree_map(fn: Callable, tree, *rest, is_leaf: Callable | None = None):
    """Map ``fn`` over the leaves of nested dicts / lists / tuples (and the
    matching leaves of ``rest``, which share ``tree``'s structure)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
            for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree, is_leaf: Callable | None = None) -> list:
    out = []
    tree_map(out.append, tree, is_leaf=is_leaf)
    return out


def is_spec(x) -> bool:
    """A logical spec: a tuple of axis names (or ``None``)."""
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None)))
                                        for a in x)


# ---------------------------------------------------------------------------
# logical sharding
# ---------------------------------------------------------------------------

DEFAULT_RULES: dict[str, str | tuple[str, ...] | None] = {
    "batch": ("pod", "data"),
    "seq": None,
    "seq_tp": "model",      # sequence-parallel fallback (heads % tp != 0)
    "embed": None,          # replicated activations on embed dim
    "embed_w": "data",      # FSDP: weight embed dim sharded over data
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "expert_cap": "data",   # MoE dispatch capacity rows over the DP axes
    "layers": None,
    "conv": None,
    "state": None,
    "kv_seq": None,
    "lora": None,
}


class ShardingCtx:
    """Maps logical axes to mesh axes.  ``mesh`` is anything with a
    ``shape`` mapping of axis name to extent; ``None`` means no mesh."""

    def __init__(self):
        self.mesh = None
        self.rules: dict[str, str | tuple[str, ...] | None] = dict(DEFAULT_RULES)
        self.manual_dp = False

    def activate(self, mesh, rules):
        self.mesh = mesh
        self.rules = rules

    def deactivate(self):
        self.mesh = None
        self.rules = dict(DEFAULT_RULES)

    def resolve(self, logical: Sequence[str | None],
                shape: tuple[int, ...]) -> tuple:
        """Logical axes -> per-dim mesh axes (a partition spec as a tuple),
        dropping non-divisible axes and duplicate mesh-axis uses (first dim
        wins)."""
        axes = []
        used = set()
        for dim, name in zip(shape, logical):
            mesh_axis = self.rules.get(name) if name else None
            if mesh_axis is None or self.mesh is None:
                axes.append(None)
                continue
            ax_tuple = mesh_axis if isinstance(mesh_axis, tuple) else (mesh_axis,)
            if any(a in used for a in ax_tuple):
                axes.append(None)
                continue
            size = 1
            for a in ax_tuple:
                size *= self.mesh.shape[a]
            if dim % size == 0:
                axes.append(mesh_axis)
                used.update(ax_tuple)
            else:
                axes.append(None)
        return tuple(axes)


CTX = ShardingCtx()


def axis_size(logical: str) -> int:
    """Mesh extent behind a logical axis (1 when no mesh is active)."""
    if CTX.mesh is None:
        return 1
    mesh_axis = CTX.rules.get(logical)
    if mesh_axis is None:
        return 1
    size = 1
    for a in (mesh_axis if isinstance(mesh_axis, tuple) else (mesh_axis,)):
        size *= CTX.mesh.shape[a]
    return size


def shard(x: torch.Tensor, *logical: str | None) -> torch.Tensor:
    """Activation sharding constraint by logical axes: the identity without
    a mesh.  Model sharding over a mesh is not ported (ROADMAP queue 1
    item 4), so an active mesh raises."""
    if CTX.mesh is None or CTX.manual_dp:
        return x
    raise NotImplementedError(
        "sharded models are not ported: run without an active mesh")


# ---------------------------------------------------------------------------
# parameter builder
# ---------------------------------------------------------------------------

def resolve_device(device) -> torch.device:
    """The device params, caches and batches are made on: ``meta`` for
    abstract shapes, else the card or the CPU (``cuda`` without a card
    raises)."""
    if torch.device(device).type == "meta":
        return torch.device("meta")
    return kernel_ops.resolve_device(device)


@dataclasses.dataclass
class Builder:
    """Creates params and records their logical sharding specs.

    ``generator=None`` puts the builder in *abstract* mode: params are
    ``meta`` tensors (shape and dtype, no storage, no RNG).  Otherwise
    normal draws come from ``generator`` on its own device and are moved to
    ``device``.
    """

    generator: torch.Generator | None
    dtype: torch.dtype = torch.float32
    device: torch.device | str = "cuda"

    def param(self, shape: tuple[int, ...], logical: tuple[str | None, ...],
              *, scale: float | None = None, init: str = "normal"):
        if len(shape) != len(logical):
            raise ValueError(f"shape {shape} vs logical {logical}")
        if self.generator is None:
            return torch.empty(shape, dtype=self.dtype, device="meta"), logical
        if init == "zeros":
            value = torch.zeros(shape, dtype=self.dtype, device=self.device)
        elif init == "ones":
            value = torch.ones(shape, dtype=self.dtype, device=self.device)
        else:
            if scale is None:
                fan_in = shape[0] if len(shape) > 1 else shape[-1]
                scale = 1.0 / math.sqrt(max(fan_in, 1))
            draw = torch.randn(shape, generator=self.generator,
                               dtype=torch.float32,
                               device=self.generator.device)
            value = (draw * scale).to(device=self.device, dtype=self.dtype)
        return value, logical

    @staticmethod
    def split(tree):
        """(value, logical) leaf tree -> (params, specs)."""
        is_leaf = lambda x: (isinstance(x, tuple) and len(x) == 2
                             and is_spec(x[1]))
        params = tree_map(lambda l: l[0], tree, is_leaf=is_leaf)
        specs = tree_map(lambda l: l[1], tree, is_leaf=is_leaf)
        return params, specs


def stack_layers(layer_trees: Sequence[Params]) -> Params:
    """Stack identical per-layer trees on a new leading ``layers`` axis."""
    return tree_map(lambda *xs: torch.stack(xs, dim=0), *layer_trees)


def stacked_spec(spec_tree: Specs) -> Specs:
    """Prepend the ``layers`` logical axis to every spec in a layer tree."""
    return tree_map(lambda s: ("layers",) + s, spec_tree, is_leaf=is_spec)


def layer_slice(tree, l: int):
    """Layer ``l`` of a stacked tree (views, no copy)."""
    return tree_map(lambda w: w[l], tree)


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------

def cast_tree(tree, dtype: torch.dtype):
    """Cast float params to the compute dtype (master copies stay f32)."""
    return tree_map(lambda w: w.to(dtype) if w.is_floating_point() else w,
                    tree)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * (1.0 + gamma.float())).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding; x: (..., seq, heads, head_dim), positions: (..., seq)."""
    hd = x.shape[-1]
    half = hd // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(theta, exps)
    angles = positions[..., :, None].float() * freqs  # (..., seq, half)
    cos = torch.cos(angles)[..., None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


def gelu_glu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.gelu(gate, approximate="tanh") * up


def causal_mask(q_len: int, kv_len: int, *, window: int | None = None,
                q_offset: torch.Tensor | int = 0,
                device: torch.device | str = "cpu") -> torch.Tensor:
    """Boolean (q_len, kv_len) mask; True = attend.  ``window`` gives local
    (sliding) attention; ``q_offset`` positions queries inside a longer KV."""
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    mask = kv_pos <= q_pos
    if window is not None:
        mask &= kv_pos > q_pos - window
    return mask


def sinusoidal_positions(n: int, d: int,
                         device: torch.device | str = "cpu") -> torch.Tensor:
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(10000.0, dim / d)
    out = torch.zeros((n, d), dtype=torch.float32, device=device)
    out[:, 0::2] = torch.sin(angle)
    out[:, 1::2] = torch.cos(angle)
    return out
