"""Stage-③ integer stencils with the eps tail outside the kernel: the Hopper
kernels and their plain versions.

Counterparts of ``repro/kernels/stencil_dq.py``: ``grad2d`` (both interior
central differences from one pass over ``q``) and ``laplacian2d`` (the
5-point stencil).  The kernels (``csrc/stencil_dq.cu``) emit exact int32
interior planes; the ``× eps`` / ``× 2eps`` float tails run in torch after
them, as in the reference, so no float multiply sits inside a kernel.

Unlike the reference, which refuses interiors that are not a multiple of its
TPU tile (``tile=``), every shape the ``ref.py`` oracles take is accepted,
the Ocean field's 2398 × 3598 interior included.

``grad2d_int`` (and its plain version) also takes a batch ``(B, n0, n1)``,
the stage-③ seeds of a batched engine run: one launch for the batch, the
counterpart of the grid axis Pallas prepends under the reference's
``jax.vmap``; its planes are ``(B, n0 - 2, n1 - 2)``.
"""
from __future__ import annotations

import torch

from . import build, ops


def _interior_shape(q: torch.Tensor) -> tuple[int, ...]:
    """The interior planes' shape: leading (batch) dims kept."""
    n0, n1 = q.shape[-2:]
    return tuple(q.shape[:-2]) + (max(n0 - 2, 0), max(n1 - 2, 0))


def _eps(eps, device) -> torch.Tensor:
    return torch.as_tensor(eps, dtype=torch.float32, device=device)


def _on_card(q: torch.Tensor, eps) -> bool:
    """Dispatch on ``q`` and, where it is a tensor, ``eps`` (mixed raise)."""
    return ops.on_card(q, *([eps] if isinstance(eps, torch.Tensor) else []))


def grad2d_int_plain(q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: ``q[2:,1:-1] - q[:-2,1:-1]`` and
    ``q[1:-1,2:] - q[1:-1,:-2]`` (int32, modular), of each plane of a
    ``(B, n0, n1)`` batch."""
    return (q[..., 2:, 1:-1] - q[..., :-2, 1:-1],
            q[..., 1:-1, 2:] - q[..., 1:-1, :-2])


def laplacian2d_int_plain(q: torch.Tensor) -> torch.Tensor:
    """Plain version: ``n + s + w + e - 4c`` on the interior (int32, modular)."""
    return (q[2:, 1:-1] + q[:-2, 1:-1] + q[1:-1, 2:] + q[1:-1, :-2]
            - 4 * q[1:-1, 1:-1])


def _check_plane(q: torch.Tensor, name: str, batched: bool = False) -> None:
    ops.check(q, "q", torch.int32)
    if q.ndim != 2 and not (batched and q.ndim == 3):
        raise ValueError(f"{name} takes a 2-D plane"
                         + (" or a batch of them" if batched else "")
                         + f", got {tuple(q.shape)}")


def grad2d_int(q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The two int32 interior difference planes of a plane or a ``(B, n0,
    n1)`` batch: kernel on a CUDA tensor (one launch for the batch), plain
    version on a CPU one.  A plane without interior launches nothing."""
    if not ops.on_card(q):
        return grad2d_int_plain(q)
    _check_plane(q, "grad2d", batched=True)
    m = _interior_shape(q)
    d0 = torch.empty(m, dtype=torch.int32, device=q.device)
    d1 = torch.empty(m, dtype=torch.int32, device=q.device)
    if d0.numel():
        build.call("hsz_grad2d", q.data_ptr(), q.shape[-2], q.shape[-1],
                   q.shape[0] if q.ndim == 3 else 1, d0.data_ptr(),
                   d1.data_ptr(), ops.stream_ptr())
        ops.count("grad2d")
    return d0, d1


def laplacian2d_int(q: torch.Tensor) -> torch.Tensor:
    """The int32 interior 5-point plane: kernel on a CUDA plane, plain
    version on a CPU one."""
    if not ops.on_card(q):
        return laplacian2d_int_plain(q)
    _check_plane(q, "laplacian2d")
    out = torch.empty(_interior_shape(q), dtype=torch.int32, device=q.device)
    if out.numel():
        build.call("hsz_laplacian2d", q.data_ptr(), q.shape[0], q.shape[1],
                   out.data_ptr(), ops.stream_ptr())
        ops.count("laplacian2d")
    return out


def _grad_tail(d0: torch.Tensor, d1: torch.Tensor, eps):
    eps = _eps(eps, d0.device)
    return d0.to(torch.float32) * eps, d1.to(torch.float32) * eps


def _laplacian_tail(acc: torch.Tensor, eps) -> torch.Tensor:
    return acc.to(torch.float32) * (2.0 * _eps(eps, acc.device))


def grad2d(q: torch.Tensor, eps) -> tuple[torch.Tensor, torch.Tensor]:
    """(d/dx0, d/dx1) on the common interior, f32: ``(q_s - q_n) · eps`` and
    ``(q_e - q_w) · eps`` (paper Eq. V-B.2)."""
    if not _on_card(q, eps):
        return grad2d_plain(q, eps)
    return _grad_tail(*grad2d_int(q), eps)


def grad2d_plain(q: torch.Tensor, eps) -> tuple[torch.Tensor, torch.Tensor]:
    return _grad_tail(*grad2d_int_plain(q), eps)


def laplacian2d(q: torch.Tensor, eps) -> torch.Tensor:
    """5-point Laplacian on the common interior, f32: the integer stencil
    times ``2 eps`` (paper Eq. V-B.4)."""
    if not _on_card(q, eps):
        return laplacian2d_plain(q, eps)
    return _laplacian_tail(laplacian2d_int(q), eps)


def laplacian2d_plain(q: torch.Tensor, eps) -> torch.Tensor:
    return _laplacian_tail(laplacian2d_int_plain(q), eps)
