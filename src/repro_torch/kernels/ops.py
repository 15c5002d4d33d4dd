"""Device dispatch, launch counters and the fused-rule A/B switch.

The tensor's device decides which version of a kernel runs: a CPU tensor
takes the plain PyTorch version, a CUDA tensor takes the hand-written Hopper
kernel (built on first use by :mod:`repro_torch.kernels.build`), and any
failure to build or launch raises — nothing falls back.

:data:`LAUNCHES` counts kernel launches per site; a wrapper adds one only
where it launches its kernel, so a run can show that its path went through
the kernels (``chip_smoke.py`` resets the counts before each path it drives
and reads them after).

:func:`override_mode` ``("off")`` deselects the fused lowering rules in
``repro_torch.core.oplib`` so a covered cell runs its plain torch lowering
rule instead; the A/B bit-identity checks are its only users.
"""
from __future__ import annotations

import contextlib

import torch

#: launches per kernel site (the key names the wrapper and its pass).
LAUNCHES: dict[str, int] = {
    "unpack.residuals": 0,
    "lorenzo_enc2d.edges": 0,
    "lorenzo_enc2d.stencil": 0,
    "blockmean_enc2d": 0,
    "lorenzo2d.edges": 0,
    "lorenzo2d.stencil": 0,
    "blockmean2d": 0,
    # the kernel entry point (``repro_torch.kernels``), off the main path
    "unpack": 0,
    "pack": 0,
    "quant_lorenzo2d": 0,
    "block_stats": 0,
    "grad2d": 0,
    "laplacian2d": 0,
    "prefix_stats2d.edges": 0,
    "prefix_stats2d.stats": 0,
}

_MODES = ("on", "off")
_MODE = "on"


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def count(site: str) -> None:
    LAUNCHES[site] += 1


def kernels_enabled() -> bool:
    """Should ``oplib`` select the fused lowering rules?"""
    return _MODE == "on"


@contextlib.contextmanager
def override_mode(mode: str):
    """Temporarily select (``"on"``) or deselect (``"off"``) the fused rules."""
    global _MODE
    if mode not in _MODES:
        raise ValueError(f"mode {mode!r}: expected one of {_MODES}")
    prev = _MODE
    _MODE = mode
    try:
        yield mode
    finally:
        _MODE = prev


def resolve_device(device) -> torch.device:
    """The device an entry point makes its tensors on.  ``cuda`` without a
    card raises; nothing moves to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} was requested but no CUDA device is "
            "available; pass device='cpu' to run the plain versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def on_card(*tensors: torch.Tensor) -> bool:
    """Dispatch on the inputs' device: True for CUDA (launch the kernel),
    False for CPU (plain version); mixed or other devices raise."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return False
    if types == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(
        f"kernel inputs must all lie on one CUDA device or on the CPU, got "
        f"{sorted(str(t.device) for t in tensors)}")


def check(t: torch.Tensor, name: str, dtype: torch.dtype,
          shape: tuple[int, ...] | None = None) -> None:
    """Validate a kernel argument before its pointer is handed to C."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: kernel inputs must be contiguous")


def stream_ptr() -> int:
    """PyTorch's current CUDA stream as an integer handle for ctypes."""
    return torch.cuda.current_stream().cuda_stream
