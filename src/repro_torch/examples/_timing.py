"""Host-clock timing that waits for the device."""
from __future__ import annotations

import time

import torch


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn, device: torch.device):
    """``(result, seconds)`` of one call, ending after the device finishes."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0
