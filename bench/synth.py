"""Synthetic scientific fields made on the device from the run's seed.

A copy of the formula of ``repro_torch.data.scientific.synth_field`` (four
octaves of separable sine waves plus Gaussian noise of standard deviation
0.02), in torch and on the run's device: the benchmark makes the raw fields
itself and hands the same tensors to the system under test and to the plain
reference.  Every field has a generator of its own, seeded from the run's
seed and the field's index, so any one field can be made again alone.
"""
from __future__ import annotations

import hashlib
import math

import torch

OCTAVES = 4
NOISE_STD = 0.02


def field_seed(seed: int, index: int) -> int:
    """A 63-bit generator seed for field ``index`` of run ``seed`` (any
    whole number, also past 64 bits)."""
    digest = hashlib.blake2b(f"{seed}/{index}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def make_field(seed: int, index: int, dims: tuple[int, ...],
               device) -> torch.Tensor:
    """Field ``index`` of run ``seed``: a float32 tensor of shape ``dims``.

    The octaves' phases and frequencies are a handful of draws from a CPU
    generator; the noise is one draw from a generator on ``device``."""
    s = field_seed(seed, index)
    host = torch.Generator().manual_seed(s)
    gen = torch.Generator(device=device).manual_seed(s)
    nd = len(dims)
    out = torch.randn(dims, generator=gen, device=device,
                      dtype=torch.float32).mul_(NOISE_STD)
    for k in range(1, OCTAVES + 1):
        phase = torch.rand(nd, generator=host, dtype=torch.float64) * 2 * math.pi
        freq = (1.5 + 2.5 * torch.rand((), generator=host,
                                       dtype=torch.float64)) * 2.0 ** k
        for axis, (d, ph) in enumerate(zip(dims, phase.tolist())):
            g = torch.linspace(0, 1, d, dtype=torch.float32, device=device)
            wave = torch.sin(2 * math.pi * float(freq) * g + ph) / 2.0 ** k
            shape = [1] * nd
            shape[axis] = d
            out.add_(wave.reshape(shape))
    return out
