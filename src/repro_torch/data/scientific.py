"""Synthetic analogues of the paper's scientific datasets (§VI-A).

Multi-scale smooth structure + noise, at the datasets' own dimensions (or
divided by a scale factor for small runs).  Fields are numpy arrays; the
compressor moves them to the requested device.
"""
from __future__ import annotations

import zlib

import numpy as np

# name -> (fields, full dims); scale divides each dim for small runs
DATASETS = {
    "Ocean": (2, (2400, 3600)),
    "Miranda": (7, (256, 384, 384)),
    "Hurricane": (13, (100, 500, 500)),
    "NYX": (6, (512, 512, 512)),
    "JHTDB": (3, (2580, 2580, 2580)),
}


def field_seed(name: str, field: int, seed: int) -> int:
    """Stable generator seed for one field: crc32 of name/field/seed, the
    same in every process (Python's ``hash`` of a tuple of strings is salted
    per process)."""
    return zlib.crc32(f"{name}/{field}/{seed}".encode())


def synth_field(name: str, field: int, dims: tuple[int, ...],
                seed: int = 0) -> np.ndarray:
    """Multi-scale smooth field + noise (compression behaviour like real data)."""
    rng = np.random.default_rng(field_seed(name, field, seed))
    grids = np.meshgrid(*[np.linspace(0, 1, d, dtype=np.float32) for d in dims],
                        indexing="ij")
    out = np.zeros(dims, np.float32)
    for k in range(1, 5):  # superposed octaves
        phase = rng.uniform(0, 2 * np.pi, size=len(dims))
        freq = rng.uniform(1.5, 4.0) * (2.0 ** k)
        wave = np.zeros(dims, np.float32)
        for g, ph in zip(grids, phase):
            wave = wave + np.sin(2 * np.pi * freq * g + ph).astype(np.float32)
        out += wave / (2.0 ** k)
    out += rng.normal(0, 0.02, dims).astype(np.float32)
    return out


def dataset_dims(name: str, scale: int = 1) -> tuple[int, ...]:
    _, dims = DATASETS[name]
    return tuple(max(8, d // scale) for d in dims)
