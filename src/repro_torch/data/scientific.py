"""Scientific-field data pipeline (the paper's own domain, §VI-A).

Synthesizes deterministic analogues of the paper's five benchmark datasets
(multi-scale smooth structure + noise, at the datasets' own dimensions or
divided by a scale factor for small runs), stores them as HSZ-compressed
shards (``HSZ2`` bytes, in memory and optionally under ``root=``), and
serves analytics/training consumers through *homomorphic* accessors:
normalization statistics come from stage-① / ② data, derivative feature
channels from stage-③ integers, full decompression only when a consumer
asks for raw floats.  Accessors compute on the store's ``device``.
"""
from __future__ import annotations

import dataclasses
import os
import zlib
from collections.abc import Iterator

import numpy as np
import torch

from ..core import Stage, by_name, encode as hsz_encode, homomorphic
from ..kernels import ops as kernel_ops

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


@dataclasses.dataclass
class CompressedShard:
    dataset: str
    field: int
    blob: bytes
    device: str | torch.device = "cuda"

    def open(self):
        """The shard's container, deserialized onto its device."""
        return hsz_encode.deserialize(self.blob, device=self.device)


class ScientificStore:
    """In-memory/on-disk store of HSZ-compressed field shards.

    A shard found under ``root`` as ``{dataset}_{field}.hsz`` is read, not
    synthesized: two stores (of either package) under one ``root`` answer
    from the same bytes.
    """

    def __init__(self, compressor_name: str = "hszp_nd", rel_eb: float = 1e-3,
                 scale: int = 8, seed: int = 0, root: str | None = None,
                 device="cuda"):
        self.comp_name = compressor_name
        self.rel_eb = rel_eb
        self.scale = scale
        self.seed = seed
        self.root = root
        self.device = kernel_ops.resolve_device(device)
        self._cache: dict[tuple[str, int], CompressedShard] = {}

    def _compressor(self):
        return by_name(self.comp_name)

    def put_all(self, datasets: list[str] | None = None):
        for name in datasets or DATASETS:
            fields, _ = DATASETS[name]
            for f in range(fields):
                self.get(name, f)

    def get(self, dataset: str, field: int) -> CompressedShard:
        key = (dataset, field)
        if key in self._cache:
            return self._cache[key]
        path = (os.path.join(self.root, f"{dataset}_{field}.hsz")
                if self.root else None)
        if path and os.path.exists(path):
            with open(path, "rb") as fh:
                blob = fh.read()
        else:
            dims = dataset_dims(dataset, self.scale)
            data = synth_field(dataset, field, dims, self.seed)
            c = self._compressor().compress(data, rel_eb=self.rel_eb,
                                            device=self.device)
            blob = hsz_encode.serialize(c)
            if path:
                os.makedirs(self.root, exist_ok=True)
                with open(path, "wb") as fh:
                    fh.write(blob)
        shard = CompressedShard(dataset, field, blob, self.device)
        self._cache[key] = shard
        return shard

    # -- homomorphic accessors (never decompress further than needed) -------
    def stats(self, dataset: str, field: int) -> dict[str, float]:
        c = self.get(dataset, field).open()
        stage = Stage.M if c.scheme.is_blockmean else Stage.P
        return {"mean": float(homomorphic.mean(c, stage)),
                "std": float(homomorphic.std(c, Stage.P))}

    def derivative_features(self, dataset: str, field: int,
                            stage: Stage = Stage.Q) -> tuple[torch.Tensor, ...]:
        c = self.get(dataset, field).open()
        return homomorphic.gradient(c, stage)

    def raw(self, dataset: str, field: int) -> torch.Tensor:
        c = self.get(dataset, field).open()
        return self._compressor().decompress(c, Stage.F)

    def normalized_batches(self, dataset: str, field: int, batch: int,
                           patch: tuple[int, ...] = (64, 64)
                           ) -> Iterator[np.ndarray]:
        """Training-style consumer: patches normalized by homomorphic stats."""
        st = self.stats(dataset, field)
        arr = self.raw(dataset, field).cpu().numpy()
        arr = (arr - st["mean"]) / max(st["std"], 1e-9)
        rng = np.random.default_rng(0)
        while True:
            coords = [rng.integers(0, max(1, s - p), size=batch)
                      for s, p in zip(arr.shape, patch)]
            out = np.stack([
                arr[tuple(slice(c[i], c[i] + p) for c, p in zip(coords, patch))]
                for i in range(batch)])
            yield out
