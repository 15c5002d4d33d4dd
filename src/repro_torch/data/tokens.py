"""Deterministic, resumable, sharded synthetic LM token pipeline.

Batches are pure functions of (seed, step, shard) — a stateless design that
makes the pipeline trivially resumable (state == step counter), elastic
(re-sharding changes only the shard index arithmetic), and reproducible
across restarts, which the fault-tolerance tests rely on.  Tokens follow a
Zipf-like marginal with short-range Markov structure so losses decrease
meaningfully during the example runs (pure-uniform tokens give constant
loss and hide optimizer bugs).
"""
from __future__ import annotations
from collections.abc import Iterator

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_shards: int = 1
    shard: int = 0


class TokenPipeline:
    """Iterator with explicit integer state (= next step index)."""

    def __init__(self, cfg: TokenPipelineConfig, start_step: int = 0):
        self.cfg = cfg
        self.step = start_step
        if cfg.global_batch % cfg.n_shards:
            raise ValueError("global_batch must divide by n_shards")

    # -- stateless batch function ------------------------------------------
    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        per_shard = cfg.global_batch // cfg.n_shards
        rng = np.random.default_rng(
            np.uint64(cfg.seed) * np.uint64(1_000_003)
            + np.uint64(step) * np.uint64(65_537) + np.uint64(cfg.shard))
        # Zipf-ish unigram + first-order Markov "phrases"
        base = rng.zipf(1.3, size=(per_shard, cfg.seq_len)).astype(np.int64)
        tokens = base % max(cfg.vocab - 2, 1) + 1
        # repeat structure: with p=0.35 copy the previous token (learnable)
        copy = rng.random((per_shard, cfg.seq_len)) < 0.35
        for j in range(1, cfg.seq_len):
            tokens[:, j] = np.where(copy[:, j], tokens[:, j - 1], tokens[:, j])
        return {"tokens": tokens.astype(np.int32)}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        return self

    def __next__(self) -> dict[str, np.ndarray]:
        b = self.batch_at(self.step)
        self.step += 1
        return b

    # -- checkpointable state ----------------------------------------------
    def state_dict(self) -> dict[str, int]:
        return {"step": self.step}

    def load_state_dict(self, state: dict[str, int]):
        self.step = int(state["step"])
