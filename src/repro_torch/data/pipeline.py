"""Deterministic synthetic LM data: the port's own copy of
``repro/data/pipeline.py`` (numpy only; the port imports nothing of
``repro``).

Batch ``i`` is a pure function of (seed, i, shard), so a resumed run needs
only its step counter, and any host can regenerate any shard.  Sequences
follow a seeded affine chain over the vocabulary with occasional resets and
noise tokens, so a model's loss falls as it trains (uniform tokens would
pin the cross-entropy at ln V).  The arrays are the JAX package's, value for
value, for every (seed, index, shard).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_shards: int = 1  # data-loading hosts
    shard: int = 0


class SyntheticLM:
    """Batch ``i`` -> {"tokens", "labels"}: (shard batch, seq_len) int32 numpy
    arrays, labels the tokens shifted by one."""

    def __init__(self, cfg: DataConfig) -> None:
        if cfg.global_batch % cfg.n_shards:
            raise ValueError(f"global batch {cfg.global_batch} does not split over "
                             f"{cfg.n_shards} shards")
        self.cfg = cfg
        self.shard_batch = cfg.global_batch // cfg.n_shards
        base = np.random.Generator(np.random.Philox(key=cfg.seed))
        v = cfg.vocab_size
        # fixed affine-chain parameters define the learnable structure
        self.mult = int(base.integers(2, max(3, v // 2))) * 2 + 1  # odd -> bijective
        self.add = int(base.integers(1, v))
        self.reset_p = 0.02
        self.noise_p = 0.05

    def batch(self, index: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.Generator(
            np.random.Philox(key=cfg.seed, counter=[0, 0, cfg.shard, index])
        )
        B, S, V = self.shard_batch, cfg.seq_len, cfg.vocab_size
        toks = np.empty((B, S + 1), np.int64)
        toks[:, 0] = rng.integers(0, V, B)
        resets = rng.random((B, S)) < self.reset_p
        noise = rng.random((B, S)) < self.noise_p
        rand_toks = rng.integers(0, V, (B, S))
        for t in range(1, S + 1):
            nxt = (toks[:, t - 1] * self.mult + self.add) % V
            nxt = np.where(noise[:, t - 1], rand_toks[:, t - 1], nxt)
            toks[:, t] = np.where(resets[:, t - 1], rand_toks[:, t - 1], nxt)
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }

    def iterate(self, start: int = 0) -> Iterator[dict[str, np.ndarray]]:
        i = start
        while True:
            yield self.batch(i)
            i += 1
