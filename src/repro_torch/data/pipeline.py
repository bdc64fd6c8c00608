"""Deterministic sharded token pipeline (the port's copy of
``repro.data.pipeline``; numpy only, so a batch is bit-equal to the
reference's for the same ``(seed, step, shard_index, shard_count)``).

Sources:
  * SyntheticSource - structured pseudo-text (Zipf-distributed n-gram chains),
    deterministic in (seed, step, shard) so every host materializes exactly
    its own shard without coordination.
  * FileSource - memory-mapped token file (np.uint32), strided host shards.

Batches are host numpy arrays; the trainer moves them to its device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch_size: int  # host-local
    seq_len: int
    vocab_size: int
    seed: int = 0
    shard_index: int = 0
    shard_count: int = 1
    path: Optional[str] = None  # FileSource when set


class SyntheticSource:
    """Zipf-ish Markov chains: deterministic, compressible (loss can go well
    below ln(V)), and cheap to generate per host shard."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        V = cfg.vocab_size
        # a sparse deterministic transition table: each token prefers 8 successors
        self.successors = rng.integers(0, V, size=(V, 8), dtype=np.int64)
        self.zipf_p = 1.0 / np.arange(1, 9)
        self.zipf_p /= self.zipf_p.sum()

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * cfg.shard_count + cfg.shard_index)
        B, L = cfg.batch_size, cfg.seq_len
        toks = np.empty((B, L), dtype=np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab_size, size=B)
        choices = rng.choice(8, size=(B, L), p=self.zipf_p)
        for t in range(1, L):
            toks[:, t] = self.successors[toks[:, t - 1], choices[:, t]]
        return {"tokens": toks}


class FileSource:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.data = np.memmap(cfg.path, dtype=np.uint32, mode="r")
        self.tokens_per_batch = cfg.batch_size * cfg.seq_len
        usable = len(self.data) - self.tokens_per_batch * cfg.shard_count
        if usable <= 0:
            raise ValueError("token file smaller than one global batch")

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        stride = self.tokens_per_batch * cfg.shard_count
        start = (step * stride + cfg.shard_index * self.tokens_per_batch) % (
            len(self.data) - self.tokens_per_batch)
        flat = np.asarray(self.data[start:start + self.tokens_per_batch])
        return {"tokens": flat.reshape(cfg.batch_size, cfg.seq_len).astype(np.int32)}


def make_source(cfg: DataConfig):
    return FileSource(cfg) if cfg.path else SyntheticSource(cfg)


def iterate(cfg: DataConfig, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    src = make_source(cfg)
    step = start_step
    while True:
        yield src.batch(step)
        step += 1
