"""Synthetic, deterministic, shardable data pipeline (a copy of
``repro/training/data.py``: its batches are the reference's, bit for bit,
for every (seed, step, shard, task_id)).

No datasets ship offline, so the pipeline synthesizes token streams with a
fixed PRNG — deterministic per (seed, step, shard), which makes multi-host
sharding trivial: every host computes only its shard of the global batch.
Structure (Zipfian ids + repeated n-grams) gives the LoRA fine-tune examples
something learnable.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3
    # task flavour for LoRA fine-tuning: each "adapter id" gets its own
    # deterministic mapping so adapters learn distinguishable behaviour.
    task_id: int = 0


class SyntheticStream:
    """Iterator of {tokens, labels} batches (next-token prediction)."""

    def __init__(self, cfg: DataConfig, shard_index: int = 0,
                 num_shards: int = 1):
        if cfg.global_batch % num_shards:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split over {num_shards} shards")
        self.cfg = cfg
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.local_batch = cfg.global_batch // num_shards
        self._step = 0

    def _batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 65_537 + self.shard_index)
        v = cfg.vocab_size
        # zipfian base stream
        ranks = rng.zipf(cfg.zipf_a, size=(self.local_batch, cfg.seq_len + 1))
        toks = (ranks + cfg.task_id * 7919) % v
        # inject learnable bigram structure: token after marker M is f(M)
        marker = (13 + cfg.task_id) % v
        is_marker = toks[:, :-1] == marker
        follow = (marker * 31 + 7) % v
        toks[:, 1:][is_marker] = follow
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        b = self._batch(self._step)
        self._step += 1
        return b


def make_stream(vocab_size: int, seq_len: int, global_batch: int,
                seed: int = 0, task_id: int = 0, shard_index: int = 0,
                num_shards: int = 1) -> SyntheticStream:
    return SyntheticStream(
        DataConfig(vocab_size=vocab_size, seq_len=seq_len,
                   global_batch=global_batch, seed=seed, task_id=task_id),
        shard_index=shard_index, num_shards=num_shards)
