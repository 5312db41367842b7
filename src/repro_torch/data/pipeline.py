"""Deterministic synthetic LM data (copy of ``SyntheticLM`` from
``repro.data.pipeline``).

Numpy, as in the reference, so one seed gives the same batches in both
packages.  Every (step, shard) batch is a pure function of ``(seed, step,
shard)``.  Tokens follow an order-1 Markov chain over a fixed sparse
transition table, so cross-entropy can fall below log V.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class SyntheticLM:
    """Deterministic synthetic LM token stream."""

    def __init__(
        self,
        vocab_size: int,
        seq_len: int,
        global_batch: int,
        seed: int = 0,
        n_shards: int = 1,
        shard: int = 0,
        branching: int = 4,
    ):
        assert global_batch % n_shards == 0
        self.vocab = vocab_size
        self.seq_len = seq_len
        self.batch = global_batch // n_shards
        self.seed = seed
        self.n_shards = n_shards
        self.shard = shard
        self.branching = min(branching, vocab_size)
        # fixed sparse transition table: token t -> one of `branching` nexts
        rng = np.random.default_rng(seed)
        self.table = rng.integers(0, vocab_size, size=(vocab_size, self.branching))

    def batch_at(self, step: int, shard: Optional[int] = None) -> Dict[str, np.ndarray]:
        """The batch for (step, shard): ``tokens`` and ``labels`` [B, T]
        int32, the labels the tokens shifted by one."""
        shard = self.shard if shard is None else shard
        rng = np.random.default_rng((self.seed * 1_000_003 + step) * 65_537 + shard)
        toks = np.empty((self.batch, self.seq_len + 1), np.int64)
        toks[:, 0] = rng.integers(0, self.vocab, self.batch)
        choices = rng.integers(0, self.branching, (self.batch, self.seq_len))
        for t in range(self.seq_len):
            toks[:, t + 1] = self.table[toks[:, t], choices[:, t]]
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }
