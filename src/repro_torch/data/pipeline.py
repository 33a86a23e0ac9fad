"""Deterministic synthetic LM data stream: seeded, shardable, resumable
(the port's own copy of ``repro.data.pipeline``, numpy only; its batches
equal the reference's bit for bit).

Every batch is a pure function of (seed, step, shard) — a restart from a
checkpointed ``DataState`` reproduces the exact stream, and each data-parallel
shard draws only its slice (no host ever materializes the global batch).

The token stream is structured (Zipf unigrams + a Markov backbone + repeated
motifs) so that a model trained on it shows a real, decreasing loss curve —
enough signal for the end-to-end training example without external data.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterator

import numpy as np


@dataclass
class DataState:
    seed: int
    step: int = 0

    def to_dict(self) -> Dict[str, int]:
        return {"seed": self.seed, "step": self.step}

    @staticmethod
    def from_dict(d) -> "DataState":
        return DataState(int(d["seed"]), int(d["step"]))


class SyntheticLM:
    """Sharded synthetic next-token-prediction stream.

    Args:
      vocab_size, seq_len: token geometry.
      global_batch: total batch across all shards.
      shard / num_shards: this host's slice of the batch.
    """

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int, *,
                 seed: int = 0, shard: int = 0, num_shards: int = 1,
                 motif_len: int = 16):
        assert global_batch % num_shards == 0
        self.vocab = vocab_size
        self.seq = seq_len
        self.local_batch = global_batch // num_shards
        self.shard = shard
        self.num_shards = num_shards
        self.motif_len = motif_len
        self.state = DataState(seed)
        # fixed Markov backbone: next ~ (a * cur + b) mod V over a small field,
        # mixed with Zipf noise — cheap, stationary, learnable
        rng = np.random.default_rng(seed)
        self._a = int(rng.integers(2, 64))
        self._b = int(rng.integers(1, vocab_size))
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        p = 1.0 / ranks
        self._zipf = p / p.sum()

    def _batch_rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.state.seed, step, self.shard]))

    def next_batch(self) -> Dict[str, np.ndarray]:
        rng = self._batch_rng(self.state.step)
        b, s, v = self.local_batch, self.seq, self.vocab
        noise = rng.choice(v, size=(b, s), p=self._zipf).astype(np.int64)
        toks = np.empty((b, s), np.int64)
        toks[:, 0] = noise[:, 0]
        use_markov = rng.random((b, s)) < 0.7
        for t in range(1, s):
            markov = (self._a * toks[:, t - 1] + self._b) % v
            toks[:, t] = np.where(use_markov[:, t], markov, noise[:, t])
        # splice a repeated motif (teaches copying / induction)
        ml = min(self.motif_len, s // 4)
        if ml > 1:
            starts = rng.integers(0, s // 2 - ml, size=b)
            for i in range(b):
                m0 = starts[i]
                toks[i, m0 + s // 2: m0 + s // 2 + ml] = toks[i, m0: m0 + ml]
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = toks[:, 0]
        self.state.step += 1
        return {"tokens": toks.astype(np.int32), "labels": labels.astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()

    # ------------------------------------------------------------- resume
    def checkpoint(self) -> Dict[str, int]:
        return self.state.to_dict()

    def restore(self, d) -> None:
        st = DataState.from_dict(d)
        assert st.seed == self.state.seed, "restoring a different stream"
        self.state = st
