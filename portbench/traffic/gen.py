"""Seeded request generators, the one generator every traffic mix reads.

Frozen copies, from commit f0f447b: ``poisson_arrivals`` of
``src/repro_torch/sched/scheduler.py`` and the token draw of
``src/repro_torch/launch/serve.py``'s ``make_requests`` (one
``numpy.random.default_rng(seed)`` stream, ``integers(0, vocab, size=S)``
a request, in request order).
"""
from __future__ import annotations

from typing import List

import numpy as np


def poisson_arrivals(rate: float, n: int, seed: int = 0,
                     start: float = 0.0) -> List[float]:
    """Open-loop Poisson arrival timestamps: ``n`` i.i.d. exponential gaps at
    ``rate`` req/s. ``rate <= 0`` degenerates to a closed-loop burst at
    ``start`` (everything arrives at once)."""
    if rate <= 0:
        return [start] * n
    rng = np.random.default_rng(seed)
    return list(start + np.cumsum(rng.exponential(1.0 / rate, size=n)))


class TokenStream:
    """``make_requests``' token draw, one request at a time: the i-th call
    gives the i-th request's ``seq`` token ids."""

    def __init__(self, seed: int, vocab: int):
        self.rng = np.random.default_rng(seed)
        self.vocab = vocab

    def next(self, seq: int) -> np.ndarray:
        return self.rng.integers(0, self.vocab, size=seq).astype(np.int64)
