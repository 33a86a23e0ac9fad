"""Chunk partitioning. This slice serves the uniform partition only (the
LBCP DP + annealing planner of ``repro.core.lbcp`` is not ported yet)."""
from __future__ import annotations

from typing import List


def uniform_partition(seq_len: int, num_chunks: int) -> List[int]:
    base = seq_len // num_chunks
    rem = seq_len % num_chunks
    return [base + (1 if i < rem else 0) for i in range(num_chunks)]
