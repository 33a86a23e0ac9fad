"""Whether what the timed path returned is right: the next-token logits of
a sample of the requests the window completed, against the family's plain
reference on the same prompts with the weights remade from the seed.

The number held to the cell's limit (``check.limits`` in its file) is
``logit_err``: the largest |program - reference| of a request's logits, as
a share of that request's max |reference logit|, over the sample.

The sample is drawn from the seed, of the completed requests: every
request of one of the waves that held the most (so each row of a full
batch is compared), one of the longest requests, then the rest.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from portbench.harness.weights import sub_seed


def sample(served: Sequence, k: int, seed: int) -> List:
    """At least ``k`` of ``served`` (all if fewer), drawn from the seed: the
    whole of one wave of the most requests (a wave's requests share their
    ``start``), one of the longest requests if that wave holds none, then
    others up to ``k``."""
    if not served:
        return []
    items = sorted(served, key=lambda s: s.rid)
    rng = np.random.default_rng(sub_seed(seed, "check"))
    waves: Dict[float, List] = {}
    for s in items:
        waves.setdefault(s.start, []).append(s)
    most = max(len(w) for w in waves.values())
    fullest = [w for w in waves.values() if len(w) == most]
    picked = list(fullest[int(rng.integers(len(fullest)))])
    top = max(s.seq for s in items)
    if all(s.seq < top for s in picked):
        longest = [s for s in items if s.seq == top]
        picked.append(longest[int(rng.integers(len(longest)))])
    chosen = {s.rid for s in picked}
    rest = [s for s in items if s.rid not in chosen]
    more = rng.choice(len(rest), size=min(max(k - len(picked), 0), len(rest)), replace=False)
    return picked + [rest[i] for i in sorted(more)]


def numbers(got: np.ndarray, want: np.ndarray) -> Dict[str, float]:
    """The compared numbers of logits ``got`` against ``want`` ([R, V])."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max(axis=1)
    err = np.abs(got - want).max(axis=1) / scale
    return {"logit_err": float(err.max())}


def judge(nums: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """(every number within its limit, {name: {value, limit}}). A number
    that is not finite fails, and is written as null."""
    ok = all(np.isfinite(nums[k]) and nums[k] <= limits[k] for k in limits)
    checks = {k: {"value": nums[k] if np.isfinite(nums[k]) else None,
                  "limit": float(limits[k])} for k in limits}
    return ok, checks
