"""Stage-axis transport and the CollectiveLedger (mirrors
``repro.core.transport``).

The reference runs the N stages on N chips and moves bytes with
``ppermute`` / ``psum``. The port keeps the stage axis as dim 0 of every
tensor on one GPU, so:

- ``ring_shift``  (perm i -> i+1) is ``torch.roll(x, 1, dims=0)``: stage j
  receives stage j-1's tensor;
- ``pair_shift``  (perm i -> i+N/2) is ``torch.roll(x, N//2, dims=0)``;
- ``stage_psum``  is a sum over dim 0, broadcast back.

The ledger keeps the reference's per-chip byte model: each call charges the
bytes ONE stage's slice puts on the wire, once for every stage whose
``active`` flag is set (the reference charges each chip under its own
predicate and then sums over chips). The predicates depend only on the tick
and the stage index, so they are host-side numpy arrays and the ledger is a
dict of Python floats.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kvstore.quant import as_bytes

LEDGER_KEYS = ("ring", "collect", "spill", "fetch", "qship_q", "qship_state",
               "tp", "prefix_hit")

Ledger = Optional[Dict[str, float]]


def ledger_init() -> Dict[str, float]:
    return {k: 0.0 for k in LEDGER_KEYS}


def nbytes(x: torch.Tensor) -> float:
    """Wire bytes of one stage's slice of a stage-stacked tensor (dim 0 is
    the stage axis)."""
    return float(x[0].numel() * x.element_size())


def _roll(x: torch.Tensor, shift: int) -> torch.Tensor:
    return torch.roll(as_bytes(x), shift, dims=0).view(x.dtype)


def charge(led: Ledger, key: str, amount: float, active=None) -> Ledger:
    """Add ``amount`` bytes to ``led[key]`` once per stage whose ``active``
    flag is set (``active`` [N] bool, numpy). No-op on a None ledger."""
    if led is None or amount == 0.0:
        return led
    n = 1 if active is None else int(np.count_nonzero(active))
    out = dict(led)
    out[key] = led[key] + amount * n
    return out


def ledger_to_dict(led) -> Dict[str, float]:
    return {k: float(v) for k, v in led.items()}


class StageAxisTransport:
    """Stage-axis movement on one device; tensors carry the stage axis at
    dim 0. Every call takes and returns the ledger."""

    name = "stage_axis"

    @staticmethod
    def _all(x: torch.Tensor) -> np.ndarray:
        return np.ones(x.shape[0], bool)

    def ring_shift(self, x: torch.Tensor, led: Ledger = None, *,
                   active=None) -> Tuple[torch.Tensor, Ledger]:
        """Activation advance to the next stage (ring +1)."""
        act = self._all(x) if active is None else active
        return _roll(x, 1), charge(led, "ring", nbytes(x), act)

    def pair_shift(self, x: torch.Tensor, led: Ledger = None, *, tag: str,
                   active=None) -> Tuple[torch.Tensor, Ledger]:
        """Cross-half MBKR pairing permute; ``tag`` picks the ledger
        category (spill | fetch | qship_q | qship_state)."""
        act = self._all(x) if active is None else active
        return (_roll(x, x.shape[0] // 2),
                charge(led, tag, nbytes(x), act))

    def stage_psum(self, x: torch.Tensor, led: Ledger = None, *,
                   active=None) -> Tuple[torch.Tensor, Ledger]:
        """All-reduce over the stage axis (ring model: 2(k-1)/k bytes per
        chip)."""
        k = x.shape[0]
        act = self._all(x) if active is None else active
        out = x.sum(dim=0, keepdim=True).expand_as(x)
        return out, charge(led, "collect", 2.0 * (k - 1) / k * nbytes(x), act)
