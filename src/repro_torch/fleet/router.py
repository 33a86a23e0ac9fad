"""Fleet router: pick the serving cell for each arriving request.

The router is PURE POLICY — it never mutates a cell. It reads one
``CellSignals`` snapshot per candidate (through the ``CellHandle``
protocol) and returns a ``PlacementDecision``; the fabric does the actual
``submit`` and pumps the chosen cell so the next placement sees fresh
frontiers. Draining cells are never candidates under any policy.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, List, Mapping, Optional, Sequence, Tuple

from repro_torch.fleet.placement import (CellSignals, ROUTER_POLICIES,
                                         score_cells, snapshot)


@dataclass(frozen=True)
class PlacementDecision:
    rid: int
    cell: str
    policy: str
    eta: float                      # chosen cell's quoted finish (jsf) / nan
    signals: Tuple[CellSignals, ...]   # every candidate consulted
    # admission control: True when EVERY live cell's KV-lease headroom is
    # exhausted — the fabric must NOT submit; retry_after is the earliest
    # quoted instant a retry could land (min finite ETA across live cells)
    rejected: bool = False
    retry_after: float = math.inf


class FleetRouter:
    """Stateless scoring + one rotation counter (for ``rr``).

    ``place`` raises ``RuntimeError`` when every cell is draining — the
    fleet has stopped admitting; callers surface that as a rejection.
    """

    def __init__(self, policy: str = "jsf"):
        if policy not in ROUTER_POLICIES:
            raise ValueError(f"unknown router policy {policy!r}; expected "
                             f"one of {list(ROUTER_POLICIES)}")
        self.policy = policy
        self.decisions: List[PlacementDecision] = []
        self.rejections = 0
        self._rr = 0

    def place(self, cells: Mapping[str, Any], rid: int, seq_len: int,
              arrival: float = 0.0,
              prefix_hashes: Optional[Sequence[int]] = None
              ) -> PlacementDecision:
        """Choose the cell for one request. ``cells`` maps name -> CellHandle
        in a stable order (insertion order drives rr rotation and
        tie-breaks). ``prefix_hashes`` arms the prefix-affinity signals.

        Admission control: when EVERY live cell's KV-lease headroom is
        exhausted the request is REJECTED (``rejected=True``) with an
        explicit ``retry_after`` — the earliest finite ETA any live cell
        quoted (i.e. the earliest instant a committed lease could release
        capacity) — instead of being queued behind a lease that may never
        clear."""
        sigs = tuple(snapshot(name, i, cell, seq_len, arrival,
                              prefix_hashes=prefix_hashes)
                     for i, (name, cell) in enumerate(cells.items()))
        live = [s for s in sigs if not s.draining]
        if not live:
            raise RuntimeError(
                "all fleet cells are draining: admission is closed")
        if all(s.free_lease_bytes <= 0.0 for s in live):
            etas = [s.eta for s in live if math.isfinite(s.eta)]
            dec = PlacementDecision(
                rid=rid, cell="", policy=self.policy, eta=math.inf,
                signals=sigs, rejected=True,
                retry_after=min(etas) if etas else math.inf)
            self.rejections += 1
            self.decisions.append(dec)
            return dec
        if self.policy == "rr":
            chosen = live[self._rr % len(live)]
            self._rr += 1
        else:
            chosen = score_cells(self.policy, sigs)[0][1]
        dec = PlacementDecision(rid=rid, cell=chosen.name, policy=self.policy,
                                eta=chosen.eta, signals=sigs)
        self.decisions.append(dec)
        return dec
