"""Placement signals and scoring for the fleet router.

Every policy reduces to: read one ``CellSignals`` snapshot per candidate
cell (through the ``CellHandle`` protocol only), score the candidates,
pick the minimum. Scores are (primary, tiebreak...) tuples so policies
stay deterministic under ties — ties always break toward the lower cell
index, which is what makes ``rr`` vs ``jsf`` comparisons reproducible.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class CellSignals:
    """One router-visible snapshot of a cell, taken at placement time.

    ``eta`` is the cell's own quote for the candidate request
    (``CellHandle.estimate_admission``): predicted finish time on ITS cost
    vectors, with a lease-wait penalty already folded in when the KV lease
    does not fit now. ``lease_fits`` says whether the quote required
    deferring behind an existing lease. ``free_lease_bytes`` is the
    tightest per-stage KV headroom; ``queue_depth`` the live request count.
    ``prefix_hit_pages`` is how many of the request's prefix pages this
    cell's radix index already holds (``CellHandle.prefix_hit_pages``) —
    the prefix-affinity signal; 0 when the cache is off or no hashes were
    passed.
    """
    name: str
    index: int
    eta: float
    lease_fits: bool
    free_lease_bytes: float
    queue_depth: int
    draining: bool = False
    prefix_hit_pages: int = 0


def snapshot(name: str, index: int, cell: Any, seq_len: int,
             arrival: float = 0.0,
             prefix_hashes: Optional[Sequence[int]] = None) -> CellSignals:
    """Read a cell's placement signals through the CellHandle protocol.
    ``prefix_hashes`` (the request's chunk-hash chain) folds the radix
    index into both the ETA quote and the affinity tiebreak; cells that
    predate the prefix signals are read as hit-free."""
    if prefix_hashes:
        eta, fits = cell.estimate_admission(seq_len, arrival=arrival,
                                            prefix_hashes=prefix_hashes)
        hit = int(cell.prefix_hit_pages(prefix_hashes)) \
            if hasattr(cell, "prefix_hit_pages") else 0
    else:
        eta, fits = cell.estimate_admission(seq_len, arrival=arrival)
        hit = 0
    return CellSignals(
        name=name, index=index, eta=float(eta), lease_fits=bool(fits),
        free_lease_bytes=float(cell.free_lease_bytes()),
        queue_depth=int(cell.queue_depth()),
        draining=bool(cell.draining), prefix_hit_pages=hit)


# ------------------------------------------------------------------ scoring

def _score_jsf(s: CellSignals) -> Tuple:
    # earliest predicted finish; prefer a cell whose lease fits NOW over an
    # equal-ETA cell that had to defer; then the cell already holding the
    # request's prefix (its radix hit also shrank the ETA quote — this
    # tiebreak settles equal-ETA cells); then headroom, then index
    return (s.eta, 0 if s.lease_fits else 1,
            -s.prefix_hit_pages, -s.free_lease_bytes, s.index)


def _score_least_loaded(s: CellSignals) -> Tuple:
    return (s.queue_depth, -s.free_lease_bytes, s.index)


ROUTER_POLICIES: Tuple[str, ...] = ("jsf", "rr", "least-loaded")

_SCORERS = {"jsf": _score_jsf, "least-loaded": _score_least_loaded}


def score_cells(policy: str, signals: Sequence[CellSignals]
                ) -> List[Tuple[Tuple, CellSignals]]:
    """(score, signals) per non-draining candidate, best (lowest) first.

    ``rr`` has no score — the router owns its rotation counter — so asking
    for it here is a programming error, as is an unknown policy.
    """
    if policy not in _SCORERS:
        raise ValueError(
            f"unknown scoring policy {policy!r}; expected one of "
            f"{sorted(_SCORERS)} (rr is handled by the router's rotation)")
    fn = _SCORERS[policy]
    live = [s for s in signals if not s.draining]
    return sorted(((fn(s), s) for s in live), key=lambda p: p[0])
