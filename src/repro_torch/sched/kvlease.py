"""Shared KV-pool lease manager for cross-request chunk pipelining.

With one request in flight, MBKR's static slot plan (``core.mbkr``) proves
per-stage occupancy stays within ``num_slots`` chunk slots. Continuous
scheduling admits the NEXT request's chunks into early stages while the
previous request's KV still drains from late stages — and may mix buckets
whose chunks have different byte sizes — so the slot-plan guarantee no longer
comes for free. The lease manager restores it by accounting:

- a LEASE per admitted request: the full timestamped alloc/free event stream
  the request will generate at every stage (local chunk KV below p2, hosted
  spill bytes at the MBKR pair stage from p2 on), known analytically at
  admission time because stages are in-order FIFOs;
- a per-stage byte BUDGET (the MBKR slot pool: ``num_slots`` x the largest
  admitted chunk's KV bytes, never more than the stage's physical capacity);
- an admission check: a request is admitted only if merging its lease into
  the committed timeline keeps every stage's peak occupancy <= budget — the
  scheduler defers (or ultimately rejects) the request otherwise.

The high-water mark per stage is tracked so tests can assert the invariant
``hwm <= budget`` under arbitrary concurrent workloads.
"""
from __future__ import annotations

import math
from bisect import insort
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class LeaseEvent:
    stage: int
    time: float
    nbytes: float        # positive = alloc, negative = free


@dataclass
class Lease:
    """One admitted request's reservation: its full event stream plus the
    time at which the last byte is released (all stages drained)."""
    rid: int
    events: Tuple[LeaseEvent, ...]
    release_time: float


def chunk_page_bytes(
    kvb: Sequence[float],
    chunks: Sequence[int],
    seq_len: Optional[int],
    page_tokens: int,
    shared_pages: Optional[Sequence[int]] = None,
) -> List[float]:
    """Per-chunk STORED bytes at PAGE granularity.

    ``kvb[i]`` prices the whole bucket chunk; the page store only allocates
    pages for the request's VALID tokens (a request near the bottom of its
    bucket fills only part of its tail chunk, and chunks entirely beyond
    ``seq_len`` allocate nothing). Bytes round UP to whole pages — page
    granularity, not token granularity — and never exceed the whole-chunk
    figure. ``page_tokens <= 0`` means one page per chunk (the coarsest
    paging: a touched chunk allocates fully, an untouched chunk nothing).
    ``seq_len=None`` keeps the legacy whole-bucket accounting.

    ``shared_pages[i]`` is the number of chunk-``i`` pages already resident
    in a prefix index (the reference's ``kvstore.prefix``; the port has
    none yet): shared pages cost ZERO lease
    bytes — the holder of the radix refcount pays for them once — so a
    request whose prefix hits leases only its novel suffix.  With
    ``seq_len=None`` sharing applies against the whole-chunk page count.
    """
    if seq_len is None and shared_pages is None:
        return [float(b) for b in kvb]
    out: List[float] = []
    start = 0
    for i, (b, c) in enumerate(zip(kvb, chunks)):
        pt = page_tokens if page_tokens > 0 else int(c)
        full_pages = -(-int(c) // pt)
        if seq_len is None:
            n_pages = full_pages
        else:
            valid = min(max(seq_len - start, 0), int(c))
            n_pages = min(-(-valid // pt), full_pages)
        if shared_pages is not None and i < len(shared_pages):
            n_pages = max(n_pages - int(shared_pages[i]), 0)
        out.append(float(b) * n_pages / full_pages)
        start += int(c)
    return out


def request_lease_events(
    rid: int,
    finish: np.ndarray,            # [M][N] chunk completion times
    kvb: Sequence[float],          # [M] chunk KV bytes (model dtype)
    p2: int,
    pair: Sequence[int],           # stage -> MBKR pair stage
    compress: float = 1.0,
    kv_compress: float = 1.0,
    *,
    seq_len: Optional[int] = None,
    chunks: Optional[Sequence[int]] = None,
    page_tokens: int = 0,
    shared_pages: Optional[Sequence[int]] = None,
) -> Lease:
    """Build the lease for one scheduled request from its chunk finish times.

    Chunk i's KV materializes at the stage when the chunk completes there
    (locally for i < p2, at the pair stage scaled by ``compress`` for spilled
    chunks); everything a request holds at stage s frees when its tail chunk
    clears s — the same lifecycle the event simulator's memory tracker uses.
    Alloc AND free events are per-chunk page allocations (see
    ``chunk_page_bytes``): with ``seq_len``/``chunks``/``page_tokens`` given,
    a request leases only the pages its valid tokens touch — a long unused
    bucket tail (seq_len far below the bucket) stops reserving phantom
    bytes, so longer-tail buckets admit sooner.

    ``kv_compress`` is the KV page store's stored-bytes factor
    (``kvstore.quant.kv_compress_factor``): with a quantized ``kv_dtype``
    EVERY resident byte — local and hosted — shrinks by it, which is what
    grows admission capacity ~2x per one-byte codec at a fixed physical
    budget. ``compress`` stays the legacy wire/creditor factor applied to
    spilled chunks only.

    ``shared_pages`` (per chunk, from a prefix index) zeroes the lease
    price of pages another live lease already holds — suffix-only leasing
    (DESIGN.md §11): the alloc/free EVENTS of
    fully-shared chunks vanish, so peaks, headroom and the high-water mark
    all see only novel bytes.
    """
    m, n = finish.shape
    if chunks is None:
        seq_len = None  # page accounting needs the chunk split
        shared_pages = None
    pkvb = chunk_page_bytes(kvb, chunks if chunks is not None else [1] * m,
                            seq_len, page_tokens, shared_pages)
    ev: List[LeaseEvent] = []
    for s in range(n):
        t_drain = float(finish[m - 1][s])
        for i in range(m):
            b = pkvb[i] * kv_compress
            if i >= p2:
                b *= compress
            if b == 0.0:
                continue  # beyond seq_len: no pages, no events
            stage = s if i < p2 else pair[s]
            ev.append(LeaseEvent(stage, float(finish[i][s]), b))
            ev.append(LeaseEvent(stage, t_drain, -b))
    release = float(finish[m - 1].max())
    return Lease(rid, tuple(ev), release)


class KVLeaseManager:
    """Per-stage KV occupancy accounting with admission control.

    ``budget[s]`` is in bytes (derive it from an MBKR plan with
    ``slot_budget_bytes``). Frees sort before allocs at equal timestamps —
    the slot plan reuses a slot at the very tick its tenant dies.
    """

    def __init__(self, num_stages: int, budget: Sequence[float]):
        assert len(budget) == num_stages
        self.num_stages = num_stages
        self.budget = np.asarray(budget, float)
        # committed timeline per stage: sorted (time, delta) with frees first
        self._timeline: List[List[Tuple[float, float]]] = [
            [] for _ in range(num_stages)]
        self.leases: Dict[int, Lease] = {}
        self.hwm = np.zeros(num_stages)
        self._refused_rids: set = set()

    @property
    def refusals(self) -> int:
        """DISTINCT requests ever refused (a deferred request retried many
        times counts once)."""
        return len(self._refused_rids)

    # ------------------------------------------------------------- queries
    def _peak_with(self, stage: int, extra: List[Tuple[float, float]]) -> float:
        ev = sorted(self._timeline[stage] + extra)
        cur = peak = 0.0
        for _, d in ev:
            cur += d
            peak = max(peak, cur)
        return peak

    def _fit_peaks(self, lease: Lease) -> Optional[Dict[int, float]]:
        """Per-touched-stage peaks with the lease merged in, or None if any
        stage would exceed its budget."""
        per_stage: Dict[int, List[Tuple[float, float]]] = {}
        for e in lease.events:
            per_stage.setdefault(e.stage, []).append((e.time, e.nbytes))
        peaks: Dict[int, float] = {}
        for s, extra in per_stage.items():
            pk = self._peak_with(s, extra)
            if pk > self.budget[s] * (1 + 1e-9):
                return None
            peaks[s] = pk
        return peaks

    def would_fit(self, lease: Lease) -> bool:
        return self._fit_peaks(lease) is not None

    def headroom(self, after: float = 0.0) -> np.ndarray:
        """Per-stage FREE bytes guaranteed from ``after`` on: budget minus
        the peak committed occupancy over ``[after, inf)`` (the level carried
        into ``after`` counts — a lease allocated before and freed after
        still occupies the pool at ``after``). This is the fleet router's
        free-KV-lease signal (the reference's ``repro.fleet``, not ported
        yet): a cell whose pool is packed with long-lived leases reports
        near-zero headroom even if nothing is executing this instant."""
        free = np.empty(self.num_stages)
        for s, tl in enumerate(self._timeline):
            events = sorted(tl)
            cur = 0.0
            i = 0
            while i < len(events) and events[i][0] < after:
                cur += events[i][1]
                i += 1
            peak = cur
            for _, d in events[i:]:
                cur += d
                peak = max(peak, cur)
            free[s] = self.budget[s] - peak
        return free

    # ------------------------------------------------------------ mutation
    def admit(self, lease: Lease) -> bool:
        """Commit the lease if it fits every stage's budget; else refuse."""
        peaks = self._fit_peaks(lease)
        if peaks is None:
            self._refused_rids.add(lease.rid)
            return False
        for e in lease.events:
            insort(self._timeline[e.stage], (e.time, e.nbytes))
        for s, pk in peaks.items():   # only touched stages can move the hwm
            self.hwm[s] = max(self.hwm[s], pk)
        self.leases[lease.rid] = lease
        return True

    def next_release(self, after: float) -> float:
        """Earliest committed lease release strictly after ``after`` — the
        next instant a deferred admission is worth retrying."""
        times = [l.release_time for l in self.leases.values()
                 if l.release_time > after]
        return min(times) if times else math.inf

    def prune(self, before: float) -> None:
        """Drop fully-released leases that ended before ``before`` (their
        alloc/free pairs cancel; keeps timelines from growing unboundedly)."""
        from collections import Counter
        dead = [rid for rid, l in self.leases.items()
                if l.release_time < before]
        if not dead:
            return
        drop = Counter((e.stage, e.time, e.nbytes)
                       for rid in dead for e in self.leases[rid].events)
        for s in range(self.num_stages):
            keep = []
            for t, d in self._timeline[s]:
                if drop.get((s, t, d), 0) > 0:
                    drop[(s, t, d)] -= 1
                else:
                    keep.append((t, d))
            self._timeline[s] = keep
        for rid in dead:
            del self.leases[rid]


def slot_budget_bytes(num_slots: int, chunk_bytes: float, num_stages: int,
                      capacity: Optional[float] = None) -> np.ndarray:
    """Per-stage byte budget for the MBKR slot pool: ``num_slots`` slots sized
    for the largest chunk, clamped to the physical KV capacity if given."""
    b = num_slots * chunk_bytes
    if capacity is not None:
        b = min(b, capacity)
    return np.full(num_stages, float(b))
