"""Memory-Balanced KV Reallocation (MBKR) slot plan — the port's own copy of
``repro.core.mbkr`` (numpy only).

Fixed cross-half pairing (stage i <-> stage i + N/2); chunks with index
>= p2 spill at creation to the paired stage. ``plan`` turns the policy into
a static cyclic schedule over a shared pool of ``num_slots`` chunk slots per
stage (own_slot / host_slot tables), proven collision-free by
``verify_plan``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np


def pair_of(stage: int, num_stages: int) -> int:
    return (stage + num_stages // 2) % num_stages


def peak_slots(num_chunks: int, num_stages: int, p2: int) -> int:
    """Peak (own-local + hosted) chunk slots over the steady-state cycle,
    max over both pairing directions."""
    m, n2 = num_chunks, max(num_stages // 2, 1)
    peak = 0
    for phi in range(m):
        own = min(phi + 1, p2)
        for delta in (-n2, n2):
            psi = (phi + delta) % m
            hosted = max(0, (psi + 1) - p2)
            peak = max(peak, own + hosted)
    return peak


def best_p2(num_chunks: int, num_stages: int) -> Tuple[int, int]:
    """(p2, peak) minimizing peak slots; ties -> larger p2 (less traffic)."""
    best = (num_chunks, peak_slots(num_chunks, num_stages, num_chunks))
    for p2 in range(1, num_chunks + 1):
        pk = peak_slots(num_chunks, num_stages, p2)
        if pk < best[1] or (pk == best[1] and p2 > best[0]):
            best = (p2, pk)
    return best


@dataclass
class MBKRPlan:
    num_stages: int
    num_chunks: int
    p2: int
    p1: int
    num_slots: int                 # shared pool size (excl. the scratch slot)
    own_slot: np.ndarray           # [M] slot for own chunk phi (scratch if spilled)
    host_slot_a: np.ndarray        # [M] host slot, first-half stages
    host_slot_b: np.ndarray        # [M] host slot, second-half stages
    peak: int = 0

    @property
    def scratch(self) -> int:
        return self.num_slots


def _color(intervals, m: int) -> Tuple[Dict, int]:
    """Greedy cyclic-interval coloring. intervals: [(key, start, length)]."""
    slot_busy: List[np.ndarray] = []
    assign: Dict = {}
    for key, s, ln in sorted(intervals, key=lambda iv: (-iv[2], iv[1])):
        phases = [(s + k) % m for k in range(ln)]
        for si, busy in enumerate(slot_busy):
            if not busy[phases].any():
                busy[phases] = True
                assign[key] = si
                break
        else:
            busy = np.zeros(m, bool)
            busy[phases] = True
            slot_busy.append(busy)
            assign[key] = len(slot_busy) - 1
    return assign, len(slot_busy)


def _occupancy_peak(intervals, m: int) -> int:
    occ = np.zeros(m, np.int64)
    for _, s, ln in intervals:
        for k in range(ln):
            occ[(s + k) % m] += 1
    return int(occ.max())


def plan(num_chunks: int, num_stages: int, p2: Optional[int] = None,
         mbkr: bool = True) -> MBKRPlan:
    """Build the static cyclic slot plan (see ``repro.core.mbkr.plan``).

    Own chunk phi (phi < p2) lives at my phases [phi .. M-1]; a hosted pair
    chunk phi' (phi' >= p2) arrives at (phi' + N/2) mod M on a first-half
    host, (phi' - N/2) mod M on a second-half host, and lives M - phi'
    phases. Own intervals are colored first and shared by both halves."""
    m, n = num_chunks, num_stages
    n2 = max(n // 2, 1)
    if m < n2:  # the cross-half stagger needs >= N/2 chunks in flight
        mbkr = False
    if not mbkr or n < 2 or m < 2:
        own = np.arange(m, dtype=np.int32)
        return MBKRPlan(n, m, m, m, m, own, np.full(m, m, np.int32),
                        np.full(m, m, np.int32), peak=m)
    if p2 is None:
        p2, _ = best_p2(m, n)
    p2 = min(p2, m)
    if p2 >= m:
        own = np.arange(m, dtype=np.int32)
        return MBKRPlan(n, m, m, max(m - n2, 0), m, own,
                        np.full(m, m, np.int32), np.full(m, m, np.int32), peak=m)

    own_iv = [(("own", phi), phi, m - phi) for phi in range(p2)]
    host_a = [(("host", phip), (phip + n2) % m, m - phip) for phip in range(p2, m)]
    host_b = [(("host", phip), (phip - n2) % m, m - phip) for phip in range(p2, m)]

    assign_a, slots_a = _color(own_iv + host_a, m)
    # half B is re-colored with half A's own assignment pinned (one shared
    # own table for every stage)
    own_busy: Dict[int, np.ndarray] = {}
    for (key, s, ln) in own_iv:
        si = assign_a[key]
        own_busy.setdefault(si, np.zeros(m, bool))
        for k in range(ln):
            own_busy[si][(s + k) % m] = True
    slot_busy = [own_busy.get(i, np.zeros(m, bool)) for i in range(slots_a)]
    assign_b: Dict = {}
    for key, s, ln in sorted(host_b, key=lambda iv: (-iv[2], iv[1])):
        phases = [(s + k) % m for k in range(ln)]
        for si, busy in enumerate(slot_busy):
            if not busy[phases].any():
                busy[phases] = True
                assign_b[key] = si
                break
        else:
            busy = np.zeros(m, bool)
            busy[phases] = True
            slot_busy.append(busy)
            assign_b[key] = len(slot_busy) - 1
    num_slots = len(slot_busy)
    peak = max(_occupancy_peak(own_iv + host_a, m),
               _occupancy_peak(own_iv + host_b, m))

    own_slot = np.full(m, num_slots, np.int32)
    hs_a = np.full(m, num_slots, np.int32)
    hs_b = np.full(m, num_slots, np.int32)
    for phi in range(p2):
        own_slot[phi] = assign_a[("own", phi)]
    for phip in range(p2, m):
        hs_a[phip] = assign_a[("host", phip)]
        hs_b[phip] = assign_b[("host", phip)]
    return MBKRPlan(n, m, p2, max(p2 - n2, 0), num_slots, own_slot, hs_a, hs_b,
                    peak=peak)


def verify_plan(pl: MBKRPlan, periods: int = 4) -> None:
    """Step the steady-state back-to-back schedule on a (stage, pair)
    couple; assert that pool writes never clobber live entries and that
    attention always finds every chunk it needs. Raises AssertionError."""
    m, n2 = pl.num_chunks, pl.num_stages // 2
    if pl.p2 >= m:
        return
    pools: Dict[int, Dict[int, tuple]] = {0: {}, 1: {}}
    stage_of = {0: 0, 1: n2}
    host_table = {0: pl.host_slot_a, 1: pl.host_slot_b}

    def phase(me: int, t: int) -> Tuple[int, int]:
        tt = t - stage_of[me]
        return tt % m, tt // m

    for t in range(n2, periods * m + n2):
        for me in (0, 1):
            phi, req = phase(me, t)
            if req < 0:
                continue
            other = 1 - me
            if phi < pl.p2:
                slot = int(pl.own_slot[phi])
                prev = pools[me].get(slot)
                assert prev is None or prev[4] < t, ("own write clobbers", t, me, phi, prev)
                pools[me][slot] = ("own", me, req, phi, t + (m - 1 - phi))
            else:
                slot = int(host_table[other][phi])
                prev = pools[other].get(slot)
                assert prev is None or prev[4] < t, ("host write clobbers", t, me, phi, prev)
                pools[other][slot] = ("host", me, req, phi, t + (m - 1 - phi))
        for me in (0, 1):
            phi, req = phase(me, t)
            if req < 1:
                continue
            other = 1 - me
            for j in range(phi + 1):
                if j < pl.p2:
                    e = pools[me].get(int(pl.own_slot[j]))
                    assert e and e[:4] == ("own", me, req, j), ("miss own", t, me, j, e)
                else:
                    e = pools[other].get(int(host_table[other][j]))
                    assert e and e[:4] == ("host", me, req, j), ("miss host", t, me, j, e)
