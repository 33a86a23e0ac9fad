"""Hot / warm / cold KV page tiers with analytic prefetch (mirrors
``repro.kvstore.tiers``; the planning half is copied exactly).

MOCAP's pool-scan re-reads every resident prefix chunk at every tick, so a
page can only leave stage-local device memory if the byte stream that
brings it back fits under the tick it is due in. Three tiers:

- HOT   stage-local pages (own slots below the MBKR spill threshold);
- WARM  MBKR pair-hosted pages (chunks >= p2 — the slot plan already moves
        these off-stage; they are re-read over the stage transport by
        fetch/qship, so they never count against the local budget);
- COLD  host-offloaded pages staged back to the card. Placement is chosen
        so every cold page's host-to-device stream lands BEFORE the
        pool-scan tick that reads it, using the LBCP chunk plan's per-tick
        compute times as the overlap window.

``plan_tiers`` is analytic (same fidelity as ``core.costmodel``): it
classifies pages, emits the prefetch schedule, and reports feasibility
against a link rate the caller states. ``HostOffloadStager`` does the real
staging at wave granularity: torch copies between the card and pinned host
memory.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import device as devices
from repro_torch.kvstore import quant as Q
from repro_torch.kvstore.pages import PageGeometry

HOT, WARM, COLD = 0, 1, 2
TIER_NAMES = ("hot", "warm", "cold")


@dataclass(frozen=True)
class TierSpec:
    """Per-stage byte budgets. ``cold_bw`` is the host<->device staging
    bandwidth (bytes/s); 0 disables the cold tier."""
    hot_bytes: float
    warm_bytes: float = math.inf   # pair-side hosting is the pair's problem
    cold_bw: float = 0.0


@dataclass(frozen=True)
class PrefetchOp:
    """One chunk's cold pages must be on-device before ``due_tick``'s pool
    scan; the H2D stream is issued under the previous tick's compute."""
    chunk: int
    pages: Tuple[int, ...]
    due_tick: int
    issue_tick: int
    nbytes: float


@dataclass
class TierPlan:
    tier_of: np.ndarray            # [num_pages] int8 (HOT/WARM/COLD)
    prefetch: List[PrefetchOp]
    feasible: bool                 # every prefetch fits its overlap window
    hot_bytes: float
    warm_bytes: float
    cold_bytes: float
    worst_tick_bw: float           # peak H2D demand (bytes/s) over ticks

    def summary(self) -> Dict[str, float]:
        counts = {TIER_NAMES[t]: int((self.tier_of == t).sum())
                  for t in (HOT, WARM, COLD)}
        return {"pages": counts, "hot_bytes": self.hot_bytes,
                "warm_bytes": self.warm_bytes, "cold_bytes": self.cold_bytes,
                "prefetch_ops": len(self.prefetch),
                "worst_tick_bw": self.worst_tick_bw,
                "feasible": self.feasible}


def chunk_page_bytes(geom: PageGeometry, codec: Q.KVCodec, lps: int, b: int,
                     kvh: int, hd: int) -> float:
    """Stored bytes of ONE chunk's pages (k + v + scales)."""
    payload = 2.0 * lps * b * geom.chunk_len * kvh * hd * codec.bytes_per_el
    scales = 2.0 * geom.pages_per_chunk * codec.scale_bytes_per_page(
        lps, b, kvh)
    return payload + scales


def plan_tiers(geom: PageGeometry, codec: Q.KVCodec, slot_pages: np.ndarray,
               own_slot: np.ndarray, p2: int, num_chunks: int,
               spec: TierSpec, *, lps: int, b: int, kvh: int, hd: int,
               tick_s: Optional[Sequence[float]] = None,
               host_slots: Optional[Sequence[int]] = None) -> TierPlan:
    """Place every page of one stage's pool into a tier.

    ``own_slot``/``p2`` come from the MBKR plan: chunks < p2 are stage-local
    candidates (HOT, overflowing to COLD), chunks >= p2 are pair-hosted
    (WARM — symmetrically, THIS stage's host slots, passed as
    ``host_slots``, hold the pair's spill and are marked WARM locally).
    ``tick_s`` is the per-phase compute time vector (LBCP ``ChunkPlan.dur``);
    uniform 1s ticks when absent — feasibility then means "fits at 1
    chunk-compute-second of overlap per tick".

    Cold candidates are chosen LAST-written-first: chunk j's pages are
    re-read on ticks j+1..M-1, so the latest chunks cost the fewest
    re-streams and have the shortest residency.
    """
    m = num_chunks
    ticks = np.asarray(tick_s if tick_s is not None else np.ones(m), float)
    cb = chunk_page_bytes(geom, codec, lps, b, kvh, hd)
    tier_of = np.full(geom.num_pages, HOT, np.int8)

    # chunks >= p2 are hosted at the pair under ITS page table; my own host
    # slots hold the pair's spill — the local face of the WARM tier
    warm_bytes = max(m - p2, 0) * cb
    if host_slots is not None:
        for s in np.unique(np.asarray(host_slots, np.int64)):
            tier_of[slot_pages[int(s)]] = WARM
    # scratch pages are write-garbage targets; they never hold live bytes
    own_chunks = list(range(min(p2, m)))
    hot_used = 0.0
    cold_chunks: List[int] = []
    for j in own_chunks:                       # earliest = most re-read = hot
        if hot_used + cb <= spec.hot_bytes or spec.cold_bw <= 0:
            hot_used += cb
        else:
            cold_chunks.append(j)
    # keep the overflow choice "latest first": re-assign so the LAST chunks
    # go cold regardless of which iteration overflowed. Slots that ALSO do
    # host duty at other phases (the coloring shares the pool) must stay
    # on-device — their pages carry the pair's spill mid-cycle.
    host_set = (set(int(s) for s in np.asarray(host_slots).ravel())
                if host_slots is not None else set())
    eligible = [j for j in own_chunks if int(own_slot[j]) not in host_set]
    n_cold = min(len(cold_chunks), len(eligible))
    cold_chunks = eligible[len(eligible) - n_cold:] if n_cold else []
    for j in cold_chunks:
        s = int(own_slot[j])
        tier_of[slot_pages[s]] = COLD

    # prefetch schedule: chunk j's cold pages are due at every tick t > j,
    # streamed under tick t-1's compute (issue_tick) — so the bandwidth
    # check divides tick t's demand by the issue window ticks[t-1]
    prefetch: List[PrefetchOp] = []
    demand = np.zeros(m)
    for t in range(1, m):
        for j in cold_chunks:
            if j < t:
                s = int(own_slot[j])
                prefetch.append(PrefetchOp(
                    chunk=j, pages=tuple(int(x) for x in slot_pages[s]),
                    due_tick=t, issue_tick=t - 1, nbytes=cb))
                demand[t] += cb
    window = np.concatenate([[np.inf], ticks[:-1]]) if m else ticks
    bw_need = demand / np.maximum(window, 1e-12)
    worst = float(bw_need.max()) if m else 0.0
    feasible = (not cold_chunks) or (spec.cold_bw > 0
                                     and worst <= spec.cold_bw * (1 + 1e-9))
    return TierPlan(tier_of, prefetch, feasible,
                    hot_bytes=hot_used, warm_bytes=warm_bytes,
                    cold_bytes=len(cold_chunks) * cb, worst_tick_bw=worst)


def max_seq_len_for_budget(budget_bytes: float, *, kv_token_bytes: float,
                           num_chunks: int, num_stages: int,
                           codec: Q.KVCodec, model_dtype: str = "bfloat16",
                           page_tokens: int = 0, head_dim: int = 0,
                           mbkr: bool = True) -> int:
    """Max feasible sequence length whose per-stage paged pool fits
    ``budget_bytes``. ``kv_token_bytes`` is one stage's KV bytes per token
    in the MODEL dtype (``cm.kv_chunk_bytes(sm, 1)``); the codec's
    compression factor (incl. scale overhead) rescales it. MBKR shrinks the
    pool from M chunk-slots to ``plan(M, N).num_slots`` — the two levers
    (slot orchestration x byte compression) multiply."""
    from repro_torch.core import mbkr as mb
    m = num_chunks
    slots = mb.plan(m, num_stages, mbkr=mbkr).num_slots if mbkr else m
    factor = Q.kv_compress_factor(codec, model_dtype=model_dtype,
                                  page_tokens=page_tokens, head_dim=head_dim)
    per_chunk_token = kv_token_bytes * factor
    if per_chunk_token <= 0:
        return 0
    chunk_tokens = int(budget_bytes // (slots * per_chunk_token))
    if page_tokens > 1:
        chunk_tokens -= chunk_tokens % page_tokens
    return chunk_tokens * m


# ------------------------------------------------------------- cold staging

class HostOffloadStager:
    """Real cold-tier staging: page slices of a pool tensor (page axis
    first) move between ``device`` (default the card) and host memory with
    torch copies — pinned host memory when ``device`` is the card.
    Wave-granular (between pipeline calls): the in-pipeline per-tick stream
    is the analytic plan above; this object is what the serving path uses
    to park drained pools off the device.

    Unlike the reference's functional ``.at[].set``, ``offload`` and
    ``restore`` update the pool tensor in place (and return it). A tensor
    on another device than the stager's raises: nothing falls back to the
    CPU."""

    def __init__(self, device=None):
        self.device = devices.resolve(device)
        self._store: Dict[Tuple[str, int], Tuple[torch.Tensor, torch.Tensor]] = {}

    def _ids(self, pages_array: torch.Tensor, page_ids) -> torch.Tensor:
        dev = pages_array.device
        if dev.type != self.device.type or self.device.index not in (None, dev.index):
            raise ValueError(f"pages on {dev}, stager on {self.device}")
        return torch.as_tensor(np.asarray(page_ids, np.int64),
                               device=pages_array.device)

    def offload(self, name: str, pages_array: torch.Tensor, page_ids: Sequence[int]):
        """Copy the given pages to host memory and zero them on the device.
        Returns the pool tensor with the offloaded pages cleared."""
        ids = self._ids(pages_array, page_ids)
        raw = Q.as_bytes(pages_array)
        picked = raw.index_select(0, ids)
        host = torch.empty(picked.shape, dtype=picked.dtype,
                           pin_memory=self.device.type == "cuda")
        host.copy_(picked, non_blocking=True)
        if self.device.type == "cuda":
            torch.cuda.synchronize(pages_array.device)
        self._store[(name, 0)] = (ids, host)
        raw.index_fill_(0, ids, 0)
        return pages_array

    def restore(self, name: str, pages_array: torch.Tensor):
        """Stage the offloaded pages back into the pool tensor."""
        ids, host = self._store.pop((name, 0))
        back = host.to(pages_array.device, non_blocking=True)
        Q.as_bytes(pages_array).index_copy_(0, ids, back)
        return pages_array

    def host_bytes(self) -> float:
        return float(sum(h.numel() * h.element_size()
                         for _, h in self._store.values()))
