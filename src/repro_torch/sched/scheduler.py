"""Continuous chunk-level scheduler: cross-request pipelining.

MOCAP's engine fills and drains the pipeline once per request (or per
bucket-batch), so at serving scale the N-1-tick fill/drain bubble is paid on
every request boundary. This scheduler admits a stream of TIMESTAMPED
requests and injects the next request's chunk 0 into stage 0 the moment the
previous request's tail chunk vacates it, keeping the pipeline bubble-free
across request boundaries (chunk-granular multiplexing, cf. chunked-prefill
continuous batching and token-grained pipelining).

Mechanics:
- each request carries a per-bucket LBCP chunk plan (``ChunkPlan``: chunk
  sizes + analytic per-chunk cost vectors from ``core.costmodel``);
- stages are in-order, non-preemptive FIFOs; one admitted request's full
  chunk schedule is appended to the per-stage frontier via the shared
  list-scheduling core ``sim.engine.schedule_request``. MBKR spill/fetch
  costs are carried per chunk, and the creditor's serve obligation is folded
  in with the lockstep phase approximation (0.5 x the pair phase's
  spill+fetch, as in the simulator's tick model) rather than the event
  simulator's exact serve-due bookkeeping — schedules are the same
  list-scheduling recurrence but can be slightly optimistic about
  cross-pair serve contention;
- ADMISSION is policy-ordered (FCFS / SJF / EDF, pluggable) and gated by the
  ``KVLeaseManager``: a request is deferred while its projected KV lease
  would push any stage's occupancy over the MBKR slot budget, and rejected
  only if it cannot fit an empty pool;
- TTFT/queueing/SLO metrics (``SchedMetrics``) and a Chrome-format JSON
  trace (``TraceRecorder``) are produced for offline analysis;
- a radix prefix index (``kvstore.prefix.PrefixPageCache``, optional): a
  request whose leading chunks are resident leases only its novel suffix
  and is priced against the shorter effective sequence.

The port's own copy of ``repro.sched.scheduler``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import costmodel as cm
from repro_torch.core import mbkr as mb
from repro_torch.sched.kvlease import KVLeaseManager, request_lease_events
from repro_torch.sched.metrics import RequestRecord, SchedMetrics
from repro_torch.sched.trace import TraceRecorder
from repro_torch.sim.engine import schedule_request


@dataclass(frozen=True)
class ChunkPlan:
    """Per-bucket chunk plan + analytic cost vectors (all ``[M]``)."""
    bucket: int
    chunks: Tuple[int, ...]
    dur: np.ndarray
    comm: np.ndarray
    kvb: np.ndarray
    spill_t: np.ndarray
    fetch_t: np.ndarray
    serve_t: np.ndarray       # creditor serve approximation (lockstep phase)
    p2: int

    @property
    def task_cost(self) -> np.ndarray:
        return self.dur + self.spill_t + self.fetch_t + self.serve_t

    @property
    def work(self) -> float:
        """Total stage-seconds of one request — the SJF size key."""
        return float(self.task_cost.sum())

    @staticmethod
    def build(bucket: int, chunks: Sequence[int], sm: cm.StageModel,
              hw: cm.ProfileSpec, *, mbkr_plan: Optional[mb.MBKRPlan] = None,
              compress: float = 1.0, prefix_hit_chunks: int = 0
              ) -> "ChunkPlan":
        dur, comm, kvb, spill_t, fetch_t = cm.chunk_cost_arrays(
            sm, chunks, hw, mbkr_plan=mbkr_plan, compress=compress,
            prefix_hit_chunks=prefix_hit_chunks)
        m = len(chunks)
        p2 = m if mbkr_plan is None else mbkr_plan.p2
        # creditor serve time: while my pair (N/2 phases away) spills/fetches,
        # my HBM+link serve half the transfer — the simulator's lockstep
        # approximation folded into the chunk occupying that phase
        serve_t = np.zeros(m)
        if p2 < m:
            n2 = mbkr_plan.num_stages // 2
            for i in range(m):
                pp = (i + m - n2) % m
                serve_t[i] = 0.5 * (spill_t[pp] + fetch_t[pp])
        return ChunkPlan(bucket, tuple(int(c) for c in chunks), dur, comm,
                         kvb, spill_t, fetch_t, serve_t, p2)


@dataclass
class SchedRequest:
    rid: int
    arrival: float
    seq_len: int
    bucket: int = 0
    deadline: float = math.inf      # absolute; inf = no SLO
    state: str = "pending"          # pending | done | rejected
    admit_time: float = math.inf
    finish_time: float = math.inf
    payload: object = None          # opaque engine-side handle (e.g. Request)
    # chained chunk-content hashes (kvstore.prefix.chunk_hashes): the radix
    # index key for cross-request prefix KV reuse; () = never shared
    prefix_hashes: Tuple[int, ...] = ()


# -------------------------------------------------------------- policies

def _fcfs_key(r: SchedRequest, plan: ChunkPlan) -> Tuple:
    return (r.arrival, r.rid)


def _sjf_key(r: SchedRequest, plan: ChunkPlan) -> Tuple:
    return (plan.work, r.arrival, r.rid)


def _edf_key(r: SchedRequest, plan: ChunkPlan) -> Tuple:
    return (r.deadline, r.arrival, r.rid)


POLICIES: Dict[str, Callable[[SchedRequest, ChunkPlan], Tuple]] = {
    "fcfs": _fcfs_key,
    "sjf": _sjf_key,
    "edf": _edf_key,
}


def poisson_arrivals(rate: float, n: int, seed: int = 0,
                     start: float = 0.0) -> List[float]:
    """Open-loop Poisson arrival timestamps: ``n`` i.i.d. exponential gaps at
    ``rate`` req/s. ``rate <= 0`` degenerates to a closed-loop burst at
    ``start`` (everything arrives at once)."""
    if rate <= 0:
        return [start] * n
    rng = np.random.default_rng(seed)
    return list(start + np.cumsum(rng.exponential(1.0 / rate, size=n)))


# -------------------------------------------------------------- scheduler

class ChunkScheduler:
    def __init__(
        self,
        num_stages: int,
        plan_for: Callable[[int], ChunkPlan],
        *,
        policy: str = "fcfs",
        lease: Optional[KVLeaseManager] = None,
        trace: Optional[TraceRecorder] = None,
        compress: float = 1.0,
        kv_compress: float = 1.0,
        stage_scale: Optional[Sequence[float]] = None,
        page_tokens: int = 0,
        prefix_cache: Optional[object] = None,   # kvstore.prefix.PrefixPageCache
        prefix_min_pages: int = 1,
        plan_for_prefix: Optional[Callable[[int, int], ChunkPlan]] = None,
    ):
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; "
                             f"choose from {sorted(POLICIES)}")
        self.num_stages = num_stages
        self.plan_for = plan_for
        self.policy = policy
        self._key = POLICIES[policy]
        self.lease = lease
        self.trace = trace or TraceRecorder(enabled=False)
        self.compress = compress
        # stored-bytes factor of the KV page codec (kvstore.quant): leases
        # count QUANTIZED bytes, so a one-byte kv_dtype admits ~2x the
        # concurrency against the same physical budget
        self.kv_compress = kv_compress
        # page size for PAGE-GRANULAR lease events (kvlease.chunk_page_
        # bytes): a request leases only the pages its seq_len touches, so
        # bucket-tail padding stops reserving phantom bytes; 0 = one page
        # per chunk (chunks beyond seq_len still lease nothing)
        self.page_tokens = page_tokens
        self.stage_scale = (np.asarray(stage_scale, float)
                            if stage_scale is not None else None)
        # radix prefix index (kvstore.prefix): requests whose leading chunks
        # are resident lease only their novel suffix and are priced against
        # the shorter effective sequence via plan_for_prefix(bucket, k)
        self.prefix_cache = prefix_cache
        self.prefix_min_pages = prefix_min_pages
        self.plan_for_prefix = plan_for_prefix
        self._prefix_leases: Dict[int, object] = {}
        self.pair = [mb.pair_of(s, num_stages) for s in range(num_stages)]
        self.stage_free = np.zeros(num_stages)
        self.requests: List[SchedRequest] = []
        self.admitted: List[SchedRequest] = []   # in admission order
        self.metrics = SchedMetrics(num_stages)

    # ------------------------------------------------------------- intake
    def submit(self, req: SchedRequest) -> None:
        self.requests.append(req)
        self.trace.mark(req.rid, "arrival", req.arrival)

    def rebase_costs(self, plan_for: Callable[[int], ChunkPlan]) -> None:
        """Swap the admission cost source — e.g. nominal -> a calibrated
        profile. Already-admitted requests, the per-stage busy frontier,
        and live KV leases are untouched; only FUTURE candidates are
        policy-keyed and scheduled with the new cost vectors, so a
        mid-stream recalibration never reorders history."""
        self.plan_for = plan_for

    # ------------------------------------------------------------- prefix
    def _prefix_hit(self, plan: ChunkPlan, prefix_hashes: Sequence[int],
                    seq_len: int) -> int:
        """Clamped hit length, in chunks: what the radix index serves of
        this request.  Clamps: only chunks fully inside ``seq_len`` can be
        shared, the tail chunk always runs (it produces the logits), hit
        chunks never exceed ``p2`` (spilled chunks are pair-hosted, not
        index-addressed), and hits below ``prefix_min_pages`` are ignored
        (tiny prefixes aren't worth the indexing churn)."""
        if self.prefix_cache is None or not prefix_hashes:
            return 0
        k = self.prefix_cache.match(prefix_hashes)
        covered, start = 0, 0
        for c in plan.chunks:
            if start + int(c) > seq_len:
                break
            covered += 1
            start += int(c)
        k = min(k, covered, plan.p2, len(plan.chunks) - 1)
        if k * self.prefix_cache.pages_per_chunk < self.prefix_min_pages:
            return 0
        return k

    def _effective(self, bucket: int, plan: ChunkPlan, k: int
                   ) -> Tuple[ChunkPlan, Optional[List[int]]]:
        """The plan + per-chunk shared-page vector a hit of ``k`` chunks is
        priced with: zero compute/wire rows for served chunks, zero lease
        bytes for their pages."""
        if k <= 0:
            return plan, None
        if self.plan_for_prefix is not None:
            plan = self.plan_for_prefix(bucket, k)
        ppc = self.prefix_cache.pages_per_chunk
        shared = [ppc] * k + [0] * (len(plan.chunks) - k)
        return plan, shared

    def _prune_prefix(self) -> None:
        """Release radix references of requests whose KV lease was pruned
        (drained): their shared pages drop to the cache's LRU pool."""
        if self.prefix_cache is None or not self._prefix_leases:
            return
        live = set(self.lease.leases) if self.lease is not None else set()
        for rid in [r for r in self._prefix_leases if r not in live]:
            self.prefix_cache.release(self._prefix_leases.pop(rid))

    def prefix_stats(self) -> Dict:
        return (dict(self.prefix_cache.stats())
                if self.prefix_cache is not None else {})

    # ------------------------------------------------------------ preview
    def preview(self, bucket: int, seq_len: int,
                release: float = 0.0,
                prefix_hashes: Sequence[int] = ()) -> Tuple[float, bool]:
        """Placement signal (for the reference's ``repro.fleet`` router):
        the finish time a request of
        ``seq_len`` in ``bucket`` WOULD get if admitted against the current
        per-stage frontier, plus whether its KV lease fits the committed
        timeline right now. Pure — no scheduler state is mutated. When the
        lease does not fit, the ETA is padded by the wait until the next
        committed release (the earliest instant a deferred admission could
        retry), so a lease-packed "hot" cell quotes an honestly later finish
        than an idle "cold" one; a request that can NEVER fit (empty pool
        and still refused) quotes ``inf``.

        ``prefix_hashes`` folds the radix index into the quote: a resident
        prefix prices the shorter effective sequence AND a suffix-only
        lease, so a cell already holding the prefix quotes an earlier ETA
        (the fleet's prefix-affinity signal)."""
        plan = self.plan_for(bucket)
        k = self._prefix_hit(plan, prefix_hashes, seq_len)
        plan, shared = self._effective(bucket, plan, k)
        frontier = self.stage_free.copy()
        finish = schedule_request(plan.task_cost, plan.comm, self.num_stages,
                                  frontier, release=release,
                                  stage_scale=self.stage_scale)
        eta = float(finish[-1][-1])
        fits = True
        if self.lease is not None:
            lease = request_lease_events(-1, finish, plan.kvb, plan.p2,
                                         self.pair, self.compress,
                                         self.kv_compress, seq_len=seq_len,
                                         chunks=plan.chunks,
                                         page_tokens=self.page_tokens,
                                         shared_pages=shared)
            fits = self.lease.would_fit(lease)
            if not fits:
                t_now = max(float(self.stage_free[0]), release)
                nxt = self.lease.next_release(t_now)
                eta = (eta + max(nxt - t_now, 0.0) if math.isfinite(nxt)
                       else math.inf)
        return eta, fits

    # ------------------------------------------------------------ running
    def _try_admit(self, r: SchedRequest, release: float) -> bool:
        """Tentatively schedule ``r`` from ``release``; commit if its KV
        lease fits every stage budget. Mutates scheduler state on success."""
        plan = self.plan_for(r.bucket)
        k = self._prefix_hit(plan, r.prefix_hashes, r.seq_len)
        plan, shared = self._effective(r.bucket, plan, k)
        frontier = self.stage_free.copy()
        finish = schedule_request(plan.task_cost, plan.comm, self.num_stages,
                                  frontier, release=release,
                                  stage_scale=self.stage_scale)
        if self.lease is not None:
            lease = request_lease_events(r.rid, finish, plan.kvb, plan.p2,
                                         self.pair, self.compress,
                                         self.kv_compress,
                                         seq_len=r.seq_len,
                                         chunks=plan.chunks,
                                         page_tokens=self.page_tokens,
                                         shared_pages=shared)
            if not self.lease.admit(lease):
                return False
        # commit: reference the hit prefix + index the novel suffix
        if self.prefix_cache is not None and r.prefix_hashes:
            self._prefix_leases[r.rid] = self.prefix_cache.acquire(
                r.rid, r.prefix_hashes)
        # commit: replay for the hooks (busy accounting + trace)
        self.stage_free = frontier
        m = len(plan.chunks)
        for i in range(m):
            for s in range(self.num_stages):
                tf = finish[i][s]
                d = plan.task_cost[i] * (self.stage_scale[s]
                                         if self.stage_scale is not None else 1.0)
                self.metrics.observe_busy(s, float(d))
                self.trace.task(r.rid, i, s, float(tf - d), float(tf))
        d0 = plan.task_cost[0] * (self.stage_scale[0]
                                  if self.stage_scale is not None else 1.0)
        r.state = "done"
        r.admit_time = float(finish[0][0] - d0)   # chunk-0 start at stage 0
        r.finish_time = float(finish[m - 1][self.num_stages - 1])
        self.admitted.append(r)
        self.trace.mark(r.rid, "admit", r.admit_time)
        self.trace.mark(r.rid, "finish", r.finish_time)
        self.metrics.observe(RequestRecord(
            rid=r.rid, arrival=r.arrival, seq_len=r.seq_len, bucket=r.bucket,
            admit=r.admit_time, finish=r.finish_time, deadline=r.deadline))
        return True

    def _reject(self, r: SchedRequest, now: float) -> None:
        r.state = "rejected"
        self.trace.mark(r.rid, "reject", now)
        self.metrics.observe(RequestRecord(
            rid=r.rid, arrival=r.arrival, seq_len=r.seq_len, bucket=r.bucket,
            deadline=r.deadline, rejected=True))

    def run(self) -> List[SchedRequest]:
        """Drain all submitted requests; returns them in admission order.

        Event loop: whenever stage 0 can accept a new head chunk, pick the
        policy-preferred request among those that have ARRIVED by then; a
        request whose KV lease does not fit is passed over (the next
        candidate is tried) and retried at the next lease release or
        arrival — it is rejected only if it cannot fit an empty pool.
        """
        pending = [r for r in self.requests if r.state == "pending"]
        guard = 0
        while pending:
            guard += 1
            if guard > 100_000:
                raise RuntimeError("scheduler event loop did not converge")
            t_now = max(float(self.stage_free[0]),
                        min(r.arrival for r in pending))
            arrived = [r for r in pending if r.arrival <= t_now]
            arrived.sort(key=lambda r: self._key(r, self.plan_for(r.bucket)))
            admitted_one = False
            for r in arrived:
                if self._try_admit(r, t_now):
                    pending.remove(r)
                    admitted_one = True
                    break
            if admitted_one:
                if self.lease is not None:
                    self.lease.prune(before=t_now)
                self._prune_prefix()
                continue
            # every arrived candidate was lease-refused: wait for the next
            # release or arrival; reject candidates that can never fit
            future = [r.arrival for r in pending if r.arrival > t_now]
            t_retry = min(future) if future else math.inf
            if self.lease is not None:
                t_retry = min(t_retry, self.lease.next_release(t_now))
                if not self.lease.leases:
                    for r in arrived:          # empty pool and still refused
                        self._reject(r, t_now)
                        pending.remove(r)
                    continue
            if math.isinf(t_retry):
                for r in arrived:
                    self._reject(r, t_now)
                    pending.remove(r)
                continue
            # advance the head frontier so the next candidate set is drawn
            # at the retry instant
            self.stage_free[0] = max(self.stage_free[0], t_retry)
        return self.admitted

    # ------------------------------------------------------------ results
    def summary(self) -> Dict:
        out = self.metrics.summary()
        out["policy"] = self.policy
        if self.lease is not None:
            out["lease_refusals"] = self.lease.refusals
            out["lease_hwm_frac"] = float(
                (self.lease.hwm / np.maximum(self.lease.budget, 1e-12)).max())
        out.update(self.prefix_stats())
        return out
