"""Event-driven wafer-scale-chip pipeline simulator (paper §5: custom
event-driven simulator; we rebuild it on the shared analytic cost model in
``core.costmodel`` so LBCP's EvaluatePrefill and the simulator agree).

Three schedulers:

- ``gpipe``    microbatch pipeline (Fig. 2(a)): one task per (request, stage),
               full-sequence compute; KV retained until the request exits the
               pipeline (the standard-engine baseline — this is what OOMs
               first, the red crosses of Fig. 6(a)).
- ``terapipe`` chunked pipeline, uniform chunks, no reallocation: per-stage
               KV peaks at M chunks (one full request per stage).
- ``mocap``    chunked pipeline + MBKR spill/fetch/serve traffic + optional
               LBCP partitioning; per-stage KV peaks at the slot-plan's
               ``peak`` (< M), extending the feasible sequence length.

Memory is tracked as timestamped alloc/free events; feasibility = peak
occupancy <= per-stage capacity (weights subtracted). The makespan machinery
is a deterministic list-scheduling pass over task dependency + stage/link
FIFOs — faithful to the paper's in-order chunk execution.
"""
from __future__ import annotations

import math
from bisect import insort
from dataclasses import dataclass, replace
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core import costmodel as cm
from repro_torch.core import lbcp
from repro_torch.core import mbkr


@dataclass(frozen=True)
class SimConfig:
    scheduler: str                 # gpipe | terapipe | mocap
    model: ModelConfig
    hw: cm.HardwareProfile = cm.WSC_PAPER
    num_stages: int = 16
    num_chunks: int = 16
    batch: int = 8                 # closed-loop back-to-back requests
    seq_len: int = 65536
    partition: str = "uniform"     # uniform | lbcp   (mocap only)
    mbkr: bool = True              # mocap only
    compress: float = 1.0          # spill-byte multiplier (int8 -> 0.5)
    sa_iters: int = 120            # LBCP refinement budget
    # lockstep  = tick-synchronous stages (the paper's Fig. 5 analysis and our
    #             SPMD executable pipeline — barrier per chunk tick)
    # eventdriven = free-running stages (MIMD WSC dies). KEY FINDING: with
    #             uniform chunks the steady-state stage offset is
    #             max_i(dur_i)+comm, which COLLAPSES the cross-half phase
    #             stagger MBKR needs — LBCP's balancing is what restores it.
    execution: str = "lockstep"


@dataclass
class SimResult:
    feasible: bool
    makespan: float = math.inf
    e2e_latency: float = math.inf   # avg request arrival->completion (s)
    throughput: float = 0.0         # req/s
    peak_mem: float = 0.0           # bytes, worst stage (KV only)
    capacity: float = 0.0           # bytes available for KV per stage
    stage_busy: Optional[np.ndarray] = None
    link_bytes: float = 0.0         # total reallocation traffic
    chunks: Optional[List[int]] = None
    detail: str = ""


# ------------------------------------------------------------- memory track

class _MemTrack:
    """Per-stage timestamped alloc/free; post-hoc peak."""

    def __init__(self, num_stages: int):
        self.events: List[List[Tuple[float, float]]] = [[] for _ in range(num_stages)]

    def alloc(self, stage: int, t: float, nbytes: float):
        self.events[stage].append((t, nbytes))

    def free(self, stage: int, t: float, nbytes: float):
        self.events[stage].append((t, -nbytes))

    def peaks(self) -> np.ndarray:
        out = np.zeros(len(self.events))
        for s, ev in enumerate(self.events):
            ev.sort(key=lambda e: (e[0], e[1]))  # frees before allocs at ties
            cur = peak = 0.0
            for _, d in ev:
                cur += d
                peak = max(peak, cur)
            out[s] = peak
        return out


# ---------------------------------------------------------- list scheduling

def schedule_request(
    task_cost: Sequence[float],
    comm: Sequence[float],
    num_stages: int,
    stage_free: np.ndarray,
    *,
    release: float = 0.0,
    stage_scale: Optional[Sequence[float]] = None,
    extra_of=None,
    on_task=None,
) -> np.ndarray:
    """Deterministic list-scheduling core: append ONE request's in-order chunk
    tasks to free-running per-stage FIFOs.

    Chunk i at stage s starts at max(stage s free, chunk i done at stage s-1
    plus the boundary transfer, chunk i-1 done at stage s, and ``release`` for
    the head task (0, 0) — the request's tokens are not available earlier).

    ``stage_free`` is MUTATED: calling this back-to-back for a stream of
    requests yields the continuously-pipelined (bubble-free across request
    boundaries) schedule; this is the shared core under the event-driven
    simulator branch, ``SimExecutor``, and ``sched.ChunkScheduler``.

    Optional hooks: ``stage_scale[s]`` multiplies stage s's task durations
    (straggler modeling); ``extra_of(s, t0)`` returns extra busy seconds due
    before the task (MBKR creditor serve obligations); ``on_task(i, s, t0,
    tf)`` observes each scheduled task (memory/traffic accounting, tracing).

    Returns ``finish[M][N]`` task completion times.
    """
    m = len(task_cost)
    finish = np.zeros((m, num_stages))
    for i in range(m):
        for s in range(num_stages):
            ready = release if (i == 0 and s == 0) else 0.0
            if s:
                ready = max(ready, finish[i][s - 1] + comm[i])
            if i:
                ready = max(ready, finish[i - 1][s])
            t0 = max(ready, float(stage_free[s]))
            extra = extra_of(s, t0) if extra_of is not None else 0.0
            d = float(task_cost[i]) + extra
            if stage_scale is not None:
                d *= float(stage_scale[s])
            tf = t0 + d
            finish[i][s] = tf
            stage_free[s] = tf
            if on_task is not None:
                on_task(i, s, t0, tf)
    return finish


# ------------------------------------------------------------------ engine

def _kv_capacity(cfg: ModelConfig, hw: cm.HardwareProfile, num_stages: int,
                 tp: int) -> float:
    weights = cfg.param_count() * 2 / (num_stages * tp)
    return max(hw.hbm_cap - weights, 0.0)


def simulate(sc: SimConfig) -> SimResult:
    cfg, hw = sc.model, sc.hw
    n = sc.num_stages
    tp = max(hw.num_dies // n, 1)
    sm = cm.StageModel.build(cfg, n, tp)
    cap = _kv_capacity(cfg, hw, n, tp) * tp  # stage = tp dies ganged
    if cap <= 0:
        return SimResult(False, detail="weights exceed HBM")

    if sc.scheduler == "gpipe":
        return _sim_gpipe(sc, sm, cap)
    return _sim_chunked(sc, sm, cap)


def _sim_gpipe(sc: SimConfig, sm: cm.StageModel, cap: float) -> SimResult:
    cfg, hw, n = sc.model, sc.hw, sc.num_stages
    s_len, b = sc.seq_len, sc.batch
    # one task per (request, stage): full-sequence compute
    dur = cm.chunk_compute_time(sm, s_len, 0, hw)
    comm = cm.boundary_comm_time(cfg, s_len, hw)
    kv = cm.kv_chunk_bytes(sm, s_len)          # stage KV of one request
    act = s_len * cfg.d_model * 2 * 2          # transient activations

    stage_free = np.zeros(n)
    finish = np.zeros((b, n))
    mem = _MemTrack(n)
    for r in range(b):
        for s in range(n):
            ready = finish[r][s - 1] + comm if s else (finish[r - 1][s] if r else 0.0)
            if s and r:
                ready = max(ready, finish[r - 1][s])
            t0 = max(ready, stage_free[s])
            finish[r][s] = t0 + dur
            stage_free[s] = finish[r][s]
            mem.alloc(s, t0, kv + act)
            mem.free(s, finish[r][s], act)     # activations are transient
    for r in range(b):
        for s in range(n):
            mem.free(s, finish[r][n - 1], kv)  # retained until request exits
    peaks = mem.peaks()
    mk = float(finish[-1][-1])
    e2e = float(np.mean(finish[:, -1]))
    feasible = bool(peaks.max() <= cap)
    return SimResult(feasible, mk, e2e, b / mk, float(peaks.max()), cap,
                     chunks=[s_len],
                     detail="" if feasible else
                     f"OOM: peak {peaks.max()/1e9:.1f} GB > cap {cap/1e9:.1f} GB")


def _sim_chunked(sc: SimConfig, sm: cm.StageModel, cap: float) -> SimResult:
    cfg, hw, n = sc.model, sc.hw, sc.num_stages
    m, b, s_len = sc.num_chunks, sc.batch, sc.seq_len
    is_mocap = sc.scheduler == "mocap"
    use_mbkr = is_mocap and sc.mbkr and not cfg.attn_free
    plan = mbkr.plan(m, n, mbkr=use_mbkr)
    p2 = plan.p2 if use_mbkr else m

    # ---- chunk partition
    if is_mocap and sc.partition == "lbcp":
        pp = lbcp.plan_partition(cfg, s_len, m, n, hw, tp=sm.tp,
                                 mbkr=use_mbkr, compress=sc.compress,
                                 sa_iters=sc.sa_iters, batch_cap=b)
        chunks = pp.chunks
    else:
        chunks = lbcp.uniform_partition(s_len, m)
    # ---- per-chunk costs (shared vectors; p2 == m when MBKR is off)
    dur, comm, kvb, spill_t, fetch_t = cm.chunk_cost_arrays(
        sm, chunks, hw, mbkr_plan=plan if use_mbkr else None,
        compress=sc.compress)

    mem = _MemTrack(n)
    link_bytes = 0.0
    pair = [mbkr.pair_of(s, n) for s in range(n)]
    finish = np.zeros((b, m, n))

    if sc.execution == "lockstep":
        # tick-synchronous: tick t runs (r, i) on stage s where
        # t = r*m + i + s; tick duration = max active task cost (+ transfer).
        n_ticks = b * m + n - 1
        serve = np.zeros(m)
        if p2 < m:
            for i in range(m):
                pp = (i + m - n // 2) % m  # pair's phase at my phase i
                serve[i] = 0.5 * (spill_t[pp] + fetch_t[pp])
        task_cost = dur + fetch_t + spill_t + serve
        now = 0.0
        for t in range(n_ticks):
            lo = max(0, t - (b * m - 1))
            hi = min(n - 1, t)
            phases = (t - np.arange(lo, hi + 1)) % m
            tick = float((task_cost[phases]).max() + comm[phases].max())
            t_end = now + tick
            for s in range(lo, hi + 1):
                gi = t - s
                r, i = gi // m, gi % m
                finish[r][i][s] = t_end
                if i >= p2:
                    link_bytes += kvb[i] * sc.compress
                if i > p2:
                    link_bytes += kvb[p2:i].sum() * sc.compress
                if i < p2:
                    mem.alloc(s, t_end, kvb[i])
                else:
                    mem.alloc(pair[s], t_end, kvb[i] * sc.compress)
                if i == m - 1:
                    mem.free(s, t_end, kvb[:p2].sum())
                    if p2 < m:
                        mem.free(pair[s], t_end, kvb[p2:].sum() * sc.compress)
            now = t_end
    else:
        stage_free = np.zeros(n)
        serve_due = [[] for _ in range(n)]  # (time, extra busy) on creditor
        task_cost = dur + fetch_t + spill_t
        acct = {"link": 0.0}

        def extra_of(s: int, t0: float) -> float:
            # creditor serve obligations accrued before this task
            extra = 0.0
            due = serve_due[s]
            while due and due[0][0] <= t0:
                extra += due.pop(0)[1]
            return extra

        def on_task(i: int, s: int, t0: float, tf: float) -> None:
            # memory: local store below p2, else spill to pair
            # (creditor memory is RESERVED at spill initiation)
            if i < p2:
                mem.alloc(s, tf, kvb[i])
            else:
                mem.alloc(pair[s], tf, kvb[i] * sc.compress)
                acct["link"] += kvb[i] * sc.compress
                insort(serve_due[pair[s]], (tf, spill_t[i] * 0.5))
            if fetch_t[i] > 0:
                acct["link"] += kvb[p2:i].sum() * sc.compress
                insort(serve_due[pair[s]], (t0, fetch_t[i] * 0.5))

        for r in range(b):
            finish[r] = schedule_request(task_cost, comm, n, stage_free,
                                         extra_of=extra_of, on_task=on_task)
            # request r's stage-KV frees once its LAST chunk clears stage s
            for s in range(n):
                t_done = finish[r][m - 1][s]
                mem.free(s, t_done, kvb[:p2].sum())
                if p2 < m:
                    mem.free(pair[s], t_done, kvb[p2:].sum() * sc.compress)
        link_bytes = acct["link"]

    peaks = mem.peaks()
    mk = float(finish[-1][-1][-1])
    e2e = float(np.mean(finish[:, m - 1, n - 1]))
    feasible = bool(peaks.max() <= cap)
    busy = np.zeros(n)
    for s in range(n):
        busy[s] = dur.sum() * b / mk
    return SimResult(feasible, mk, e2e, b / mk, float(peaks.max()), cap,
                     stage_busy=busy, link_bytes=link_bytes, chunks=list(chunks),
                     detail="" if feasible else
                     f"OOM: peak {peaks.max()/1e9:.1f} GB > cap {cap/1e9:.1f} GB")


# -------------------------------------------------------------- max seq len

def max_seq_len(sc: SimConfig, *, lo: int = 4096, hi: int = 16 << 20,
                quantum: int = 4096) -> int:
    """Largest feasible sequence length (bisection over the simulator)."""

    def ok(s_len: int) -> bool:
        if s_len < sc.num_chunks:
            return True
        return simulate(replace(sc, seq_len=s_len)).feasible

    if not ok(lo):
        return 0
    while ok(hi):
        hi *= 2
        if hi > (1 << 31):
            return hi
    while hi - lo > quantum:
        mid = (lo + hi) // 2 // quantum * quantum
        if mid <= lo:
            break
        if ok(mid):
            lo = mid
        else:
            hi = mid
    return lo
