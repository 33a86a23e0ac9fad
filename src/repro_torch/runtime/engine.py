"""Prefill-only serving engine on the port: request queue -> chunked-pipeline
execution, plus the fault-tolerance / elasticity layer (mirrors
``repro.runtime.engine``).

- ADMISSION: requests are bucketed by padded sequence length; each bucket has
  a cached chunk plan (LBCP's DP + annealing, or the uniform partition).
- EXECUTION: pluggable executor. ``TorchExecutor`` drives the port's
  ``core.pipeline.prefill_pipeline`` (on the card by default);
  ``SimExecutor`` drives the analytic cost model with fault / straggler
  injection.
- FAULT TOLERANCE: a stage failure re-forms the pipeline without the failed
  stage (N -> N-1, rounded down to even: MBKR pairs stages), re-plans every
  bucket and replays the in-flight requests from their admission watermark.
- STRAGGLER MITIGATION: a per-stage chunk-latency EWMA; a sustained skew
  above ``straggler_threshold`` re-plans, one past ``evict_threshold`` is
  handled as a failure.

Two engines share the executors:
- ``PrefillEngine``: BATCH-SYNCHRONOUS — one bucket-batch runs to completion
  before the next forms; every request pays the pipeline fill/drain bubble.
- ``ContinuousEngine``: drives the executor through the chunk-level scheduler
  (``sched.ChunkScheduler``): policy-ordered (FCFS / SJF / EDF), KV-lease
  gated admission, bubble-free across request boundaries in the analytic
  schedule.

One deliberate deviation: ``TorchExecutor`` refuses a non-uniform chunk list
(the reference's executor silently runs a uniform plan of as many chunks).
The real path builds ``partition="uniform"``, as the reference's serve does,
so LBCP's chunk lists price admission and drive ``SimExecutor`` only.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, replace as dc_replace
from typing import (Any, Dict, List, Optional, Protocol, Sequence, Tuple,
                    runtime_checkable)

import numpy as np
import torch

from repro_torch import device as devices
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core import costmodel as cm
from repro_torch.core import lbcp, mbkr
from repro_torch.core import pipeline as pp


@dataclass
class Request:
    rid: int
    arrival: float
    seq_len: int
    tokens: Optional[np.ndarray] = None
    state: str = "queued"          # queued | running | done | rejected
    bucket: int = 0
    finish_time: float = math.inf
    replays: int = 0
    result: Any = None
    deadline: float = math.inf     # absolute SLO deadline (continuous mode)


def bucket_of(buckets: Sequence[int], seq_len: int) -> int:
    for b in buckets:
        if seq_len <= b:
            return b
    return buckets[-1]


@dataclass(frozen=True)
class EngineConfig:
    model: ModelConfig
    hw: cm.HardwareProfile = cm.TPU_V5E
    num_stages: int = 16
    tp: int = 16
    num_chunks: int = 16
    max_batch: int = 8
    buckets: Tuple[int, ...] = (8192, 32768, 131072)
    partition: str = "lbcp"        # uniform | lbcp
    mbkr: bool = True
    compress: float = 1.0
    # KV page store codec: admission leases count the STORED (quantized)
    # bytes, so "int8" / "fp8" grow capacity ~2x
    kv_dtype: str = "auto"
    kv_page_tokens: int = 0
    sa_iters: int = 60
    straggler_threshold: float = 1.3   # max/median EWMA tick latency
    evict_threshold: float = 3.0
    ewma_alpha: float = 0.3
    policy: str = "fcfs"               # fcfs | sjf | edf admission order
    slo: Optional[float] = None        # seconds; deadline = arrival + slo
    inflight: int = 2                  # MBKR slot pools provisioned
    trace: bool = False                # record the scheduler trace
    prefix_cache: str = "off"          # the prefix KV cache is not ported

    def __post_init__(self):
        if self.prefix_cache != "off":
            raise ValueError(f"prefix_cache={self.prefix_cache!r}: the prefix KV "
                             "cache is not ported (off only)")
        if self.partition not in ("uniform", "lbcp"):
            raise ValueError(f"unknown partition {self.partition!r}")


class StageFailure(RuntimeError):
    def __init__(self, stage: int):
        super().__init__(f"stage {stage} failed")
        self.stage = stage


# ----------------------------------------------------------- cell protocol

@runtime_checkable
class CellHandle(Protocol):
    """The narrow seam between one serving cell and what drives it (the
    serve CLI; the reference's fleet router). ``ContinuousEngine`` is the
    implementation. Lifecycle: ``submit`` -> ``run_until_drained``
    (re-entrant) -> ``poll``; ``drain`` closes admission for good. The
    observability and prefix-cache methods of the reference's protocol are
    not ported yet."""

    draining: bool

    def submit(self, req: "Request") -> None: ...
    def run_until_drained(self) -> None: ...
    def poll(self) -> List["Request"]: ...
    def drain(self) -> List["Request"]: ...
    def queue_depth(self) -> int: ...
    def free_lease_bytes(self) -> float: ...
    def estimate_admission(self, seq_len: int, arrival: float = 0.0
                           ) -> Tuple[float, bool]: ...
    def metrics(self) -> Dict[str, Any]: ...
    def records(self) -> List[Any]: ...
    def recalibrate(self, hw: Any) -> Any: ...


# ---------------------------------------------------------------- executors

class SimExecutor:
    """Analytic executor: returns per-stage makespan from the cost model.
    Fault / straggler injection for engine tests:
      fail_at[batch_counter] = stage   -> raise StageFailure mid-batch
      slow = {stage: factor}           -> inflate that stage's task times

    BATCH-SYNCHRONOUS semantics: requests in a batch run to completion one
    after another, each paying the full pipeline fill/drain. Straggler
    factors scale only the affected stage's task durations; the per-request
    makespan comes from the shared list-scheduling core.
    """

    def __init__(self, cfg: ModelConfig, hw: cm.HardwareProfile,
                 fail_at: Optional[Dict[int, int]] = None,
                 slow: Optional[Dict[int, float]] = None):
        self.cfg, self.hw = cfg, hw
        self.fail_at = fail_at or {}
        self.slow = slow or {}
        self.batch_counter = 0

    def stage_scale(self, num_stages: int) -> np.ndarray:
        scale = np.ones(num_stages)
        for s, f in self.slow.items():
            if s < num_stages:
                scale[s] = max(float(f), 1e-9)
        return scale

    def chunk_costs(self, chunks: Sequence[int], num_stages: int, tp: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """(per-chunk task seconds, per-chunk boundary comm seconds)."""
        sm = cm.StageModel.build(self.cfg, num_stages, tp)
        dur, comm, _, _, _ = cm.chunk_cost_arrays(sm, chunks, self.hw)
        return dur, comm

    def run(self, requests: Sequence[Request], chunks: Sequence[int],
            num_stages: int, tp: int) -> Tuple[float, np.ndarray]:
        """Returns (makespan seconds, per-stage avg tick latency [N])."""
        from repro_torch.sim.engine import schedule_request
        self.batch_counter += 1
        if self.batch_counter in self.fail_at:
            raise StageFailure(self.fail_at[self.batch_counter])
        dur, comm = self.chunk_costs(chunks, num_stages, tp)
        scale = self.stage_scale(num_stages)
        finish = schedule_request(dur, comm, num_stages, np.zeros(num_stages),
                                  stage_scale=scale)
        lat_req = float(finish[-1][-1])
        lat = np.full(num_stages, dur.mean()) * scale
        return lat_req * max(len(requests), 1), lat


class TorchExecutor:
    """Runs one wave (a bucket-batch) through ``prefill_pipeline`` on
    ``device`` (default the card). One plan per (seq, chunk count, N) is
    built on first use. Each wave's wall time, taken around work that ends
    in a device synchronise, lands in ``self.waves`` (start relative to the
    executor's construction)."""

    def __init__(self, cfg: ModelConfig, staged_params, run: RunConfig, *,
                 device=None):
        self.device = devices.resolve(device)
        self.cfg, self.run_cfg = cfg, run
        self.staged = staged_params
        self._plans: Dict[Tuple[int, int, int], pp.PipelinePlan] = {}
        self.waves: List[Dict[str, Any]] = []
        self._epoch = time.perf_counter()

    def plan_for(self, seq: int, num_chunks: int, num_stages: int) -> pp.PipelinePlan:
        key = (seq, num_chunks, num_stages)
        if key not in self._plans:
            self._plans[key] = pp.build_plan(
                self.cfg, num_stages, seq,
                dc_replace(self.run_cfg, num_chunks=num_chunks))
        return self._plans[key]

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, requests: Sequence[Request], chunks: Sequence[int],
            num_stages: int, tp: int) -> Tuple[float, np.ndarray]:
        """Returns (wave wall seconds, per-stage average chunk time [N])."""
        if tp != 1:
            raise ValueError("this slice runs tp = 1")
        if len(set(chunks)) != 1:
            raise ValueError(f"uniform chunks only, got {list(chunks)}")
        seq = int(sum(chunks))
        plan = self.plan_for(seq, len(chunks), num_stages)
        toks = np.stack([np.pad(r.tokens, (0, seq - len(r.tokens)))
                         for r in requests]).astype(np.int64)
        self._sync()
        t0 = time.perf_counter()
        out = pp.prefill_pipeline(self.cfg, self.staged, toks, plan,
                                  device=self.device)
        self._sync()
        dt = time.perf_counter() - t0
        for r, row in zip(requests, out.cpu().numpy()):
            r.result = row
        self.waves.append({
            "start": t0 - self._epoch, "dur": dt, "seq": seq,
            "num_ticks": int(plan.num_ticks), "num_stages": num_stages,
            "chunks": list(chunks), "rids": [r.rid for r in requests]})
        return dt, np.full(num_stages, dt / max(len(chunks), 1))


# ------------------------------------------------------------------- engine

class PrefillEngine:
    def __init__(self, ec: EngineConfig, executor):
        self.ec = ec
        self.executor = executor
        self.queue: List[Request] = []
        self.done: List[Request] = []
        self._polled = 0
        self.clock = 0.0
        self.num_stages = ec.num_stages
        self.failed_stages: List[int] = []
        self.ewma: Optional[np.ndarray] = None  # seeded by the first observation
        self.replans = 0
        self.remeshes = 0
        self._plans: Dict[Tuple[int, int], List[int]] = {}

    # ---------------------------------------------------------- admission
    def submit(self, req: Request) -> None:
        req.bucket = self._bucket(req.seq_len)
        self.queue.append(req)

    def _bucket(self, seq_len: int) -> int:
        return bucket_of(self.ec.buckets, seq_len)

    def _plan_for(self, bucket: int) -> List[int]:
        key = (bucket, self.num_stages)
        if key not in self._plans:
            if self.ec.partition == "lbcp":
                pp_ = lbcp.plan_partition(
                    self.ec.model, bucket, self.ec.num_chunks, self.num_stages,
                    self.ec.hw, tp=self.ec.tp, mbkr=self.ec.mbkr,
                    compress=self.ec.compress, sa_iters=self.ec.sa_iters)
                self._plans[key] = pp_.chunks
            else:
                self._plans[key] = lbcp.uniform_partition(bucket, self.ec.num_chunks)
        return self._plans[key]

    # ---------------------------------------------------------- main loop
    def step(self) -> bool:
        """Admit and run ONE batch; False when the queue is empty. The
        batch's bucket is the one holding the oldest queued request (by
        arrival, then rid); within it, oldest requests first, at most
        ``max_batch`` of them."""
        pending = [r for r in self.queue if r.state == "queued"]
        if not pending:
            return False
        oldest = min(pending, key=lambda r: (r.arrival, r.rid))
        batch = sorted((r for r in pending if r.bucket == oldest.bucket),
                       key=lambda r: (r.arrival, r.rid))[: self.ec.max_batch]
        chunks = self._plan_for(oldest.bucket)
        for r in batch:
            r.state = "running"
        try:
            makespan, stage_lat = self.executor.run(
                batch, chunks, self.num_stages, self.ec.tp)
        except StageFailure as e:
            self._handle_failure(e.stage, batch)
            return True
        self.clock += makespan
        self._observe(stage_lat)
        for r in batch:
            r.state = "done"
            r.finish_time = self.clock
            self.queue.remove(r)
            self.done.append(r)
        return True

    def run_until_drained(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if not self.step():
                return

    def poll(self) -> List[Request]:
        """Requests completed since the last ``poll`` (completion order)."""
        new = self.done[self._polled:]
        self._polled = len(self.done)
        return list(new)

    # ------------------------------------------------------ fault handling
    def _handle_failure(self, stage: int, batch: Sequence[Request]) -> None:
        """Stage loss: its layer-slice KV for in-flight requests is gone ->
        re-form the pipeline without it and replay the batch from admission."""
        self.failed_stages.append(stage)
        new_n = self.num_stages - 1
        if new_n % 2:
            new_n -= 1  # MBKR pairs stages; keep N even
        self.num_stages = max(new_n, 2)
        self.remeshes += 1
        self._plans.clear()          # plans depend on N — rebuilt lazily
        self.ewma = None
        for r in batch:
            r.state = "queued"       # replay from the admission watermark
            r.replays += 1

    # -------------------------------------------------- straggler handling
    def _observe(self, stage_lat: np.ndarray) -> None:
        a = self.ec.ewma_alpha
        if self.ewma is None or len(stage_lat) != len(self.ewma):
            self.ewma = np.asarray(stage_lat, float)
        self.ewma = (1 - a) * self.ewma + a * stage_lat
        med = float(np.median(self.ewma))
        worst = int(np.argmax(self.ewma))
        skew = float(self.ewma[worst] / max(med, 1e-12))
        if skew > self.ec.evict_threshold:
            self._handle_failure(worst, [r for r in self.queue
                                         if r.state == "running"])
        elif skew > self.ec.straggler_threshold:
            self._plans.clear()      # fold new latencies into fresh plans
            self.replans += 1

    # ----------------------------------------------------------- metrics
    def metrics(self) -> Dict[str, float]:
        lat = [r.finish_time - r.arrival for r in self.done]
        return {
            "completed": len(self.done),
            "avg_e2e": float(np.mean(lat)) if lat else math.nan,
            "p99_e2e": float(np.percentile(lat, 99)) if lat else math.nan,
            "throughput": len(self.done) / self.clock if self.clock else 0.0,
            "replans": self.replans,
            "remeshes": self.remeshes,
            "num_stages": self.num_stages,
        }

    # ------------------------------------------------------- checkpointing
    def state_dict(self) -> Dict[str, Any]:
        """JSON-serializable engine state. Round-trips the clock, N, the
        failed stages, the EWMA, the re-plan and re-mesh counts; per queued
        request (rid, arrival, seq_len, state, replays); per done request
        (rid, arrival, seq_len, finish_time). Tokens and results stay with
        the caller; a running request is restored as queued (it replays)."""
        return {
            "clock": self.clock,
            "num_stages": self.num_stages,
            "failed_stages": list(self.failed_stages),
            "ewma": self.ewma.tolist() if self.ewma is not None else None,
            "replans": self.replans,
            "remeshes": self.remeshes,
            "queue": [(r.rid, r.arrival, r.seq_len, r.state, r.replays)
                      for r in self.queue],
            "done": [(r.rid, r.arrival, r.seq_len, r.finish_time)
                     for r in self.done],
        }

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        self.clock = d["clock"]
        self.num_stages = int(d["num_stages"])
        self.failed_stages = list(d["failed_stages"])
        self.ewma = np.asarray(d["ewma"]) if d["ewma"] is not None else None
        self.replans = int(d["replans"])
        self.remeshes = int(d["remeshes"])
        self.queue = [Request(rid, arr, sl, state="queued", replays=rp)
                      for rid, arr, sl, state, rp in d["queue"]]
        for r in self.queue:
            r.bucket = self._bucket(r.seq_len)
        self.done = [Request(rid, arr, sl, state="done", finish_time=ft)
                     for rid, arr, sl, ft in d["done"]]
        self._plans.clear()


# -------------------------------------------------------- continuous engine

class ContinuousEngine:
    """Continuous-serving engine: drives the executor THROUGH the chunk-level
    scheduler (``sched.ChunkScheduler``).

    - ``SimExecutor``: finish times come from the scheduler's overlapped
      schedule (the shared ``sim.engine.schedule_request`` core); the
      executor's straggler factors fold in via ``stage_scale``.
    - ``TorchExecutor``: the requests run in the scheduler's admission
      order, consecutive same-bucket admissions stacked (up to
      ``max_batch``) into one wave, the waves back to back. The scheduler's
      clock, and so ``metrics()``'s TTFT and makespan, stays the analytic
      model's under ``EngineConfig.hw``, as in the reference; the measured
      wave times are the executor's ``waves``.

    Admission is policy-ordered (``EngineConfig.policy``) and gated by the
    ``KVLeaseManager``, whose per-stage budget is the MBKR slot pool for
    ``EngineConfig.inflight`` concurrent requests (clamped to the KV
    capacity). ``EngineConfig.slo`` (seconds) stamps each submitted
    request's deadline = arrival + slo; EDF orders by it.
    """

    def __init__(self, ec: EngineConfig, executor):
        from repro_torch.kvstore import quant as kvq
        from repro_torch.sched import (ChunkPlan, ChunkScheduler,
                                       KVLeaseManager, TraceRecorder,
                                       slot_budget_bytes)
        self.ec = ec
        self.executor = executor
        self.slo = ec.slo
        self.draining = False
        self.queue: List[Request] = []
        self.done: List[Request] = []
        self._polled = 0          # self.done prefix already handed to poll()
        self._consumed = 0        # scheduler.admitted prefix already drained
        self._plan_cls = ChunkPlan
        self._plans: Dict[int, Any] = {}
        self._sm = cm.StageModel.build(ec.model, ec.num_stages, ec.tp)

        # MBKR slot budget for `inflight` concurrent requests, <= capacity
        mplan = mbkr.plan(ec.num_chunks, ec.num_stages, mbkr=ec.mbkr)
        cmax = -(-max(ec.buckets) // ec.num_chunks)
        weights = ec.model.param_count() * 2 / (ec.num_stages * max(ec.tp, 1))
        capacity = max(ec.hw.hbm_cap - weights, 0.0) * max(ec.tp, 1)
        budget = slot_budget_bytes(
            max(ec.inflight, 1) * mplan.num_slots,
            max(cm.kv_chunk_bytes(self._sm, cmax), 1.0),
            ec.num_stages, capacity=capacity if capacity > 0 else None)
        self.lease = KVLeaseManager(ec.num_stages, budget)
        self.trace = TraceRecorder(enabled=ec.trace)
        scale = (executor.stage_scale(ec.num_stages)
                 if hasattr(executor, "stage_scale") else None)
        # leases count the page store's STORED bytes
        codec = kvq.get_codec(ec.kv_dtype, ec.model.dtype)
        kv_compress = kvq.kv_compress_factor(
            codec, model_dtype=ec.model.dtype,
            page_tokens=ec.kv_page_tokens or cmax,
            head_dim=ec.model.resolved_head_dim)
        self.scheduler = ChunkScheduler(
            ec.num_stages, self._chunk_plan, policy=ec.policy, lease=self.lease,
            trace=self.trace, compress=ec.compress, kv_compress=kv_compress,
            stage_scale=scale, page_tokens=ec.kv_page_tokens)

    # ---------------------------------------------------------- admission
    def submit(self, req: Request) -> None:
        if self.draining:
            raise RuntimeError("cell is draining: admission is closed")
        req.bucket = bucket_of(self.ec.buckets, req.seq_len)
        if self.slo is not None and not math.isfinite(req.deadline):
            req.deadline = req.arrival + self.slo
        self.queue.append(req)

    def _chunk_plan(self, bucket: int):
        """Per-bucket chunk plan + analytic cost vectors (cached)."""
        if bucket not in self._plans:
            ec = self.ec
            if ec.partition == "lbcp":
                pp_ = lbcp.plan_partition(
                    ec.model, bucket, ec.num_chunks, ec.num_stages, ec.hw,
                    tp=ec.tp, mbkr=ec.mbkr, compress=ec.compress,
                    sa_iters=ec.sa_iters)
                chunks, mplan = pp_.chunks, pp_.mbkr_plan
            else:
                chunks = lbcp.uniform_partition(bucket, ec.num_chunks)
                mplan = (mbkr.plan(ec.num_chunks, ec.num_stages)
                         if ec.mbkr and not ec.model.attn_free else None)
            self._plans[bucket] = self._plan_cls.build(
                bucket, chunks, self._sm, ec.hw, mbkr_plan=mplan,
                compress=ec.compress)
        return self._plans[bucket]

    # ---------------------------------------------------------- main loop
    def run_until_drained(self) -> None:
        from repro_torch.sched import SchedRequest
        for r in self.queue:
            if r.state != "queued":
                continue
            self.scheduler.submit(SchedRequest(
                rid=r.rid, arrival=r.arrival, seq_len=r.seq_len,
                bucket=r.bucket, deadline=r.deadline, payload=r))
        # scheduler.admitted is cumulative across calls — drain only the new
        # suffix so run_until_drained stays re-entrant
        order = self.scheduler.run()[self._consumed:]
        self._consumed += len(order)
        for sr in order:
            req: Request = sr.payload
            req.state = "done"
            req.finish_time = sr.finish_time
            self.queue.remove(req)
            self.done.append(req)
        for sr in self.scheduler.requests:
            if sr.state == "rejected" and sr.payload in self.queue:
                sr.payload.state = "rejected"
                self.queue.remove(sr.payload)
        if not isinstance(self.executor, SimExecutor):
            self._execute_real(order)

    def _execute_real(self, order) -> None:
        """Stack consecutive same-bucket admissions up to max_batch and run
        each wave through the executor, in admission order."""
        i = 0
        while i < len(order):
            bucket = order[i].bucket
            wave = [order[i]]
            i += 1
            while (i < len(order) and order[i].bucket == bucket
                   and len(wave) < self.ec.max_batch):
                wave.append(order[i])
                i += 1
            chunks = list(self._chunk_plan(bucket).chunks)
            self.executor.run([sr.payload for sr in wave], chunks,
                              self.ec.num_stages, self.ec.tp)

    # ------------------------------------------------- cell-handle surface
    def poll(self) -> List[Request]:
        """Requests completed since the last ``poll`` (admission order)."""
        new = self.done[self._polled:]
        self._polled = len(self.done)
        return list(new)

    def drain(self) -> List[Request]:
        """Stop admission for good and complete the queued work; returns
        the requests the drain completed (the un-polled suffix)."""
        self.draining = True
        self.run_until_drained()
        return self.poll()

    def queue_depth(self) -> int:
        """Requests submitted or admitted but not yet finished at the
        cell's current head-of-pipeline time."""
        now = float(self.scheduler.stage_free[0])
        live = sum(1 for sr in self.scheduler.admitted
                   if sr.finish_time > now)
        return live + sum(1 for r in self.queue if r.state == "queued")

    def free_lease_bytes(self) -> float:
        """Tightest per-stage KV-lease headroom from the cell's current
        head time on."""
        now = float(self.scheduler.stage_free[0])
        return float(self.lease.headroom(after=now).min())

    def estimate_admission(self, seq_len: int, arrival: float = 0.0
                           ) -> Tuple[float, bool]:
        """(predicted finish time, lease-fits-now) for a hypothetical
        request against the live frontier (``ChunkScheduler.preview``)."""
        bucket = bucket_of(self.ec.buckets, seq_len)
        return self.scheduler.preview(bucket, seq_len, release=arrival)

    def records(self) -> List[Any]:
        """Per-request ``RequestRecord`` rows (``sched.metrics``)."""
        return list(self.scheduler.metrics.records)

    def recalibrate(self, hw: cm.ProfileSpec) -> cm.HardwareProfile:
        """Swap the engine onto another profile: drops the cached bucket
        plans and rebases the scheduler's admission costs (admitted
        requests keep their schedule). A ``SimExecutor`` also re-prices
        execution."""
        hw = cm.resolve_profile(hw)
        self.ec = dc_replace(self.ec, hw=hw)
        self._sm = cm.StageModel.build(self.ec.model, self.ec.num_stages,
                                       self.ec.tp)
        self._plans.clear()
        self.scheduler.rebase_costs(self._chunk_plan)
        if isinstance(self.executor, SimExecutor):
            self.executor.hw = hw
        return hw

    # ----------------------------------------------------------- metrics
    @property
    def clock(self) -> float:
        return self.scheduler.metrics.makespan

    def metrics(self) -> Dict[str, float]:
        return self.scheduler.summary()
