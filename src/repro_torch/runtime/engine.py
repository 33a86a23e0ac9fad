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

Observability (``repro_torch.obs``): ``configure_obs`` arms the executor's
stage telemetry, measured tick spans and health monitor; ``measured_waves``
is the calibration input; ``ContinuousEngine.merged_trace`` / ``export_obs``
write one Chrome trace and one metrics file.

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
from repro_torch.core.staging import TPLayout
from repro_torch.kvstore import quant as kvquant
from repro_torch.kvstore.pages import POOL_FIELDS, PagedPool
from repro_torch.kvstore.prefix import (DeviceSeedCache, PrefixPageCache,
                                        chunk_hashes)
from repro_torch.obs import telemetry as obs_t
from repro_torch.obs.profile import TickSpanCollector


def _nbytes(tensors) -> float:
    return float(sum(x.numel() * x.element_size() for x in tensors if x is not None))


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
    # chained chunk-content hashes (kvstore.prefix.chunk_hashes): the radix
    # index key; ContinuousEngine fills them from the tokens when the
    # prefix cache is on; () = never shared
    prefix_hashes: Tuple[int, ...] = ()


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
    # cross-request prefix KV reuse (kvstore.prefix): "on" arms the radix
    # index (ContinuousEngine: an admitted request whose leading chunks are
    # resident leases only its novel suffix and is priced against the
    # shorter effective sequence) and the TorchExecutor's seeded pools
    prefix_cache: str = "off"          # off | on
    prefix_min_pages: int = 1          # ignore hits smaller than this

    def __post_init__(self):
        if self.prefix_cache not in ("off", "on"):
            raise ValueError(f"unknown prefix_cache {self.prefix_cache!r} (off | on)")
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
    observability entries arm the executor (``configure_obs``) and read
    back what it measured (``measured_waves``, ``merged_trace``,
    ``export_obs``)."""

    draining: bool

    def submit(self, req: "Request") -> None: ...
    def run_until_drained(self) -> None: ...
    def poll(self) -> List["Request"]: ...
    def drain(self) -> List["Request"]: ...
    def queue_depth(self) -> int: ...
    def free_lease_bytes(self) -> float: ...
    def estimate_admission(self, seq_len: int, arrival: float = 0.0,
                           prefix_hashes: Optional[Sequence[int]] = None
                           ) -> Tuple[float, bool]: ...
    def prefix_stats(self) -> Dict[str, Any]: ...
    def prefix_hit_pages(self, prefix_hashes: Sequence[int]) -> int: ...
    def metrics(self) -> Dict[str, Any]: ...
    def records(self) -> List[Any]: ...
    def recalibrate(self, hw: Any) -> Any: ...
    def merged_trace(self) -> Any: ...
    def export_obs(self, trace_out: Optional[str] = None,
                   metrics_out: Optional[str] = None,
                   extra: Optional[Dict[str, float]] = None,
                   health: Any = None) -> Dict[str, str]: ...
    def configure_obs(self, *, telemetry: Optional[bool] = None,
                      measured: Optional[bool] = None,
                      health: Any = None) -> None: ...
    def measured_waves(self) -> List[Dict[str, Any]]: ...


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
    executor's construction).

    ``prefix_enabled`` (set by ``ContinuousEngine`` when
    ``EngineConfig.prefix_cache == "on"``) arms the device half of the
    prefix cache, as in the reference's ``JaxExecutor``: every wave runs
    with ``return_kv=True``, and each request's batch element of the final
    pool is copied to host memory (pinned when on the card) into a
    per-(seq, M) ``kvstore.prefix.DeviceSeedCache``, keyed by its hash
    chain. A later wave whose requests all share a cached prefix runs with
    ``prefix_chunks=k`` (the wave's least match, clamped to ``min(p2,
    M - 1)``) on a seed stacked from those snapshots on the device. Each
    wave records ``prefix_chunks``; an armed one also records the seed's
    and the snapshots' copy times and bytes (``seed_h2d_s``, ``seed_bytes``,
    ``snap_d2h_s``, ``snap_bytes``), taken outside ``dur``, which stays the
    pipeline's wall time.

    Observability, settable any time (the port prepares no program per
    setting, so there is no cache to key them into: each wave reads them):
    ``collect_telemetry`` runs ``return_telemetry=True`` and lands the
    ``[N, T]`` stage telemetry in ``wave["telemetry"]`` with the per-event
    wire prices (``wave["per_event_wire"]``); ``collect_measured`` arms the
    ``tick_hook`` with an ``obs.profile.TickSpanCollector`` (CUDA events on
    the card) and lands the measured ``[N, T]`` tick spans in
    ``wave["measured"]``, the calibration input (the first wave also holds
    the kernels' first build: calibrate against a later one); ``health``
    (an ``obs.health.HealthMonitor``) arms the non-finite sentinel and, with
    telemetry on, checks each wave's occupancy against the analytic twin.
    Each wave runs inside a ``torch.profiler.record_function`` range named
    ``prefill_wave seq<S> b<B>``.

    As the reference's ``JaxExecutor``, it passes no frontend embeddings:
    a vlm (llava-next-34b) is served text-only, and an encdec model
    (whisper-small), which cannot run without its frames, is refused.

    ``layout`` (``core.staging.TPLayout``): the tp axis of each stage. At
    tp > 1 the waves run the manual TP lowering (the plans take
    ``run.tp_lowering``, "auto" resolving to "manual" on the card), and
    ``staged_params`` must be in its layout (``core.staging.
    shard_params``); ``run`` is then called with that tp. A prefix
    snapshot holds the request's rows of every shard's pool."""

    def __init__(self, cfg: ModelConfig, staged_params, run: RunConfig, *,
                 device=None, layout: Optional[TPLayout] = None):
        if cfg.family == "encdec":
            raise ValueError(
                f"{cfg.arch}: TorchExecutor serves token prompts only, and the "
                "encdec family needs frame embeddings; run it through "
                "prefill_pipeline(embeds=)")
        self.device = devices.resolve(device)
        self.cfg, self.run_cfg = cfg, run
        self.layout = layout or TPLayout()
        self.staged = staged_params
        self._plans: Dict[Tuple[int, int, int], pp.PipelinePlan] = {}
        self.waves: List[Dict[str, Any]] = []
        self._epoch = time.perf_counter()
        self.prefix_enabled = False
        self.prefix_seed_entries = 8       # DeviceSeedCache LRU bound
        self._seed_caches: Dict[Tuple[int, int], DeviceSeedCache] = {}
        self.prefix_device_hit_chunks = 0  # sum of seeded k over waves
        self.collect_telemetry = False
        self.collect_measured = False
        self.health = None
        self._span_col: Optional[TickSpanCollector] = None

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

    # ----------------------------------------------------- device prefix
    def _seed_cache(self, seq: int, m: int) -> DeviceSeedCache:
        key = (seq, m)
        if key not in self._seed_caches:
            self._seed_caches[key] = DeviceSeedCache(self.prefix_seed_entries)
        return self._seed_caches[key]

    def _assemble_seed(self, cache: DeviceSeedCache,
                       chains: List[Tuple[int, ...]], k: int) -> Optional[PagedPool]:
        """Stack each request's cached batch element on the batch axis into
        one stage-stacked ``PagedPool`` [N, P, lps, B, ...] on the device
        (at tp > 1 [N, P, lps, tp * B, ...]: shard-major rows, as the pool
        folds them), the ``prefix_pool`` input of ``prefill_pipeline``.
        None if any element is missing."""
        elems = [cache.lookup(ch, k) for ch in chains]
        if any(e is None for e in elems):
            return None

        def stack(f):
            if elems[0][f] is None:
                return None
            xs = [e[f].to(self.device, non_blocking=True) for e in elems]
            if self.layout.tp == 1:
                return kvquant.stack(xs, dim=3)
            return kvquant.stack(xs, dim=4).flatten(3, 4)
        return PagedPool(*(stack(f) for f in POOL_FIELDS))

    def _snapshot(self, kv: PagedPool, i: int) -> Dict[str, Optional[torch.Tensor]]:
        """Batch element ``i`` of the final pool ([N, P, lps, ...]; at
        tp > 1 its rows of every shard's pool, [N, P, lps, tp, ...]),
        copied to host memory."""
        pin = self.device.type == "cuda"
        out: Dict[str, Optional[torch.Tensor]] = {}
        for f in POOL_FIELDS:
            x = getattr(kv, f)
            if x is None:
                out[f] = None
                continue
            src = kvquant.as_bytes(x)
            src = (src[:, :, :, i] if self.layout.tp == 1
                   else src.unflatten(3, (self.layout.tp, -1))[:, :, :, :, i])
            host = torch.empty(src.shape, dtype=src.dtype, pin_memory=pin)
            out[f] = host.copy_(src, non_blocking=True).view(x.dtype)
        return out

    def run(self, requests: Sequence[Request], chunks: Sequence[int],
            num_stages: int, tp: int) -> Tuple[float, np.ndarray]:
        """Returns (wave wall seconds, per-stage average chunk time [N])."""
        if tp != self.layout.tp:
            raise ValueError(f"tp {tp}: this executor's params are laid out for "
                             f"tp = {self.layout.tp} (TorchExecutor(layout=))")
        if len(set(chunks)) != 1:
            raise ValueError(f"uniform chunks only, got {list(chunks)}")
        seq = int(sum(chunks))
        plan = self.plan_for(seq, len(chunks), num_stages)
        toks = np.stack([np.pad(r.tokens, (0, seq - len(r.tokens)))
                         for r in requests]).astype(np.int64)
        armed = bool(self.prefix_enabled)
        prefix: Dict[str, Any] = {}
        k, seed, chains, cache = 0, None, [], None
        if armed:
            cache = self._seed_cache(seq, len(chunks))
            chains = [tuple(r.prefix_hashes or ()) for r in requests]
            if all(chains):
                k = min(min(cache.match(ch) for ch in chains),
                        plan.p2, len(chunks) - 1)
            if k > 0:
                self._sync()
                t = time.perf_counter()
                seed = self._assemble_seed(cache, chains, k)
                self._sync()
                prefix["seed_h2d_s"] = time.perf_counter() - t
                if seed is None:
                    k = 0
                else:
                    prefix["seed_bytes"] = _nbytes(getattr(seed, f) for f in POOL_FIELDS)
            self.prefix_device_hit_chunks += k
        collect, health = bool(self.collect_telemetry), self.health
        col = None
        if self.collect_measured:
            if self._span_col is None:
                self._span_col = TickSpanCollector(self.device)
            col = self._span_col
        self._sync()
        if col is not None:
            col.reset()
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"prefill_wave seq{seq} b{len(requests)}"):
            res = pp.prefill_pipeline(
                self.cfg, self.staged, toks, plan, device=self.device,
                return_telemetry=collect, prefix_chunks=k, prefix_pool=seed,
                return_kv=armed, tick_hook=None if col is None else col.note,
                health=health, layout=self.layout)
        res = res if isinstance(res, tuple) else (res,)
        out = res[0]
        tel = res[1] if collect else None
        kv = res[1 + int(collect)] if armed else None
        self._sync()
        dt = time.perf_counter() - t0
        if kv is not None:
            t = time.perf_counter()
            snaps = [(ch, self._snapshot(kv, i)) for i, ch in enumerate(chains) if ch]
            self._sync()
            prefix["snap_d2h_s"] = time.perf_counter() - t
            prefix["snap_bytes"] = _nbytes(x for _, e in snaps for x in e.values())
            for ch, e in snaps:
                cache.put(ch, e)
        for r, row in zip(requests, out.cpu().numpy()):
            r.result = row
        wave: Dict[str, Any] = {
            "start": t0 - self._epoch, "dur": dt, "seq": seq,
            "num_ticks": int(plan.num_ticks), "num_stages": num_stages,
            "chunks": list(chunks), "rids": [r.rid for r in requests],
            "prefix_chunks": k, **prefix}
        if col is not None:
            wave["measured"] = col.finalize(num_stages, int(plan.num_ticks)).tick_s
        if tel is not None:
            wave["telemetry"] = tel
            wave["per_event_wire"] = obs_t.per_event_wire_bytes(
                plan, self.cfg, len(requests))
            if health is not None:
                health.check_occupancy(tel, plan)
        self.waves.append(wave)
        return dt, np.full(num_stages, dt / max(len(chunks), 1))


# ------------------------------------------------------------------- engine

def _configure_obs(ex, telemetry: Optional[bool], measured: Optional[bool],
                   health: Any) -> None:
    """Arm an executor's observability; flags it lacks are ignored (the
    ``SimExecutor`` IS the analytic model: there is nothing to measure)."""
    if telemetry is not None and hasattr(ex, "collect_telemetry"):
        ex.collect_telemetry = bool(telemetry)
    if measured is not None and hasattr(ex, "collect_measured"):
        ex.collect_measured = bool(measured)
    if health is not None:
        ex.health = health


def _measured_waves(ex) -> List[Dict[str, Any]]:
    return [w for w in getattr(ex, "waves", []) if w.get("measured") is not None]


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

    def configure_obs(self, *, telemetry: Optional[bool] = None,
                      measured: Optional[bool] = None,
                      health: Any = None) -> None:
        """See ``ContinuousEngine.configure_obs`` — the same executor seam."""
        _configure_obs(self.executor, telemetry, measured, health)

    def measured_waves(self) -> List[Dict[str, Any]]:
        """See ``ContinuousEngine.measured_waves`` — the calibration input."""
        return _measured_waves(self.executor)

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

    ``EngineConfig.prefix_cache == "on"`` builds the radix prefix index
    (``kvstore.prefix.PrefixPageCache``, its pages sized by the largest
    bucket's chunk), hashes each submitted request's tokens by its bucket's
    chunks, prices a hit with ``_chunk_plan_prefix`` and a suffix-only
    lease, and arms the executor's device seed cache where it has one.
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
        self._mplans: Dict[int, Any] = {}      # bucket -> MBKR plan
        self._pplans: Dict[Tuple[int, int], Any] = {}  # (bucket, k) plans
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
        # radix prefix index: page geometry from the LARGEST bucket's chunk;
        # per-bucket plans with smaller chunks clamp their shared-page
        # subtraction in chunk_page_bytes
        self.prefix_cache = None
        if ec.prefix_cache == "on":
            pt = ec.kv_page_tokens or cmax
            ppc = max(-(-cmax // pt), 1)
            self.prefix_cache = PrefixPageCache(
                pages_per_chunk=ppc,
                page_bytes=max(cm.kv_chunk_bytes(self._sm, cmax), 1.0)
                * kv_compress / ppc)
            if hasattr(executor, "prefix_enabled"):
                executor.prefix_enabled = True   # arm the device seed cache
        self.scheduler = ChunkScheduler(
            ec.num_stages, self._chunk_plan, policy=ec.policy, lease=self.lease,
            trace=self.trace, compress=ec.compress, kv_compress=kv_compress,
            stage_scale=scale, page_tokens=ec.kv_page_tokens,
            prefix_cache=self.prefix_cache,
            prefix_min_pages=ec.prefix_min_pages,
            plan_for_prefix=self._chunk_plan_prefix)

    # ---------------------------------------------------------- admission
    def submit(self, req: Request) -> None:
        if self.draining:
            raise RuntimeError("cell is draining: admission is closed")
        req.bucket = bucket_of(self.ec.buckets, req.seq_len)
        if self.slo is not None and not math.isfinite(req.deadline):
            req.deadline = req.arrival + self.slo
        if (self.prefix_cache is not None and not req.prefix_hashes
                and req.tokens is not None):
            req.prefix_hashes = chunk_hashes(
                np.asarray(req.tokens)[: req.seq_len],
                self._chunk_plan(req.bucket).chunks)
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
            self._mplans[bucket] = mplan
            self._plans[bucket] = self._plan_cls.build(
                bucket, chunks, self._sm, ec.hw, mbkr_plan=mplan,
                compress=ec.compress)
        return self._plans[bucket]

    def _chunk_plan_prefix(self, bucket: int, k: int):
        """The bucket's plan re-priced for a resident prefix of ``k``
        chunks (``costmodel.chunk_cost_arrays(prefix_hit_chunks=k)``):
        zero compute/wire rows for served chunks, same chunk partition."""
        if k <= 0:
            return self._chunk_plan(bucket)
        key = (bucket, int(k))
        if key not in self._pplans:
            base = self._chunk_plan(bucket)    # populates _mplans[bucket]
            self._pplans[key] = self._plan_cls.build(
                bucket, list(base.chunks), self._sm, self.ec.hw,
                mbkr_plan=self._mplans.get(bucket), compress=self.ec.compress,
                prefix_hit_chunks=int(k))
        return self._pplans[key]

    # ---------------------------------------------------------- main loop
    def run_until_drained(self) -> None:
        from repro_torch.sched import SchedRequest
        for r in self.queue:
            if r.state != "queued":
                continue
            self.scheduler.submit(SchedRequest(
                rid=r.rid, arrival=r.arrival, seq_len=r.seq_len,
                bucket=r.bucket, deadline=r.deadline, payload=r,
                prefix_hashes=tuple(r.prefix_hashes)))
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

    def estimate_admission(self, seq_len: int, arrival: float = 0.0,
                           prefix_hashes: Optional[Sequence[int]] = None
                           ) -> Tuple[float, bool]:
        """(predicted finish time, lease-fits-now) for a hypothetical
        request against the live frontier (``ChunkScheduler.preview``).
        ``prefix_hashes`` folds the radix index into the quote: a cell
        already holding the prefix quotes an earlier ETA and a smaller
        lease. Pure."""
        bucket = bucket_of(self.ec.buckets, seq_len)
        return self.scheduler.preview(
            bucket, seq_len, release=arrival,
            prefix_hashes=tuple(prefix_hashes or ()))

    def prefix_stats(self) -> Dict[str, Any]:
        """Radix-index counters (``PrefixPageCache.stats``); {} when the
        prefix cache is off."""
        return self.scheduler.prefix_stats()

    def prefix_hit_pages(self, prefix_hashes: Sequence[int]) -> int:
        """Pages of ``prefix_hashes`` already resident in this cell's radix
        index (the reference fleet router's prefix-affinity tiebreak); 0
        when off."""
        if self.prefix_cache is None or not prefix_hashes:
            return 0
        return int(self.prefix_cache.hit_pages(tuple(prefix_hashes)))

    def records(self) -> List[Any]:
        """Per-request ``RequestRecord`` rows (``sched.metrics``)."""
        return list(self.scheduler.metrics.records)

    def configure_obs(self, *, telemetry: Optional[bool] = None,
                      measured: Optional[bool] = None,
                      health: Any = None) -> None:
        """Arm the executor's observability through the cell seam: stage
        telemetry (``return_telemetry``), measured tick spans
        (``collect_measured``) and a health monitor. Flags the executor does
        not have are ignored."""
        _configure_obs(self.executor, telemetry, measured, health)

    def measured_waves(self) -> List[Dict[str, Any]]:
        """Executor waves that carry a measured ``[N, T]`` tick-span array
        (``configure_obs(measured=True)``): the calibration input."""
        return _measured_waves(self.executor)

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
        self._mplans.clear()
        self._pplans.clear()
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

    # ------------------------------------------------------ observability
    def merged_trace(self):
        """ONE Perfetto trace merging every surface of this run:

        - scheduler task intervals + request lifecycle marks (pid = stage,
          tid = request; the scheduler's virtual clock),
        - per-stage ``kv_lease_bytes`` counter tracks replayed from the
          lease manager's admission timeline (virtual clock),
        - per-stage ``wire_bytes`` counter tracks: sim runs price each
          spilled chunk (index >= p2) from the bucket plan's KV bytes;
          torch runs with ``executor.collect_telemetry`` price the
          telemetry's event counts with the analytic per-event wire bytes,
        - engine wave spans + per-(stage, tick) spans (the wave's wall time
          split evenly over its ticks) and ``kv_resident_bytes`` tracks
          from TorchExecutor telemetry waves (wall clock since executor
          construction, pid = "engine"),
        - MEASURED per-(stage, tick) spans (``wave["measured"]`` from
          ``collect_measured``: device-stream time on the card) on their
          own ``measured`` process row, laid from the wave's start,
        - health-sentinel alerts (``executor.health``) on a ``health``
          process row, labelled whenever a monitor is attached.

        Pure: builds a fresh recorder each call; safe to export repeatedly.
        """
        from repro_torch.obs.trace import TraceRecorder
        rec = TraceRecorder(enabled=True)
        rec.tasks = list(self.trace.tasks)
        rec.marks = list(self.trace.marks)
        # lease residency per stage (virtual clock)
        for s, timeline in enumerate(self.lease._timeline):
            level = 0.0
            for t, delta in sorted(timeline):
                level += delta
                rec.counter("kv_lease_bytes", pid=s, time=t,
                            values={"bytes": level})
        # sim wire model: a chunk with index >= p2 was spilled at creation
        buckets = {sr.rid: sr.bucket for sr in self.scheduler.requests}
        wire_acc: Dict[int, float] = {}
        for ev in sorted(self.trace.tasks, key=lambda e: e.finish):
            plan = self._chunk_plan(buckets.get(ev.rid, max(self.ec.buckets)))
            if ev.chunk >= plan.p2:
                lvl = wire_acc.get(ev.stage, 0.0) + float(plan.kvb[ev.chunk])
                wire_acc[ev.stage] = lvl
                rec.counter("wire_bytes", pid=ev.stage, time=ev.finish,
                            values={"bytes": lvl})
        # engine waves (wall clock) + device telemetry
        waves = getattr(self.executor, "waves", None) or []
        if waves:
            rec.process_name("engine", "engine (wall clock)")
        for wi, w in enumerate(waves):
            rec.span(f"wave{wi} seq{w['seq']} b{len(w['rids'])}",
                     pid="engine", tid=0, start=w["start"],
                     finish=w["start"] + w["dur"], cat="wave",
                     args={"rids": w["rids"], "chunks": w["chunks"]})
            tel = w.get("telemetry")
            if tel is None:
                continue
            pe = w.get("per_event_wire", {})
            n_st, ticks = tel["own_chunks"].shape
            tick_dur = w["dur"] / max(ticks, 1)
            kv, occ = tel["kv_bytes"], tel["own_chunks"] + tel["hosted_chunks"]
            wire = (tel["spill_events"] * pe.get("spill", 0.0)
                    + tel["fetch_events"] * pe.get("fetch", 0.0)
                    + tel["qship_events"] * pe.get("qship", 0.0))
            for s in range(n_st):
                for t in range(ticks):
                    ts = w["start"] + t * tick_dur
                    phase = t - s
                    if 0 <= phase < len(w["chunks"]):
                        rec.span(f"tick{t} c{phase}", pid="engine",
                                 tid=s + 1, start=ts, finish=ts + tick_dur,
                                 cat="tick",
                                 args={"stage": s, "chunk": phase,
                                       "occupancy": float(occ[s, t])})
                    rec.counter("kv_resident_bytes", pid=s, time=ts,
                                values={f"w{wi}": float(kv[s, t])})
                    rec.counter("device_wire_bytes", pid=s, time=ts,
                                values={f"w{wi}": float(wire[s, t])})
        # measured tick spans: one process row, one thread per stage;
        # per-stage span starts are the cumulative measured tick durations
        # from the wave's host start. The row is labelled by the clock the
        # spans were taken on: CUDA events on the card, perf_counter on the
        # CPU (``obs.profile.TickSpanCollector``).
        if any(w.get("measured") is not None for w in waves):
            dev = getattr(self.executor, "device", None)
            clock = ("device-stream time, CUDA events"
                     if dev is not None and dev.type == "cuda"
                     else "host perf_counter")
            rec.process_name("measured", f"measured spans ({clock})")
        for wi, w in enumerate(waves):
            ms = w.get("measured")
            if ms is None:
                continue
            for s in range(ms.shape[0]):
                cursor = w["start"]
                for t in range(ms.shape[1]):
                    d = float(ms[s, t])
                    phase = t - s
                    if 0 <= phase < len(w["chunks"]) and d > 0:
                        rec.span(f"tick{t} c{phase}", pid="measured", tid=s,
                                 start=cursor, finish=cursor + d,
                                 cat="measured",
                                 args={"stage": s, "chunk": phase,
                                       "wave": wi})
                    cursor += d
        health = getattr(self.executor, "health", None)
        if health is not None:
            # the row exists whenever the sentinels are armed, alerts or
            # none (the reference labels it only when one fired)
            rec.process_name("health", "health sentinels")
            health.to_trace(rec)
        return rec

    def export_obs(self, trace_out: Optional[str] = None,
                   metrics_out: Optional[str] = None,
                   extra: Optional[Dict[str, float]] = None,
                   health=None) -> Dict[str, str]:
        """Export the merged trace and/or the metrics summary (both atomic);
        returns {"trace": path, "metrics": path} for whichever was asked.
        ``health`` (default: the executor's attached monitor) adds the
        per-kind alert counters and burn-rate gauge to the metrics."""
        paths: Dict[str, str] = {}
        if health is None:
            health = getattr(self.executor, "health", None)
        if trace_out:
            paths["trace"] = self.merged_trace().export(trace_out)
        if metrics_out:
            from repro_torch.obs.metrics import export_engine_metrics
            paths["metrics"] = export_engine_metrics(
                metrics_out, self.metrics(),
                records=self.scheduler.metrics.records, extra=extra,
                health=health)
        return paths
