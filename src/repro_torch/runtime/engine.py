"""Prefill-only serving engine on the port: a request queue driving the
chunked-pipeline prefill (mirrors the batch-synchronous ``PrefillEngine``
and the ``JaxExecutor.run`` contract of ``repro.runtime.engine``).

Requests are bucketed by padded sequence length; each bucket-batch runs to
completion through the executor before the next forms. This slice serves the
uniform chunk partition; fault handling, straggler re-planning, telemetry
and the prefix cache of the reference are not ported yet.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, replace as dc_replace
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import device as devices
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core import lbcp
from repro_torch.core import pipeline as pp


@dataclass
class Request:
    rid: int
    arrival: float
    seq_len: int
    tokens: Optional[np.ndarray] = None
    state: str = "queued"          # queued | running | done
    bucket: int = 0
    finish_time: float = math.inf
    result: Any = None


def bucket_of(buckets: Sequence[int], seq_len: int) -> int:
    for b in buckets:
        if seq_len <= b:
            return b
    return buckets[-1]


@dataclass(frozen=True)
class EngineConfig:
    model: ModelConfig
    num_stages: int = 8
    tp: int = 1
    num_chunks: int = 8
    max_batch: int = 2
    buckets: Tuple[int, ...] = (4096,)


class TorchExecutor:
    """Runs one wave (a bucket-batch) through ``prefill_pipeline`` on
    ``device`` (default the card). One plan per (seq, chunk count) is built
    on first use. Each wave's wall time, taken around work that ends in a
    device synchronise, lands in ``self.waves``."""

    def __init__(self, cfg: ModelConfig, staged_params, run: RunConfig, *,
                 device=None):
        self.device = devices.resolve(device)
        self.cfg, self.run_cfg = cfg, run
        self.staged = staged_params
        self._plans: Dict[Tuple[int, int], pp.PipelinePlan] = {}
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


class PrefillEngine:
    """Batch-synchronous admission: the batch's bucket is the one holding
    the oldest queued request; within it, oldest requests first, at most
    ``max_batch`` of them."""

    def __init__(self, ec: EngineConfig, executor):
        self.ec = ec
        self.executor = executor
        self.queue: List[Request] = []
        self.done: List[Request] = []
        self._polled = 0
        self.clock = 0.0
        self._plans: Dict[int, List[int]] = {}

    def submit(self, req: Request) -> None:
        req.bucket = bucket_of(self.ec.buckets, req.seq_len)
        self.queue.append(req)

    def _plan_for(self, bucket: int) -> List[int]:
        if bucket not in self._plans:
            self._plans[bucket] = lbcp.uniform_partition(bucket, self.ec.num_chunks)
        return self._plans[bucket]

    def step(self) -> bool:
        """Admit and run one batch; False when the queue is empty."""
        pending = [r for r in self.queue if r.state == "queued"]
        if not pending:
            return False
        oldest = min(pending, key=lambda r: (r.arrival, r.rid))
        batch = sorted((r for r in pending if r.bucket == oldest.bucket),
                       key=lambda r: (r.arrival, r.rid))[: self.ec.max_batch]
        for r in batch:
            r.state = "running"
        makespan, _ = self.executor.run(batch, self._plan_for(oldest.bucket),
                                        self.ec.num_stages, self.ec.tp)
        self.clock += makespan
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
        """Requests completed since the last ``poll``."""
        new = self.done[self._polled:]
        self._polled = len(self.done)
        return list(new)

    def metrics(self) -> Dict[str, float]:
        lat = [r.finish_time - r.arrival for r in self.done]
        return {
            "completed": len(self.done),
            "avg_e2e": float(np.mean(lat)) if lat else math.nan,
            "p99_e2e": float(np.percentile(lat, 99)) if lat else math.nan,
            "throughput": len(self.done) / self.clock if self.clock else 0.0,
            "num_stages": self.ec.num_stages,
        }
