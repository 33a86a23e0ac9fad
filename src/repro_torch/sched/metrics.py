"""Serving metrics for the chunk-level scheduler: TTFT, queueing delay,
SLO attainment, throughput, and pipeline-bubble accounting.

For prefill-only serving the first output token materializes when the LAST
chunk clears the LAST stage, so TTFT == request completion latency
(arrival -> finish); it decomposes into queueing delay (arrival -> admission
into stage 0) plus pipeline execution. SLO attainment is the fraction of
deadline-carrying requests that finish by their deadline.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Sequence

import numpy as np


@dataclass
class RequestRecord:
    rid: int
    arrival: float
    seq_len: int
    bucket: int
    admit: float = math.inf
    finish: float = math.inf
    deadline: float = math.inf
    rejected: bool = False

    @property
    def ttft(self) -> float:
        return self.finish - self.arrival

    @property
    def queue_wait(self) -> float:
        return self.admit - self.arrival

    @property
    def met_slo(self) -> bool:
        return (not self.rejected) and self.finish <= self.deadline


class SchedMetrics:
    """Accumulates per-request records plus per-stage busy seconds."""

    def __init__(self, num_stages: int):
        self.records: List[RequestRecord] = []
        self.busy = np.zeros(num_stages)
        self.makespan = 0.0

    def observe(self, rec: RequestRecord) -> None:
        self.records.append(rec)
        if not rec.rejected and math.isfinite(rec.finish):
            self.makespan = max(self.makespan, rec.finish)

    def observe_busy(self, stage: int, seconds: float) -> None:
        self.busy[stage] += seconds

    # ------------------------------------------------------------- summary
    def summary(self) -> Dict[str, Any]:
        done = [r for r in self.records if not r.rejected
                and math.isfinite(r.finish)]
        ttft = np.array([r.ttft for r in done])
        wait = np.array([r.queue_wait for r in done])
        with_slo = [r for r in self.records if math.isfinite(r.deadline)]
        mk = self.makespan
        util = self.busy / mk if mk > 0 else np.zeros_like(self.busy)
        # peak concurrency: max overlap of the [admit, finish) intervals —
        # the admits-more-at-equal-budget signal prefix sharing moves
        ev = sorted([(r.admit, 1) for r in done if math.isfinite(r.admit)]
                    + [(r.finish, -1) for r in done if math.isfinite(r.admit)])
        cur = peak = 0
        for _, d in ev:
            cur += d
            peak = max(peak, cur)
        return {
            "completed": len(done),
            "peak_inflight": peak,
            "rejected": sum(r.rejected for r in self.records),
            "makespan": mk,
            "throughput": len(done) / mk if mk > 0 else 0.0,
            "avg_ttft": float(ttft.mean()) if len(ttft) else math.nan,
            "p50_ttft": float(np.percentile(ttft, 50)) if len(ttft) else math.nan,
            "p99_ttft": float(np.percentile(ttft, 99)) if len(ttft) else math.nan,
            "avg_queue_wait": float(wait.mean()) if len(wait) else math.nan,
            "p99_queue_wait": float(np.percentile(wait, 99)) if len(wait) else math.nan,
            "slo_total": len(with_slo),
            "slo_met": sum(r.met_slo for r in with_slo),
            "slo_attainment": (sum(r.met_slo for r in with_slo) / len(with_slo)
                               if with_slo else math.nan),
            # bubble fraction of the busiest stage: 1 - busy/makespan
            "bubble_frac": float(1.0 - util.max()) if mk > 0 else math.nan,
            "avg_stage_util": float(util.mean()) if mk > 0 else math.nan,
        }


def fleet_summary(
        records_by_cell: Mapping[str, Sequence[RequestRecord]],
        router_rejections: int = 0,
) -> Dict[str, Any]:
    """Fleet-level serving summary over MANY cells' request records
    (the reference's ``repro.fleet``): the SLO-attainment / TTFT view of the WHOLE arrival
    stream, regardless of which cell served each request, plus a per-cell
    breakdown. Cells share the arrival clock (each scheduler's virtual time
    starts at the stream's t=0), so records merge directly: fleet makespan
    is the latest finish anywhere, fleet throughput is total completions
    over it.

    ``router_rejections`` counts requests the FLEET-LEVEL admission
    controller turned away before any cell saw them (``FleetRouter.place``
    reject-with-retry-after when every cell's lease headroom is exhausted);
    they fold into the fleet ``rejected`` total and get their own key."""
    merged: List[RequestRecord] = [r for recs in records_by_cell.values()
                                   for r in recs]
    done = [r for r in merged if not r.rejected and math.isfinite(r.finish)]
    ttft = np.array([r.ttft for r in done])
    with_slo = [r for r in merged if math.isfinite(r.deadline)]
    mk = max((r.finish for r in done), default=0.0)
    per_cell: Dict[str, Dict[str, Any]] = {}
    for name, recs in records_by_cell.items():
        cdone = [r for r in recs if not r.rejected and math.isfinite(r.finish)]
        cttft = np.array([r.ttft for r in cdone])
        cslo = [r for r in recs if math.isfinite(r.deadline)]
        per_cell[name] = {
            "completed": len(cdone),
            "rejected": sum(r.rejected for r in recs),
            "p99_ttft": float(np.percentile(cttft, 99)) if len(cttft)
                        else math.nan,
            "slo_attainment": (sum(r.met_slo for r in cslo) / len(cslo)
                               if cslo else math.nan),
        }
    return {
        "cells": len(records_by_cell),
        "completed": len(done),
        "rejected": sum(r.rejected for r in merged) + int(router_rejections),
        "router_rejections": int(router_rejections),
        "makespan": float(mk),
        "throughput": len(done) / mk if mk > 0 else 0.0,
        "avg_ttft": float(ttft.mean()) if len(ttft) else math.nan,
        "p50_ttft": float(np.percentile(ttft, 50)) if len(ttft) else math.nan,
        "p99_ttft": float(np.percentile(ttft, 99)) if len(ttft) else math.nan,
        "slo_total": len(with_slo),
        "slo_met": sum(r.met_slo for r in with_slo),
        "slo_attainment": (sum(r.met_slo for r in with_slo) / len(with_slo)
                           if with_slo else math.nan),
        "per_cell": per_cell,
    }
