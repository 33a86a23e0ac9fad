"""Declarative serving options: ONE serializable dataclass for the whole
serve surface (the port's copy of ``repro.launch.options``).

- every flag of ``launch.serve`` maps to a same-named field (dashes ->
  underscores), so a run is reproducible from a JSON file
  (``--options-out`` writes it, ``--options-in`` replays it);
- CLI flags are OVERRIDES: the parser registers every flag with
  ``argparse.SUPPRESS`` defaults, so only flags the user actually typed
  land in the namespace — merge order is dataclass defaults <-
  ``--options-in`` JSON <- explicit flags;
- a FLEET SPEC is a list of per-cell ServeOptions override dicts plus a
  router policy: ``{"router": "jsf", "cells": [{"kv_dtype": "int8"}, {}]}``
  — each cell's EngineConfig derives from the base options with that
  cell's overrides applied (heterogeneous cells by construction).

The fields are the port's serve flags, under the reference's names where
it has one. ``tp`` (each stage's tensor-parallel degree, an emulated tp
axis on one card; the reference derives it from its device count) and the
reference's ``tp_lowering`` reach a torch cell ("auto" resolves to the
manual lowering on the card). The reference's TPU-only fields have no
counterpart here, since nothing on one card can honour them: its ``jax``
executor, its ``transport``, its ``fetch_batch`` (the port's fetch is
always one batched launch) and its ``kv_page_tokens`` (the port serves one
page a chunk). The reference's ``preset`` is the port's ``smoke`` flag.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass, field, fields, replace as dc_replace
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.configs.base import (ATTN_BACKENDS, POOL_BACKENDS, SSM_BACKENDS,
                                      list_archs)
from repro_torch.core.costmodel import PROFILES
from repro_torch.fleet.placement import ROUTER_POLICIES

# the analytic executor's buckets (tokens) when --buckets is not given
SIM_BUCKETS = (8192, 32768, 131072)


@dataclass(frozen=True)
class ServeOptions:
    # model / scale
    arch: str = "qwen3-8b"
    smoke: bool = False                # the small config
    executor: str = "torch"            # torch | sim
    device: Optional[str] = None       # cuda (None) | cpu
    requests: int = 4
    seq: int = 4096
    num_chunks: int = 8
    num_stages: int = 8
    tp: int = 1                        # each stage's tp degree (torch executor)
    tp_lowering: str = "auto"          # auto | manual (auto -> manual on the card)
    max_batch: int = 4
    seed: int = 0
    buckets: Optional[Tuple[int, ...]] = None   # None = --seq (sim: SIM_BUCKETS)
    # kernel backends
    remote_attn: str = "qship"         # qship | fetch
    attn_backend: str = "cuda"
    pool_backend: str = "auto"
    ssm_backend: str = "cuda"
    # KV page store
    kv_dtype: str = "auto"
    kv_offload: bool = False
    # cross-request prefix KV reuse (repro_torch.kvstore.prefix)
    prefix_cache: str = "off"          # off | on
    prefix_min_pages: int = 1
    shared_prefix: int = 0
    # scheduling
    scheduler: str = "batch"           # batch | continuous
    policy: str = "fcfs"               # fcfs | sjf | edf
    arrival_rate: float = 0.0
    slo_ms: Optional[float] = None
    profile: str = "tpu-v5e"           # the cost model's profile
    # fleet (multi-cell)
    cells: int = 1
    router: str = "jsf"                # jsf | rr | least-loaded
    fleet_spec: Optional[str] = None   # path to the fleet-spec JSON
    # observability
    trace_out: Optional[str] = None
    metrics_out: Optional[str] = None
    profile_dir: Optional[str] = None
    calibrated_profile: Optional[str] = None
    calibrate: Optional[str] = None
    health: bool = False

    # ------------------------------------------------------------ round-trip
    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        if d["buckets"] is not None:
            d["buckets"] = list(d["buckets"])
        return d

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ServeOptions":
        known = {f.name for f in fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            raise ValueError(f"unknown ServeOptions keys: {unknown} "
                             f"(expected a subset of {sorted(known)})")
        d = dict(d)
        if d.get("buckets") is not None:
            d["buckets"] = tuple(int(b) for b in d["buckets"])
        return cls(**d)

    @classmethod
    def from_json(cls, text: str) -> "ServeOptions":
        return cls.from_dict(json.loads(text))

    def override(self, **kw) -> "ServeOptions":
        """Same validation as from_dict, replace() semantics."""
        if kw.get("buckets") is not None:
            kw["buckets"] = tuple(int(b) for b in kw["buckets"])
        known = {f.name for f in fields(type(self))}
        unknown = sorted(set(kw) - known)
        if unknown:
            raise ValueError(f"unknown ServeOptions keys: {unknown}")
        return dc_replace(self, **kw)


# ------------------------------------------------------------------- parser

def _csv_ints(text: str) -> Tuple[int, ...]:
    return tuple(int(t) for t in text.split(",") if t.strip())


def add_serve_args(ap: argparse.ArgumentParser) -> None:
    """Register every ServeOptions field as a flag with SUPPRESS defaults —
    the namespace carries ONLY flags the user explicitly typed, so they
    overlay cleanly on ``--options-in`` / fleet-spec values. The defaults
    are ServeOptions'."""
    S = argparse.SUPPRESS
    ap.add_argument("--arch", choices=list_archs(), default=S)
    ap.add_argument("--executor", choices=("torch", "sim"), default=S,
                    help="torch: the pipeline on the card; sim: the analytic "
                         "executor at N 16, tp 16, M 16 with LBCP plans")
    ap.add_argument("--scheduler", choices=("batch", "continuous"), default=S)
    ap.add_argument("--policy", choices=("fcfs", "sjf", "edf"), default=S,
                    help="continuous-mode admission order")
    ap.add_argument("--arrival-rate", type=float, default=S,
                    help="Poisson arrivals, requests/s (continuous only; 0: all at 0)")
    ap.add_argument("--slo-ms", type=float, default=S,
                    help="TTFT deadline: arrival + slo (continuous only)")
    ap.add_argument("--max-batch", type=int, default=S)
    ap.add_argument("--buckets", type=_csv_ints, default=S,
                    help="comma-separated bucket lengths (default: --seq; sim: "
                         + ",".join(map(str, SIM_BUCKETS)) + ")")
    ap.add_argument("--profile", default=S,
                    help="cost-model profile: " + ", ".join(sorted(PROFILES))
                         + " or a profile JSON path")
    ap.add_argument("--requests", type=int, default=S)
    ap.add_argument("--seq", type=int, default=S)
    ap.add_argument("--num-chunks", type=int, default=S)
    ap.add_argument("--num-stages", type=int, default=S)
    ap.add_argument("--tp", type=int, default=S,
                    help="tensor-parallel degree of each stage (torch executor: "
                         "the manual TP lowering over an emulated tp axis)")
    ap.add_argument("--tp-lowering", choices=("auto", "manual"), default=S,
                    help="auto resolves to manual: one card has no GSPMD")
    ap.add_argument("--remote-attn", choices=("qship", "fetch"), default=S)
    ap.add_argument("--attn-backend", choices=ATTN_BACKENDS, default=S)
    ap.add_argument("--pool-backend", choices=POOL_BACKENDS, default=S)
    ap.add_argument("--ssm-backend", choices=SSM_BACKENDS, default=S,
                    help="SSD inner loop of mamba2 / zamba2 layers")
    ap.add_argument("--kv-dtype", choices=("auto", "int8", "fp8"), default=S)
    ap.add_argument("--kv-offload", action="store_true", default=S,
                    help="plan the cold KV tier (kvstore.tiers) and print the "
                         "analytic tier summary")
    ap.add_argument("--prefix-cache", choices=("off", "on"), default=S,
                    help="radix prefix KV index (kvstore.prefix): admitted "
                         "requests whose leading chunks are already resident "
                         "lease only their novel suffix, and the torch "
                         "executor seeds their pools (continuous scheduler)")
    ap.add_argument("--prefix-min-pages", type=int, default=S,
                    help="ignore prefix hits smaller than this many pages")
    ap.add_argument("--shared-prefix", type=int, default=S,
                    help="the first this many tokens are the same in every "
                         "request (a shared system prompt)")
    ap.add_argument("--cells", type=int, default=S,
                    help="fleet mode: N serving cells behind the fleet router "
                         "(repro_torch.fleet); implies --scheduler continuous. "
                         "On one card the cells share it and run one after "
                         "another")
    ap.add_argument("--router", choices=ROUTER_POLICIES, default=S,
                    help="fleet placement policy: jsf = join-shortest-finish "
                         "(lease/cost-aware ETA), rr = round-robin, "
                         "least-loaded = smallest queue depth")
    ap.add_argument("--fleet-spec", default=S,
                    help="fleet-spec JSON: {\"router\": ..., \"cells\": "
                         "[per-cell ServeOptions overrides, ...]}: "
                         "heterogeneous cells (kv_dtype, buckets, "
                         "calibrated_profile, ...)")
    ap.add_argument("--trace-out", default=S,
                    help="write the merged Chrome trace here (arms the stage "
                         "telemetry; continuous scheduler); in fleet mode "
                         "each cell gets its own process rows")
    ap.add_argument("--metrics-out", default=S,
                    help="write the metrics here (.prom: Prometheus text; "
                         "else JSON lines; fleet mode: the fleet summary JSON)")
    ap.add_argument("--health", action="store_true", default=S,
                    help="arm the health sentinels and print their alerts")
    ap.add_argument("--calibrate", default=S, metavar="PATH",
                    help="measure the tick spans and write the cost model's "
                         "fitted profile JSON here (torch executor)")
    ap.add_argument("--calibrated-profile", default=S, metavar="PATH",
                    help="price admission with this profile JSON (overrides "
                         "--profile)")
    ap.add_argument("--profile-dir", default=S,
                    help="run under torch.profiler; its Chrome trace goes here")
    ap.add_argument("--smoke", action="store_true", default=S,
                    help="the small config")
    ap.add_argument("--device", default=S, help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=S)


def options_from_args(ns: argparse.Namespace,
                      base: Optional[ServeOptions] = None) -> ServeOptions:
    """Overlay the explicitly-typed flags (SUPPRESS leaves the rest out of
    the namespace) onto ``base`` (defaults or ``--options-in``)."""
    base = base or ServeOptions()
    known = {f.name for f in fields(ServeOptions)}
    explicit = {k: v for k, v in vars(ns).items() if k in known}
    return base.override(**explicit)


# --------------------------------------------------------------- fleet spec

@dataclass(frozen=True)
class FleetSpec:
    """Router policy + per-cell option overrides. ``cell_options(base)``
    materializes the per-cell ServeOptions list: base <- overrides[i]."""
    router: str = "jsf"
    cells: Tuple[Dict[str, Any], ...] = field(default_factory=tuple)

    @classmethod
    def from_json(cls, text: str) -> "FleetSpec":
        d = json.loads(text)
        unknown = sorted(set(d) - {"router", "cells"})
        if unknown:
            raise ValueError(f"unknown fleet-spec keys: {unknown}")
        return cls(router=d.get("router", "jsf"),
                   cells=tuple(d.get("cells", ())))

    def cell_options(self, base: ServeOptions) -> List[ServeOptions]:
        return [base.override(**dict(ov)) for ov in self.cells]


def resolve_fleet(opts: ServeOptions) -> Tuple[str, List[ServeOptions]]:
    """(router policy, per-cell options) from ``--fleet-spec`` (wins) or
    ``--cells N`` homogeneous replication."""
    if opts.fleet_spec:
        with open(opts.fleet_spec) as f:
            spec = FleetSpec.from_json(f.read())
        router = opts.router if opts.router != "jsf" else spec.router
        cells = spec.cell_options(opts)
        if not cells:
            raise ValueError(f"fleet spec {opts.fleet_spec} lists no cells")
        return router, cells
    return opts.router, [opts] * max(opts.cells, 1)
