"""One run of one cell: set-up, the measured window, its metrics, the check.

Set-up: the kernels' libraries (built into ``build/repro_torch/<hash>/``
inside the checkout by the first run there, loaded by every later one), the
weights made on the device from the seed in the port's flat layout and
staged with ``core.staging.stage_params`` (the flat copy is freed), the
engine (``PrefillEngine`` over ``TorchExecutor``, the cell's run settings,
``partition="uniform"``), then the warm-up waves of the cell's mix at the
window's shapes.

The window: the mix's loop (``traffic/<kind>.py``) over ``step()`` for
``seconds``; the peak of device memory is reset at its start. A traced run
(``trace``) wraps it in torch.profiler and arms the executor's telemetry
and tick spans; its metrics are the cell's per-layer ones, an untraced
run's its end-to-end ones.

Then the program's state is freed and the check runs the reference on a
sample of the completed requests (``harness/check.py``).
"""
from __future__ import annotations

import gc
import importlib
import math
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from portbench.harness import check as CK
from portbench.harness import trace as TR
from portbench.harness.layout import Cell, Layout
from portbench.harness.serve import Served, Server
from portbench.harness.weights import sub_seed

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
HOST_RANGES = ("portbench.", "prefill_wave")


@dataclass
class Run:
    """What the metric readers read."""
    cell: Cell
    conf: Dict[str, Any]
    seconds: float
    setup_s: float = math.nan
    window_s: float = math.nan
    attempted: int = 0
    served: List[Served] = field(default_factory=list)   # completed in the window
    waves: List[Dict[str, Any]] = field(default_factory=list)
    peak_bytes: int = 0
    traced: bool = False
    spans: Optional[list] = None                          # device spans (us)
    ranges: Optional[list] = None                         # host ranges (us)
    window_us: Optional[tuple] = None                     # the window on the trace's clock
    busy_s: Optional[float] = None


def forbidden_modules() -> List[str]:
    """Top-level names (before the first dot, compared whole) in sys.modules
    that no run may load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_program(cell: Cell, seed: int, device: torch.device):
    """(engine, executor, port config) of the cell, weights from ``seed``."""
    from repro_torch.configs import RunConfig
    from repro_torch.core import pipeline as pp
    from repro_torch.core.staging import stage_params
    from repro_torch.runtime.engine import EngineConfig, PrefillEngine, TorchExecutor
    if device.type == "cuda":
        from repro_torch.kernels import build
        build.build_all()
    fam = importlib.import_module(f"portbench.families.{cell.conf['family']}")
    cfg = fam.port_config(cell.conf)
    eng_spec = cell.spec["engine"]
    n, m, bucket = eng_spec["num_stages"], eng_spec["num_chunks"], eng_spec["bucket"]
    run = RunConfig(num_chunks=m, num_stages=n, **cell.spec["run"])
    flat = fam.port_params(cell.conf, seed, device)
    staged = stage_params(cfg, flat, pp.build_plan(cfg, n, bucket, run))
    del flat
    gc.collect()
    ex = TorchExecutor(cfg, staged, run, device=device)
    ec = EngineConfig(model=cfg, num_stages=n, tp=1, num_chunks=m,
                      max_batch=eng_spec["max_batch"], buckets=(bucket,),
                      partition=eng_spec["partition"], mbkr=run.mbkr,
                      kv_dtype=run.kv_dtype)
    return PrefillEngine(ec, ex), ex, cfg


def read_metrics(layout: Layout, entries: List[Dict[str, Any]], run: Run) -> Dict[str, dict]:
    """Each metric's reader on ``run``; one that finds nothing is left out."""
    out = {}
    for e in entries:
        v = layout.metric(e).read(run)
        if v is not None:
            out[e["name"]] = {"value": float(v), "unit": e["unit"]}
    return out


def run_cell(layout: Layout, name: str, seed: int, seconds: float, trace: bool, *,
             device: torch.device, t_start: float) -> Optional[Dict[str, Any]]:
    """One run; returns the result line's object, or None where no result
    may be printed (a forbidden module was loaded)."""
    cell = layout.cell(name)
    kind = layout.module("traffic", cell.mix["kind"])
    max_batch = cell.spec["engine"]["max_batch"]
    engine, ex, cfg = build_program(cell, seed, device)
    warm = Server(engine, cfg.vocab_size, sub_seed(seed, "warmup"))
    kind.warm(warm, cell.mix, max_batch)
    server = Server(engine, cfg.vocab_size, sub_seed(seed, "tokens"))
    _sync(device)
    run = Run(cell, cell.conf, seconds, traced=trace)
    n_before = len(ex.waves)
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        ex.collect_telemetry = True
        ex.collect_measured = True
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    server.open_window()
    run.setup_s = time.perf_counter() - t_start
    with torch.profiler.record_function("portbench.window"):
        run.attempted = kind.drive(server, cell.mix, seconds)
    _sync(device)
    run.window_s = server.now()
    if prof is not None:
        prof.__exit__(None, None, None)
    run.peak_bytes = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
    run.served = server.completed()
    run.waves = ex.waves[n_before:]
    if device.type == "cuda":
        log(f"card after the window (SM clock, its max, power, temperature): "
            f"{TR.card_clocks()}")
    if prof is not None:
        t0 = time.perf_counter()
        run.spans = TR.device_spans(prof)
        run.ranges = TR.host_ranges(prof, HOST_RANGES)
        win = [r for r in run.ranges if r[2] == "portbench.window"]
        run.window_us = (win[0][0], win[0][1]) if win else None
        if run.spans:
            run.busy_s = TR.busy_window(run.spans)[0]
        del prof
        log(f"trace read in {time.perf_counter() - t0:.2f} s: {len(run.spans)} device "
            f"activities, {len(run.ranges)} host ranges")
    entries = cell.per_layer if trace else cell.end_to_end
    metrics = read_metrics(layout, entries, run)
    failed = run.attempted - len(run.served) + sum(
        not np.isfinite(s.result).all() for s in run.served)
    result: Dict[str, Any] = {
        "attempted": run.attempted, "failed": int(failed), "metrics": metrics,
        "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda"
                   else "cpu",
                   "count": 1, "memory_peak_bytes": run.peak_bytes}}
    if trace:
        result["device"]["busy_s"] = run.busy_s
        result["device"]["window_s"] = run.window_s
        if run.spans and run.window_us:
            split, _ = TR.categorize(run.spans)
            gaps = TR.idle_gaps(run.spans, run.ranges, *run.window_us)
            result["breakdown"] = {
                "device_ops": [[k, v] for k, v in sorted(split.items(), key=lambda x: -x[1])][:10],
                "idle_gaps": [[k, v] for k, v in sorted(gaps.items(), key=lambda x: -x[1])][:10]}
    # the check: the program's state freed first, so the reference sets no peak
    prompts = dict(server.prompts)
    del engine, ex, server, warm
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ok, checks = check_served(cell, seed, run.served, prompts, device)
    result["correct"] = bool(ok and failed == 0 and run.served)
    result["checks"] = checks
    found = forbidden_modules()
    if found:
        log(f"portbench: modules loaded that no run may load: {found}")
        return None
    for k, c in checks.items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    order = ["correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"]
    return {k: result[k] for k in order if k in result}


def check_served(cell: Cell, seed: int, served: List[Served], prompts: Dict[int, np.ndarray],
                 device: torch.device):
    """(within every limit, the checks) of a sample of ``served``."""
    ck = cell.spec["check"]
    picked = CK.sample(served, ck["sample"], seed)
    if not picked:
        return CK.judge({k: math.nan for k in ck["limits"]}, ck["limits"])
    ref = importlib.import_module(f"portbench.reference.{cell.conf['family']}")
    t0 = time.perf_counter()
    want = ref.next_token_logits(cell.conf, seed, [prompts[s.rid] for s in picked], device)
    v = cell.conf["vocab_size"]
    got = np.stack([s.result[:v] for s in picked])
    log(f"reference over {len(picked)} request(s) in {time.perf_counter() - t0:.2f} s")
    return CK.judge(CK.numbers(got, want), ck["limits"])
