"""Serve prefill requests through the port (mirrors ``repro.launch.serve``).

    python -m repro_torch.launch.serve --arch qwen3-8b --requests 4 \\
        --seq 4096 --num-chunks 8 --num-stages 8 --remote-attn qship \\
        --attn-backend cuda --pool-backend paged --kv-dtype auto
    python -m repro_torch.launch.serve --arch zamba2-7b --ssm-backend cuda
    python -m repro_torch.launch.serve --arch mamba2-130m   # attention-free

runs on the card (``--device cpu`` for the CPU; ``--smoke`` for the small
config). ``--tp 2`` splits each stage's layers over an emulated tp axis of
2 shards (the reference's manual TP lowering: sharded heads and FFN,
explicit psums charged to the ledger's ``tp`` key):

    python -m repro_torch.launch.serve --tp 2 --requests 4 Weights are random, drawn from ``--seed`` straight into the
stage-stacked layout. Prints each request's argmax token and the wave wall
times.

Continuous chunk-level scheduling (``sched.ChunkScheduler``: policy-ordered,
KV-lease gated admission, Poisson arrivals, SLO deadlines):

    python -m repro_torch.launch.serve --scheduler continuous --policy edf \\
        --arrival-rate 4 --slo-ms 3000 --max-batch 2

On the torch executor the scheduler's clock (TTFT, makespan) is the
analytic cost model's under ``--profile``, and is printed under that name;
beside it the measured wave wall times and each request's measured
completion (the end of its wave, from the first wave's start).

``--executor sim`` serves on the analytic executor at the reference's
production geometry (N 16, tp 16, M 16, LBCP partitions; no card needed):

    python -m repro_torch.launch.serve --executor sim --scheduler continuous \\
        --policy edf --arrival-rate 4 --slo-ms 3000 --requests 12 --seq 30000

``--prefix-cache on`` (continuous scheduler) arms cross-request prefix KV
reuse (``kvstore.prefix``): the radix index prices a resident prefix with a
suffix-only lease, and the torch executor seeds each wave whose requests
share a cached prefix from pool snapshots; ``prefix_stats()`` is printed
after the run. ``--kv-offload`` prints the analytic hot / warm / cold page
placement of the largest bucket (``kvstore.tiers.plan_tiers``) under the
cost-model profile, with the reference's TPU host-link rate.

Observability (``repro_torch.obs``):

    python -m repro_torch.launch.serve --scheduler continuous \
        --trace-out build/trace.json --metrics-out build/metrics.prom \
        --health --calibrate build/cal.json

Every flag maps to a ``launch.options.ServeOptions`` field:
``--options-out PATH`` writes the resolved options JSON, ``--options-in
PATH`` replays one, and the flags typed act as overrides on top of it.
The engine is driven only through the ``CellHandle`` protocol, which lets
the same loop run one cell or a fleet.

Multi-cell fleet (``repro_torch.fleet``): one shared arrival stream routed
over N cells, ``--cells N`` copies of the options or ``--fleet-spec
spec.json`` with per-cell overrides (kv_dtype, buckets, a calibrated
profile, ...), ``--router`` jsf | rr | least-loaded; each request's cell
and argmax, the fleet roll-up and, with ``--trace-out``, one trace with
each cell's own process rows. On one card the cells share it and their
waves run one after another:

    python -m repro_torch.launch.serve --scheduler continuous --policy edf \
        --cells 2 --router jsf --arrival-rate 2 --slo-ms 4000 --max-batch 2 \
        --requests 8 --fleet-spec spec.json --options-out opts.json

``--trace-out`` arms the stage telemetry and writes one Chrome trace
(scheduler tasks, lease and wire counters, engine waves and ticks,
``kv_resident_bytes`` tracks, measured spans, health alerts; continuous
scheduler); ``--metrics-out`` writes the metrics as JSON lines, or as a
Prometheus text file for a ``.prom`` path; ``--health`` arms the
non-finite and SLO burn-rate sentinels and prints their alerts, and the
occupancy-drift sentinel too when ``--trace-out`` arms the telemetry it
reads (as in the reference's serve); ``--calibrate PATH`` measures the tick spans of every wave (CUDA
events on the card) and fits the cost model's effective rates to the last
wave's, from ``--profile``, into a profile JSON: an effective profile of N
stages on one card (``obs.calibrate``); ``--calibrated-profile PATH``
prices admission with such a profile; ``--profile-dir DIR`` runs the
serving loop under ``torch.profiler`` and writes its Chrome trace there.
"""
from __future__ import annotations

import argparse
import math
import os
import sys
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch import device as devices
from repro_torch.configs.base import RunConfig, get_config, get_smoke_config
from repro_torch.core import costmodel as cm
from repro_torch.core import pipeline as pp
from repro_torch.core.staging import (TPLayout, init_staged, manual_tp_plan,
                                      shard_params)
from repro_torch.launch.options import (SIM_BUCKETS, ServeOptions, add_serve_args,
                                        options_from_args, resolve_fleet)
from repro_torch.runtime.engine import (ContinuousEngine, EngineConfig,
                                        PrefillEngine, Request, SimExecutor,
                                        TorchExecutor)
from repro_torch.sched import poisson_arrivals

# the reference's host<->device staging rate for the cold tier (B/s): an
# assumption it made for a TPU host link (``repro.launch.serve.H2D_BW``),
# carried as reference data; it is not the H100's link
REF_TPU_H2D_BW = 16e9


def parse_args(argv: Optional[Sequence[str]] = None) -> ServeOptions:
    """The run's ``ServeOptions``: defaults <- ``--options-in`` <- the flags
    typed (``launch.options``); ``--options-out`` writes the result."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_serve_args(ap)
    ap.add_argument("--options-in", default=None,
                    help="load a ServeOptions JSON (written by --options-out); "
                         "the flags typed override it")
    ap.add_argument("--options-out", default=None,
                    help="write the resolved options JSON here (replayable "
                         "with --options-in), then run")
    ns = ap.parse_args(argv)
    base = ServeOptions()
    if ns.options_in:
        with open(ns.options_in) as f:
            base = ServeOptions.from_json(f.read())
    opts = options_from_args(ns, base)
    if ns.options_out:
        from repro_torch.obs._io import atomic_write_text
        print(f"options -> {atomic_write_text(ns.options_out, opts.to_json())}")
    return opts


def build(args: ServeOptions):
    """(cfg, engine, executor) for one serving cell."""
    hw = cm.resolve_profile(args.calibrated_profile or args.profile)
    if args.calibrated_profile:
        print(f"[profile] {args.calibrated_profile} -> {hw.name} "
              f"(gemm_eff={hw.gemm_eff:.3f} attn_eff={hw.attn_eff:.3f})")
    slo = args.slo_ms / 1e3 if args.slo_ms else None
    knobs = dict(max_batch=args.max_batch, kv_dtype=args.kv_dtype,
                 policy=args.policy, slo=slo, hw=hw, prefix_cache=args.prefix_cache,
                 prefix_min_pages=args.prefix_min_pages,
                 trace=args.trace_out is not None)
    if args.executor == "sim":
        cfg = get_config(args.arch)
        ec = EngineConfig(model=cfg, num_stages=16, tp=16, num_chunks=16,
                          buckets=args.buckets or SIM_BUCKETS,
                          partition="lbcp", **knobs)
        executor = SimExecutor(cfg, hw)
    else:
        dev = devices.resolve(args.device)
        cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
        run = RunConfig(num_chunks=args.num_chunks, num_stages=args.num_stages,
                        remote_attn=args.remote_attn,
                        attn_backend=args.attn_backend,
                        pool_backend=args.pool_backend,
                        ssm_backend=args.ssm_backend, kv_dtype=args.kv_dtype,
                        tp_lowering=args.tp_lowering)
        plan = pp.build_plan(cfg, args.num_stages, args.seq, run)
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        layout = TPLayout(args.tp)
        mtp = manual_tp_plan(cfg, plan, layout)
        staged = shard_params(cfg, init_staged(cfg, plan, gen, device=dev), mtp)
        if mtp is not None:
            print(f"[transport] {plan.tp_lowering} TP lowering (tp={args.tp}, attn "
                  f"{mtp.attn}, kv_div {mtp.kv_div}, ffn {mtp.ffn}, moe_ffn "
                  f"{mtp.moe_ffn}, shared_moe {mtp.shared_moe})")
        executor = TorchExecutor(cfg, staged, run, device=dev, layout=layout)
        ec = EngineConfig(model=cfg, num_stages=args.num_stages, tp=args.tp,
                          num_chunks=args.num_chunks,
                          buckets=args.buckets or (args.seq,),
                          partition="uniform", **knobs)
    engine = (ContinuousEngine if args.scheduler == "continuous"
              else PrefillEngine)(ec, executor)
    return cfg, engine, executor


def print_tier_summary(cfg, ec: EngineConfig) -> None:
    """``--kv-offload``: plan the hot / warm / cold page placement for the
    engine's largest bucket and print it (``kvstore.tiers``; analytic
    prefetch scheduled off the same chunk-cost vectors the scheduler uses).
    The budget and tick times are the cost-model profile's and the link
    rate is the reference's TPU assumption, so the line is analytic, under
    the profile's name: no number in it is the card's."""
    from repro_torch.core import mbkr
    from repro_torch.kvstore import pages as kvp
    from repro_torch.kvstore import quant as kvq
    from repro_torch.kvstore import tiers as kvt
    m, n = ec.num_chunks, ec.num_stages
    bucket = max(ec.buckets)
    c = -(-bucket // m)
    mplan = mbkr.plan(m, n, mbkr=ec.mbkr and not cfg.attn_free)
    geom = kvp.page_geometry(c, mplan.num_slots, ec.kv_page_tokens)
    tbl = kvp.build_slot_pages(geom)
    codec = kvq.get_codec(ec.kv_dtype, cfg.dtype)
    sm = cm.StageModel.build(cfg, n, ec.tp)
    dur, _, _, _, _ = cm.chunk_cost_arrays(sm, [c] * m, ec.hw, mbkr_plan=mplan)
    # per-STAGE budget: tp chips' memory minus the stage's weight slice
    tp = max(ec.tp, 1)
    hot = max(ec.hw.hbm_cap * tp - cfg.param_count() * 2 / n, 0.0) * 0.5
    host_slots = (np.unique(np.concatenate(
        [mplan.host_slot_a[mplan.p2:], mplan.host_slot_b[mplan.p2:]]))
        if mplan.p2 < m else None)
    plan = kvt.plan_tiers(
        geom, codec, tbl, mplan.own_slot, mplan.p2, m,
        kvt.TierSpec(hot_bytes=hot, cold_bw=REF_TPU_H2D_BW),
        lps=sm.attn_layers, b=1, kvh=cfg.num_kv_heads,
        hd=cfg.resolved_head_dim, tick_s=dur, host_slots=host_slots)
    s = plan.summary()
    print(f"[kv-offload] analytic ({ec.hw.name}; cold link REF_TPU_H2D_BW, the "
          f"reference's TPU host-link assumption): bucket {bucket} "
          f"kv_dtype={codec.name} page_tokens={geom.page_tokens}: pages {s['pages']} | "
          f"hot {s['hot_bytes']/1e9:.2f} GB | warm {s['warm_bytes']/1e9:.2f} GB"
          f" | cold {s['cold_bytes']/1e9:.2f} GB | "
          f"prefetch ops {s['prefetch_ops']} "
          f"(peak {s['worst_tick_bw']/1e9:.2f} GB/s vs {REF_TPU_H2D_BW/1e9:.0f}) | "
          f"{'FEASIBLE' if s['feasible'] else 'INFEASIBLE'}")


def make_requests(n: int, seq: int, vocab: int, seed: int, *,
                  arrival_rate: float = 0.0, tokens: bool = True,
                  shared_prefix: int = 0) -> List[Request]:
    """``n`` requests of ``seq`` random tokens from ``seed``, arriving as a
    Poisson stream at ``arrival_rate`` (0: all at time 0); ``tokens=False``
    leaves the tokens out (the analytic executor needs none). The first
    ``shared_prefix`` tokens of every request are one common draw (from
    ``seed + 1``)."""
    arrivals = poisson_arrivals(arrival_rate, n, seed=seed)
    rng = np.random.default_rng(seed)
    common = np.random.default_rng(seed + 1).integers(0, vocab, size=shared_prefix)
    out = []
    for i in range(n):
        toks = None
        if tokens:
            toks = rng.integers(0, vocab, size=seq).astype(np.int64)
            toks[:shared_prefix] = common
        out.append(Request(rid=i, arrival=float(arrivals[i]), seq_len=seq, tokens=toks))
    return out


def measured_completions(waves) -> dict:
    """rid -> the end of its wave, in seconds since the first wave's start
    (the measured counterpart of the scheduler's finish time)."""
    if not waves:
        return {}
    t0 = waves[0]["start"]
    return {rid: w["start"] + w["dur"] - t0 for w in waves for rid in w["rids"]}


def arm_obs(args: ServeOptions, eng):
    """Arm the engine's executor for the observability flags; returns the
    health monitor (or None)."""
    if args.trace_out:
        eng.configure_obs(telemetry=True)
    monitor = None
    if args.health:
        from repro_torch.obs.health import HealthMonitor
        monitor = HealthMonitor()
        eng.configure_obs(health=monitor)
    if args.calibrate:
        if args.executor == "torch":
            eng.configure_obs(measured=True)
        else:
            print("note: --calibrate measures the torch executor; the sim "
                  "executor IS the analytic model: skipping")
    return monitor


def run_profiled(eng, profile_dir: str, device) -> None:
    """``eng.run_until_drained()`` under torch.profiler (the card's
    activity too when it runs there); the Chrome trace goes to
    ``profile_dir/serve_trace.json``."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        eng.run_until_drained()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "serve_trace.json")
    prof.export_chrome_trace(path)
    print(f"torch profile -> {path}")


def calibrate(args: ServeOptions, cfg, eng, ex) -> None:
    """Fit the cost model's effective rates (from the engine's profile) to
    the last measured wave's tick spans (the earlier waves hold the
    kernels' first build) and save the profile to ``args.calibrate``. A
    port tick runs all N stages on one card, so the fit is an effective
    "N stages on one card" profile, saved as such (``meta``)."""
    from repro_torch.core import mbkr
    from repro_torch.obs import calibrate as cal
    meas = eng.measured_waves()
    if not meas:
        print("note: no measured waves; nothing to calibrate")
        return
    w = meas[-1]
    ec = eng.ec
    sm = cm.StageModel.build(cfg, w["num_stages"], ec.tp)
    mplan = (mbkr.plan(len(w["chunks"]), w["num_stages"])
             if not cfg.attn_free else None)
    fit = cal.fit_profile(sm, w["chunks"], w["measured"], ec.hw, mbkr_plan=mplan)
    dev = ex.device
    cal.save_profile(args.calibrate, fit.profile, fit=fit, meta={
        "arch": args.arch, "seq": args.seq, "source": "repro_torch.launch.serve",
        "num_stages": w["num_stages"], "one_card": True, "device": str(dev),
        "device_name": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                        else "cpu")})
    print(f"[calibrate] {ec.hw.name} -> {fit.profile.name} (N={w['num_stages']} "
          f"stages on one {dev.type} device): span MAPE {fit.mape_nominal:.3f} -> "
          f"{fit.mape_calibrated:.3f} over {len(fit.rows)} spans -> {args.calibrate}")


def export_obs(args: ServeOptions, eng, m: dict, wall: float, monitor) -> None:
    """``--trace-out`` / ``--metrics-out``: the continuous engine exports
    both (``export_obs``); the batch engine exports the metrics only."""
    if args.scheduler == "continuous":
        if args.trace_out or args.metrics_out:
            paths = eng.export_obs(trace_out=args.trace_out,
                                   metrics_out=args.metrics_out,
                                   extra={"wall_seconds": wall})
            for kind, path in paths.items():
                print(f"{kind} -> {path}")
        return
    if args.trace_out:
        print("note: --trace-out needs --scheduler continuous; skipping")
    if args.metrics_out:
        from repro_torch.obs.metrics import export_engine_metrics
        path = export_engine_metrics(args.metrics_out, m,
                                     extra={"wall_seconds": wall}, health=monitor)
        print(f"metrics -> {path}")


def report_health(monitor, records, slo: Optional[float]) -> None:
    """Fold the TTFT SLO burn into ``monitor`` (where an SLO is set) and
    print its alert summary."""
    if slo is not None:
        from repro_torch.obs.metrics import Histogram
        h = Histogram("ttft")
        for rec in records:
            if math.isfinite(rec.finish):
                h.observe(rec.finish - rec.arrival)
        monitor.check_slo(h, slo)
    sm = monitor.summary()
    burn = f" | burn {sm['burn_rate']:.2f}x" if sm["burn_rate"] is not None else ""
    print(f"[health] alerts {sm['alerts_total']} {sm['by_kind']}{burn}")


def run_fleet(opts: ServeOptions) -> int:
    """N cells behind the fleet router (mirrors the reference's
    ``_run_fleet``): one shared arrival stream, each cell's engine and
    executor built from its own options (``--fleet-spec`` overrides, or
    ``--cells N`` copies; weights from each cell's seed), roll-up metrics
    and ONE merged trace with per-cell process rows. Cells are driven only
    through the ``CellHandle`` protocol. The torch cells share the one
    device and their waves run one after another."""
    from repro_torch.fleet import FleetFabric, FleetRouter
    router_policy, cell_opts = resolve_fleet(opts)
    if any(co.scheduler != "continuous" for co in cell_opts):
        print("note: fleet cells require --scheduler continuous; overriding")
        cell_opts = [co.override(scheduler="continuous") for co in cell_opts]
    cells, vocab = {}, 0
    for i, co in enumerate(cell_opts):
        cfg, eng, _ = build(co)
        cells[f"cell{i}"] = eng
        vocab = cfg.vocab_size
    if opts.executor == "torch" and len(cells) > 1:
        print(f"note: {len(cells)} cells share one {devices.resolve(opts.device)} "
              f"device (replicated-cell mode, serialized execution)")
    fab = FleetFabric(cells, FleetRouter(router_policy))
    monitor = None
    if opts.health:
        from repro_torch.obs.health import HealthMonitor
        monitor = HealthMonitor()
        fab.configure_obs(health=monitor)
    if opts.trace_out:
        fab.configure_obs(telemetry=True)
    t0 = time.perf_counter()
    for req in make_requests(opts.requests, opts.seq, vocab, opts.seed,
                             arrival_rate=opts.arrival_rate,
                             tokens=opts.executor == "torch",
                             shared_prefix=opts.shared_prefix):
        fab.submit(req)
    fab.pump()
    wall = time.perf_counter() - t0

    m = fab.metrics()
    slo_txt = f" | SLO {m['slo_met']}/{m['slo_total']}" if m["slo_total"] else ""
    hw = sorted({co.calibrated_profile or co.profile for co in cell_opts})
    print(f"[fleet {router_policy} x{m['cells']}] completed {m['completed']} "
          f"(rejected {m['rejected']}) in {wall:.2f} s wall | analytic "
          f"({', '.join(hw)}): makespan {m['makespan']:.3f} s, avg TTFT "
          f"{m['avg_ttft']:.3f} s, p99 {m['p99_ttft']:.3f} s, "
          f"{m['throughput']:.3f} req/s{slo_txt}")
    for name, pc in m["per_cell"].items():
        print(f"  {name}: {pc['completed']} done (rejected {pc['rejected']}) | "
              f"p99 {pc['p99_ttft']:.3f} s")
    if opts.executor == "torch":
        for r in sorted(fab.completed, key=lambda r: r.rid):
            print(f"request {r.rid}: cell {fab.placements[r.rid]}, argmax "
                  f"{int(np.argmax(r.result))}")
    if monitor is not None:
        slo = opts.slo_ms / 1e3 if opts.slo_ms else None
        report_health(monitor, [rec for c in cells.values() for rec in c.records()], slo)
    if opts.trace_out or opts.metrics_out:
        paths = fab.export_obs(trace_out=opts.trace_out, metrics_out=opts.metrics_out)
        for kind, path in paths.items():
            print(f"{kind} -> {path}")
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    if args.cells > 1 or args.fleet_spec:
        return run_fleet(args)
    if args.scheduler == "batch" and args.arrival_rate > 0:
        # the batch engine admits everything at clock 0, so staggered
        # arrivals would give negative latencies there
        print("note: --arrival-rate requires --scheduler continuous; running "
              "the batch engine as a closed loop (arrivals at t=0)")
        args = args.override(arrival_rate=0.0)
    if args.prefix_cache == "on" and args.scheduler != "continuous":
        print("note: --prefix-cache on needs --scheduler continuous; the batch "
              "engine serves without it")
    cfg, eng, ex = build(args)
    if args.kv_offload:
        print_tier_summary(cfg, eng.ec)
    monitor = arm_obs(args, eng)
    for r in make_requests(args.requests, args.seq, cfg.vocab_size, args.seed,
                           arrival_rate=args.arrival_rate,
                           tokens=args.executor == "torch",
                           shared_prefix=args.shared_prefix):
        eng.submit(r)
    t0 = time.perf_counter()
    if args.profile_dir:
        run_profiled(eng, args.profile_dir, getattr(ex, "device", None))
    else:
        eng.run_until_drained()
    wall = time.perf_counter() - t0
    polled = eng.poll()                 # admission order
    finished = sorted(polled, key=lambda r: r.rid)
    if args.calibrate and args.executor == "torch":
        calibrate(args, cfg, eng, ex)
    m = eng.metrics()
    hw = eng.ec.hw.name
    if args.executor == "torch":
        done = measured_completions(ex.waves)
        for r in finished:
            print(f"request {r.rid}: argmax {int(np.argmax(r.result))}, measured "
                  f"completion {done[r.rid]:.4f} s")
        print("wave wall s: " + " ".join(f"{w['dur']:.4f}" for w in ex.waves))
    if args.scheduler == "continuous":
        slo_txt = (f" | SLO {m['slo_met']}/{m['slo_total']}" if m["slo_total"] else "")
        print(f"[{args.policy}] completed {m['completed']} (rejected "
              f"{m['rejected']}) in {wall:.2f} s wall | analytic ({hw}): sched "
              f"clock {m['makespan']:.3f} s, avg TTFT {m['avg_ttft']:.3f} s, p99 "
              f"{m['p99_ttft']:.3f} s, avg queue {m['avg_queue_wait']:.3f} s, "
              f"{m['throughput']:.3f} req/s, bubble {m['bubble_frac'] * 100:.1f}%"
              f"{slo_txt}")
        print("admission order: " + " ".join(str(r.rid) for r in polled))
        if args.prefix_cache == "on":
            print(f"[prefix] {eng.prefix_stats()}")
            if args.executor == "torch":
                print("[prefix] seeded chunks per wave: "
                      + " ".join(str(w["prefix_chunks"]) for w in ex.waves))
    else:
        print(f"completed {m['completed']} requests in {wall:.2f} s wall | engine "
              f"clock ({'measured' if args.executor == 'torch' else 'analytic, ' + hw}) "
              f"{eng.clock:.3f} s | avg E2E {m['avg_e2e']:.3f} s | p99 "
              f"{m['p99_e2e']:.3f} s | {m['throughput']:.3f} req/s | stages "
              f"{m['num_stages']}")
    if monitor is not None:
        continuous = args.scheduler == "continuous"
        report_health(monitor, eng.records() if continuous else [],
                      eng.slo if continuous else None)
    export_obs(args, eng, m, wall, monitor)
    if args.executor == "torch":
        print(f"[serve] {args.arch} device={ex.device} remote={args.remote_attn} "
              f"attn={args.attn_backend} pool={args.pool_backend} "
              f"ssm={args.ssm_backend} kv={args.kv_dtype} scheduler={args.scheduler}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
