"""Serve prefill requests through the port (mirrors ``repro.launch.serve``).

    python -m repro_torch.launch.serve --arch qwen3-8b --requests 4 \\
        --seq 4096 --num-chunks 8 --num-stages 8 --remote-attn qship \\
        --attn-backend cuda --pool-backend paged --kv-dtype auto
    python -m repro_torch.launch.serve --arch zamba2-7b --ssm-backend cuda
    python -m repro_torch.launch.serve --arch mamba2-130m   # attention-free

runs on the card (``--device cpu`` for the CPU; ``--smoke`` for the small
config). Weights are random, drawn from ``--seed`` straight into the
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
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch import device as devices
from repro_torch.configs.base import (ATTN_BACKENDS, POOL_BACKENDS,
                                      SSM_BACKENDS, RunConfig, get_config,
                                      get_smoke_config, list_archs)
from repro_torch.core import costmodel as cm
from repro_torch.core import pipeline as pp
from repro_torch.core.staging import init_staged
from repro_torch.runtime.engine import (ContinuousEngine, EngineConfig,
                                        PrefillEngine, Request, SimExecutor,
                                        TorchExecutor)
from repro_torch.sched import poisson_arrivals

SIM_BUCKETS = (8192, 32768, 131072)


def _csv_ints(text: str):
    return tuple(int(x) for x in text.split(",") if x)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=list_archs(), default="qwen3-8b")
    ap.add_argument("--executor", choices=("torch", "sim"), default="torch",
                    help="torch: the pipeline on the card; sim: the analytic "
                         "executor at N 16, tp 16, M 16 with LBCP plans")
    ap.add_argument("--scheduler", choices=("batch", "continuous"), default="batch")
    ap.add_argument("--policy", choices=("fcfs", "sjf", "edf"), default="fcfs",
                    help="continuous-mode admission order")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="Poisson arrivals, requests/s (continuous only; 0: all at 0)")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="TTFT deadline: arrival + slo (continuous only)")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--buckets", type=_csv_ints, default=None,
                    help="comma-separated bucket lengths (default: --seq; sim: "
                         + ",".join(map(str, SIM_BUCKETS)) + ")")
    ap.add_argument("--profile", default="tpu-v5e",
                    help="cost-model profile: " + ", ".join(sorted(cm.PROFILES))
                         + " or a profile JSON path")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--num-chunks", type=int, default=8)
    ap.add_argument("--num-stages", type=int, default=8)
    ap.add_argument("--remote-attn", choices=("qship", "fetch"), default="qship")
    ap.add_argument("--attn-backend", choices=ATTN_BACKENDS, default="cuda")
    ap.add_argument("--pool-backend", choices=POOL_BACKENDS, default="auto")
    ap.add_argument("--ssm-backend", choices=SSM_BACKENDS, default="cuda",
                    help="SSD inner loop of mamba2 / zamba2 layers")
    ap.add_argument("--kv-dtype", choices=("auto", "int8", "fp8"), default="auto")
    ap.add_argument("--smoke", action="store_true", help="the small config")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def build(args: argparse.Namespace):
    """(cfg, engine, executor) for one serving cell."""
    hw = cm.resolve_profile(args.profile)
    slo = args.slo_ms / 1e3 if args.slo_ms else None
    knobs = dict(max_batch=args.max_batch, kv_dtype=args.kv_dtype,
                 policy=args.policy, slo=slo, hw=hw)
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
                        ssm_backend=args.ssm_backend, kv_dtype=args.kv_dtype)
        plan = pp.build_plan(cfg, args.num_stages, args.seq, run)
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        staged = init_staged(cfg, plan, gen, device=dev)
        executor = TorchExecutor(cfg, staged, run, device=dev)
        ec = EngineConfig(model=cfg, num_stages=args.num_stages, tp=1,
                          num_chunks=args.num_chunks,
                          buckets=args.buckets or (args.seq,),
                          partition="uniform", **knobs)
    engine = (ContinuousEngine if args.scheduler == "continuous"
              else PrefillEngine)(ec, executor)
    return cfg, engine, executor


def make_requests(n: int, seq: int, vocab: int, seed: int, *,
                  arrival_rate: float = 0.0, tokens: bool = True) -> List[Request]:
    """``n`` requests of ``seq`` random tokens from ``seed``, arriving as a
    Poisson stream at ``arrival_rate`` (0: all at time 0); ``tokens=False``
    leaves the tokens out (the analytic executor needs none)."""
    arrivals = poisson_arrivals(arrival_rate, n, seed=seed)
    rng = np.random.default_rng(seed)
    return [Request(rid=i, arrival=float(arrivals[i]), seq_len=seq,
                    tokens=(rng.integers(0, vocab, size=seq).astype(np.int64)
                            if tokens else None))
            for i in range(n)]


def measured_completions(waves) -> dict:
    """rid -> the end of its wave, in seconds since the first wave's start
    (the measured counterpart of the scheduler's finish time)."""
    if not waves:
        return {}
    t0 = waves[0]["start"]
    return {rid: w["start"] + w["dur"] - t0 for w in waves for rid in w["rids"]}


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    if args.scheduler == "batch" and args.arrival_rate > 0:
        # the batch engine admits everything at clock 0, so staggered
        # arrivals would give negative latencies there
        print("note: --arrival-rate requires --scheduler continuous; running "
              "the batch engine as a closed loop (arrivals at t=0)")
        args.arrival_rate = 0.0
    cfg, eng, ex = build(args)
    for r in make_requests(args.requests, args.seq, cfg.vocab_size, args.seed,
                           arrival_rate=args.arrival_rate,
                           tokens=args.executor == "torch"):
        eng.submit(r)
    t0 = time.perf_counter()
    eng.run_until_drained()
    wall = time.perf_counter() - t0
    finished = sorted(eng.poll(), key=lambda r: r.rid)
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
        print("admission order: " + " ".join(str(r.rid) for r in eng.done))
    else:
        print(f"completed {m['completed']} requests in {wall:.2f} s wall | engine "
              f"clock ({'measured' if args.executor == 'torch' else 'analytic, ' + hw}) "
              f"{eng.clock:.3f} s | avg E2E {m['avg_e2e']:.3f} s | p99 "
              f"{m['p99_e2e']:.3f} s | {m['throughput']:.3f} req/s | stages "
              f"{m['num_stages']}")
    if args.executor == "torch":
        print(f"[serve] {args.arch} device={ex.device} remote={args.remote_attn} "
              f"attn={args.attn_backend} pool={args.pool_backend} "
              f"ssm={args.ssm_backend} kv={args.kv_dtype} scheduler={args.scheduler}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
