"""Serve prefill requests through the port (mirrors the jax-executor path
of ``repro.launch.serve``).

    python -m repro_torch.launch.serve --arch qwen3-8b --requests 4 \\
        --seq 4096 --num-chunks 8 --num-stages 8 --remote-attn qship \\
        --attn-backend cuda --pool-backend paged --kv-dtype auto
    python -m repro_torch.launch.serve --arch zamba2-7b --ssm-backend cuda
    python -m repro_torch.launch.serve --arch mamba2-130m   # attention-free

runs on the card (``--device cpu`` for the CPU; ``--smoke`` for the small
config). Weights are random, drawn from ``--seed`` straight into the
stage-stacked layout. Prints each request's argmax token and the wave wall
times.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch import device as devices
from repro_torch.configs.base import (ATTN_BACKENDS, POOL_BACKENDS,
                                      SSM_BACKENDS, RunConfig, get_config,
                                      get_smoke_config, list_archs)
from repro_torch.core import pipeline as pp
from repro_torch.core.staging import init_staged
from repro_torch.runtime.engine import (EngineConfig, PrefillEngine, Request,
                                        TorchExecutor)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=list_archs(), default="qwen3-8b")
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
    ec = EngineConfig(model=cfg, num_stages=args.num_stages,
                      num_chunks=args.num_chunks, buckets=(args.seq,))
    return cfg, PrefillEngine(ec, executor), executor


def make_requests(n: int, seq: int, vocab: int, seed: int) -> List[Request]:
    rng = np.random.default_rng(seed)
    return [Request(rid=i, arrival=0.0, seq_len=seq,
                    tokens=rng.integers(0, vocab, size=seq).astype(np.int64))
            for i in range(n)]


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    cfg, eng, ex = build(args)
    for r in make_requests(args.requests, args.seq, cfg.vocab_size, args.seed):
        eng.submit(r)
    eng.run_until_drained()
    for r in sorted(eng.done, key=lambda r: r.rid):
        print(f"request {r.rid}: argmax {int(np.argmax(r.result))}")
    print("wave wall s: " + " ".join(f"{w['dur']:.4f}" for w in ex.waves))
    print(f"[serve] {args.arch} device={ex.device} remote={args.remote_attn} "
          f"attn={args.attn_backend} pool={args.pool_backend} ssm={args.ssm_backend} "
          f"kv={args.kv_dtype} metrics={eng.metrics()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
