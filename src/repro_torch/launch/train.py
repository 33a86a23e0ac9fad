"""End-to-end training driver (mirrors ``repro.launch.train``).

Runs on the card unless ``--device cpu``. Supports every --arch via its
smoke/full config, checkpoints atomically, and resumes bit-exact on the
CPU (params, optimizer, data stream; on the card the embedding and gather
backwards add with atomics, so a resumed run agrees to rounding).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b --steps 200 \\
      --preset 100m --ckpt-dir build/run1 [--resume]
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --preset smoke \\
      --steps 20 --batch 4 --seq 64

``--metrics-out PATH`` also writes every step's loss, grad norm and LR
(JSON lines, full precision) to PATH.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.configs.base import get_config, get_smoke_config, replace
from repro_torch.data import SyntheticLM
from repro_torch.models.api import build_model
from repro_torch.runtime.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.train import AdamWConfig, init_train_state, make_train_step


def preset_config(arch: str, preset: str):
    if preset == "full":
        return get_config(arch)
    if preset == "smoke":
        return get_smoke_config(arch)
    # ~100M-class: scale the family's smoke config up
    cfg = get_smoke_config(arch)
    return replace(cfg, num_layers=max(cfg.num_layers, 8), d_model=512,
                   num_heads=8, num_kv_heads=max(cfg.num_kv_heads // max(cfg.num_heads, 1) * 8, 4),
                   d_ff=2048, head_dim=64, vocab_size=32768)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--preset", default="100m", choices=("smoke", "100m", "full"))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (default: the card; raises without one) or cpu")
    ap.add_argument("--metrics-out", default=None,
                    help="write each step's loss, grad norm and LR here (JSON lines)")
    args = ap.parse_args(argv)

    dev = device_mod.resolve(args.device)
    cfg = preset_config(args.arch, args.preset)
    model = build_model(cfg)
    n_params = cfg.param_count()
    print(f"arch={args.arch} preset={args.preset} params~{n_params/1e6:.1f}M "
          f"device={dev}")

    opt = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                      total_steps=args.steps)
    step_fn = make_train_step(model, opt, grad_accum=args.grad_accum)
    data = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=args.seed)

    start = 0
    if args.resume and args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        state, extra = restore_checkpoint(args.ckpt_dir, device=dev)
        data.restore(extra["data"])
        start = int(extra["step"])
        print(f"resumed from step {start}")
    else:
        state = init_train_state(model, torch.Generator(device=dev).manual_seed(args.seed),
                                 device=dev)

    embeds = None
    if cfg.frontend.kind in ("vision_stub", "audio_stub") or cfg.family == "encdec":
        nf = min(cfg.frontend.num_embeds or 16, 32)
        embeds = torch.from_numpy(
            np.random.default_rng(0).normal(0, 0.02, (args.batch, nf, cfg.d_model))
        ).float().to(dev)

    metrics_out = open(args.metrics_out, "a") if args.metrics_out else None
    t0 = time.time()
    for step in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in data.next_batch().items()}
        if embeds is not None:
            batch["embeds"] = embeds
        state, metrics = step_fn(state, batch)
        if metrics_out is not None:
            metrics_out.write(json.dumps({"step": step, **{k: float(v) for k, v in
                                                           metrics.items()}}) + "\n")
        if step % args.log_every == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            gn = float(metrics["grad_norm"])
            tok_s = args.batch * args.seq * (step - start + 1) / (time.time() - t0)
            print(f"step {step:5d}  loss {loss:.4f}  |g| {gn:.3f}  "
                  f"{tok_s:,.0f} tok/s", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, step + 1, state,
                            extra={"data": data.checkpoint(), "step": step + 1})
    if metrics_out is not None:
        metrics_out.close()
    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, args.steps, state,
                        extra={"data": data.checkpoint(), "step": args.steps})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
