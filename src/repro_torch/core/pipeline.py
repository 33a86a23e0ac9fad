"""Chunked-pipeline prefill driver — MOCAP's execution model on one GPU
(mirrors ``repro.core.pipeline`` for the dense, moe, ssm and hybrid families,
modes mocap and terapipe; mode gpipe dispatches to ``core.gpipe``).

The reference maps the N pipeline stages onto N devices in SPMD lockstep
(``shard_map`` + ``ppermute``). Here the stage axis is the leading tensor
dimension: the stage-stacked params ``[N, lps, ...]``, the stage-stacked
paged KV pool, the SSM state and the activations ``[N, B, C, d]``. Each
tick runs every stage as batched ops, the fill/drain bubble included as in
the reference, and the ring shift is a roll by one on the stage axis.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import device as devices
from repro_torch.configs.base import ModelConfig
from repro_torch.core import transport as tx
from repro_torch.core.gpipe import gpipe_prefill
from repro_torch.core.plan import PipelinePlan, build_plan  # noqa: F401
from repro_torch.core.stagestep import (StageCtx, hybrid_stage_step,
                                       ssm_stage_step, tfm_stage_step)
from repro_torch.core.staging import (Params, alloc_kv_pool,  # noqa: F401
                                      alloc_ssm_state, stage_params)
from repro_torch.kvstore.quant import torch_dtype
from repro_torch.models import layers as L


@torch.no_grad()
def prefill_pipeline(cfg: ModelConfig, staged: Params, tokens, plan: PipelinePlan,
                     *, device=None, return_ledger: bool = False):
    """Chunked-pipeline prefill of ``tokens`` [B, S]; returns the fp32
    next-token logits [B, Vpad] (prefill only: one output token).

    ``staged`` is ``stage_params`` output on ``device`` (default the card;
    ``device="cpu"`` runs on the CPU). ``return_ledger`` also returns the
    CollectiveLedger: per-category wire bytes summed over stages, as the
    reference's ``return_ledger`` does. A ``gpipe`` plan runs the
    microbatch baseline (``core.gpipe``, dense only), which has no ledger."""
    if plan.mode == "gpipe":
        if return_ledger:
            raise ValueError("gpipe has no MBKR transport ledger")
        return gpipe_prefill(cfg, staged, tokens, plan, device=device)
    if plan.mode not in ("mocap", "terapipe"):
        raise ValueError(f"unknown mode {plan.mode!r}")
    dev = devices.resolve(device)
    if staged["embed"].device.type != dev.type:
        raise ValueError(f"params on {staged['embed'].device}, run on {dev}")
    tokens = torch.as_tensor(np.asarray(tokens) if not torch.is_tensor(tokens)
                             else tokens, device=dev).long()
    n, m, c = plan.num_stages, plan.num_chunks, plan.chunk_len
    b = tokens.shape[0]
    if tokens.shape[1] != m * c:
        raise ValueError(f"tokens {tuple(tokens.shape)} vs plan {m} x {c}")
    dt = torch_dtype(cfg.dtype)
    transport = tx.StageAxisTransport()
    scale = cfg.attention_multiplier or 1.0 / math.sqrt(cfg.resolved_head_dim or 1)
    stages = np.arange(n)
    first_half = stages < n // 2

    family = cfg.family
    if family not in ("dense", "moe", "ssm", "hybrid"):
        raise ValueError(f"family {family!r} is not ported")
    pool = alloc_kv_pool(cfg, plan, b, device=dev)          # None for ssm
    state = (alloc_ssm_state(cfg, plan, b, device=dev)
             if family in ("ssm", "hybrid") else None)
    x = torch.zeros((n, b, c, cfg.d_model), dtype=dt, device=dev)
    x_last = torch.zeros((n, b, cfg.d_model), dtype=torch.float32, device=dev)
    led = tx.ledger_init()
    for t in range(plan.num_ticks):
        phase = t - stages
        ctx = StageCtx(cfg=cfg, plan=plan, stage=stages, phase=phase,
                       first_half=first_half, scale=scale, transport=transport)
        # stage 0 embeds chunk clip(t); the others take the ring buffer
        tc = min(max(t, 0), m - 1)
        x_emb = L.embed_lookup(staged["embed"], tokens[:, tc * c:(tc + 1) * c])
        if cfg.embedding_multiplier != 1.0:
            x_emb = x_emb * cfg.embedding_multiplier
        x[0] = x_emb.to(dt)
        if family == "ssm":
            x_out, state, led = ssm_stage_step(ctx, staged["stage_layers"], x,
                                               state, led)
        elif family == "hybrid":
            x_out, state, pool, led = hybrid_stage_step(
                ctx, staged["stage_layers"], staged["shared"], x, state, pool, led)
        else:
            x_out, pool, led = tfm_stage_step(ctx, staged["stage_layers"], x,
                                              pool, led)
        # the last token's hidden state, at the last stage's last chunk
        for s in np.flatnonzero((stages == n - 1) & (phase == m - 1)):
            x_last[s] = x_out[s, :, -1].float()
        ring_active = (phase >= 0) & (phase < m) & (stages < n - 1)
        x, led = transport.ring_shift(x_out, led, active=ring_active)
    # replicate the final hidden state across stages
    x_last, led = transport.stage_psum(x_last, led)
    h = L.rms_norm(x_last[0][:, None, :].to(dt), staged["final_norm"], cfg.norm_eps)
    w = staged["lm_head"] if "lm_head" in staged else staged["embed"].T
    logits = L.unembed_logits(h, w, scale=cfg.logits_scaling)[:, 0]
    if return_ledger:
        return logits, tx.ledger_to_dict(led)
    return logits
