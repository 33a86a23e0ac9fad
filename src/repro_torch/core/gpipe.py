"""The GPipe baseline: a microbatch pipeline over the BATCH (mirrors
``repro.core.gpipe``; selected by ``PipelinePlan.mode == "gpipe"``).

Every microbatch carries the whole sequence: full causal attention over S
at each stage, no chunks and no KV pool — the paper's Fig. 2(a)
comparison point against MOCAP's chunked pipeline. As in the chunked
pipeline, the N stages run on one card as the leading tensor axis:
activations [N, bm, S, d] against the stage-stacked params, every stage
computing every one of the M + N - 1 ticks (the fill / drain bubble
included, as in the reference), the ring shift a roll by one.

The reference's self-attention here is a ``lax.scan`` flash attention. The
port takes its chunk-attention kernel K1 at full-sequence causal shape
(causal offset 0, C = T = S), the reference's ``impl="pallas"`` route:
``attn_backend="cuda"`` launches K1 once per (layer, tick) over the N*bm
rows of the tick; ``"torch"`` runs K1's plain version (as any wrapper does
on the CPU).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import device as devices
from repro_torch.configs.base import ModelConfig
from repro_torch.core.plan import PipelinePlan
from repro_torch.core.stagestep import stage_out_ffn, stage_qkv
from repro_torch.kernels import ops, ref
from repro_torch.kvstore.quant import torch_dtype
from repro_torch.models import layers as L


@torch.no_grad()
def gpipe_prefill(cfg: ModelConfig, staged, tokens, plan: PipelinePlan, *,
                  device=None) -> torch.Tensor:
    """GPipe prefill of ``tokens`` [B, S], B divisible by the plan's M
    microbatches; returns the fp32 next-token logits [B, Vpad]. Dense
    family only (the reference's stage body is the transformer layer)."""
    if cfg.family != "dense":
        raise ValueError(f"gpipe runs the dense family only, not {cfg.family!r}")
    dev = devices.resolve(device)
    if staged["embed"].device.type != dev.type:
        raise ValueError(f"params on {staged['embed'].device}, run on {dev}")
    tokens = torch.as_tensor(np.asarray(tokens) if not torch.is_tensor(tokens)
                             else tokens, device=dev).long()
    n, m, lps = plan.num_stages, plan.num_chunks, plan.layers_per_stage
    b, s_full = tokens.shape
    if b % m:
        raise ValueError(f"gpipe: batch {b} must divide into {m} microbatches")
    bm = b // m
    dt = torch_dtype(cfg.dtype)
    hd = cfg.resolved_head_dim
    scale = cfg.attention_multiplier or 1.0 / math.sqrt(hd or 1)
    attention = ops.chunk_attention if plan.attn_backend == "cuda" else _plain
    cos, sin = L.rope_angles(torch.arange(s_full, device=dev), hd, cfg.rope_theta)
    layers = staged["stage_layers"]
    x = torch.zeros((n, bm, s_full, cfg.d_model), dtype=dt, device=dev)
    out = torch.zeros((b, cfg.d_model), dtype=torch.float32, device=dev)
    for t in range(m + n - 1):
        # stage 0 embeds microbatch clip(t); the others take the ring buffer
        mb = min(max(t, 0), m - 1)
        x_emb = L.embed_lookup(staged["embed"], tokens[mb * bm:(mb + 1) * bm])
        if cfg.embedding_multiplier != 1.0:
            x_emb = x_emb * cfg.embedding_multiplier
        x[0] = x_emb.to(dt)
        for li in range(lps):
            lp = {k: w[:, li] for k, w in layers.items()}
            q, k, v = stage_qkv(cfg, lp, x, cos, sin)
            att = attention(q, k, v, causal_offset=0, scale=scale)
            x = stage_out_ffn(cfg, lp, x, att)
        # the last stage's last-token state of microbatch t - (N - 1)
        phase = t - (n - 1)
        if 0 <= phase < m:
            out[phase * bm:(phase + 1) * bm] = x[n - 1, :, -1].float()
        x = torch.roll(x, 1, dims=0)
    h = L.rms_norm(out[:, None, :].to(dt), staged["final_norm"], cfg.norm_eps)
    w = staged["lm_head"] if "lm_head" in staged else staged["embed"].T
    return L.unembed_logits(h, w, scale=cfg.logits_scaling)[:, 0]


def _plain(q, k, v, **kw) -> torch.Tensor:
    """K1's plain version, output only (the ``torch`` attention backend)."""
    return ref.chunk_attention_plain(q, k, v, **kw)[0]
