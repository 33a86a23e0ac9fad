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

The manual TP lowering works here too (``layout``), through the same
per-stage layer helpers and ``ManualTPApply`` hooks as the stage programs:
the shards' partials are summed over the tp axis; GPipe has no ledger.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import device as devices
from repro_torch.configs.base import ModelConfig
from repro_torch.core import costmodel as cm
from repro_torch.core.plan import PipelinePlan
from repro_torch.core.staging import check_layout, layer_params, manual_tp_plan
from repro_torch.core.stagestep import stage_out_ffn, stage_qkv
from repro_torch.kernels import ops, ref
from repro_torch.kvstore.quant import torch_dtype
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.obs import telemetry as obs_t


@torch.no_grad()
def gpipe_prefill(cfg: ModelConfig, staged, tokens, plan: PipelinePlan, *,
                  device=None, return_telemetry: bool = False, layout=None):
    """GPipe prefill of ``tokens`` [B, S], B divisible by the plan's M
    microbatches; returns the fp32 next-token logits [B, Vpad]. Dense
    family only (the reference's stage body is the transformer layer).

    ``return_telemetry``: also return the ``[N, T]`` stage telemetry
    (``obs.telemetry``). GPipe has no KV pool or MBKR wire, so only
    ``attn_work`` (full-sequence causal attention per microbatch tick) and
    ``launches`` (lps a stage a tick, as the reference charges them; one K1
    launch a (layer, tick) serves all N stages on the card) are non-zero."""
    if cfg.family != "dense":
        raise ValueError(f"gpipe runs the dense family only, not {cfg.family!r}")
    dev = devices.resolve(device)
    if staged["embed"].device.type != dev.type:
        raise ValueError(f"params on {staged['embed'].device}, run on {dev}")
    tokens = torch.as_tensor(np.asarray(tokens) if not torch.is_tensor(tokens)
                             else tokens, device=dev).long()
    mtp = manual_tp_plan(cfg, plan, layout)
    check_layout(staged, mtp)
    tpa = None if mtp is None else T.manual_tp_apply(mtp, lambda y: y.sum(dim=1))
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
    rec = obs_t.TelemetryRecorder(n) if return_telemetry else None
    stages = np.arange(n)
    for t in range(m + n - 1):
        # stage 0 embeds microbatch clip(t); the others take the ring buffer
        mb = min(max(t, 0), m - 1)
        x_emb = L.embed_lookup(staged["embed"], tokens[mb * bm:(mb + 1) * bm])
        if cfg.embedding_multiplier != 1.0:
            x_emb = x_emb * cfg.embedding_multiplier
        x[0] = x_emb.to(dt)
        for li in range(lps):
            lp = layer_params(layers, li, mtp)
            q, k, v = stage_qkv(cfg, lp, x, cos, sin, mtp)
            att = attention(q, k, v, causal_offset=0, scale=scale)
            x, _ = stage_out_ffn(cfg, lp, x, att, mtp=mtp, tpa=tpa)
        # the last stage's last-token state of microbatch t - (N - 1)
        phase = t - (n - 1)
        if 0 <= phase < m:
            out[phase * bm:(phase + 1) * bm] = x[n - 1, :, -1].float()
        if rec is not None:
            active = (t - stages >= 0) & (t - stages < m)
            obs_t.charge(rec.tel, "attn_work", lps * cm.attn_flops(cfg, s_full, 0),
                         active)
            obs_t.charge(rec.tel, "launches", float(lps))
            rec.snapshot()
        x = torch.roll(x, 1, dims=0)
    h = L.rms_norm(out[:, None, :].to(dt), staged["final_norm"], cfg.norm_eps)
    w = staged["lm_head"] if "lm_head" in staged else staged["embed"].T
    logits = L.unembed_logits(h, w, scale=cfg.logits_scaling)[:, 0]
    return (logits, rec.profile()) if return_telemetry else logits


def _plain(q, k, v, **kw) -> torch.Tensor:
    """K1's plain version, output only (the ``torch`` attention backend)."""
    return ref.chunk_attention_plain(q, k, v, **kw)[0]
