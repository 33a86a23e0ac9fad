"""Dense decoder-only transformer (GQA, qk_norm, granite scalars), mirroring
the dense subset of ``repro.models.transformer``. Params are a dict with the
reference's key names; layer params are stacked on a leading layer axis.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kvstore.quant import torch_dtype
from repro_torch.models import layers as L

Params = Dict[str, Any]


def init_layers(cfg: ModelConfig, generator: torch.Generator, device=None,
                dtype=None, *, lead: Sequence[int] = ()) -> Params:
    """Random layer weights with the reference's shapes and stds
    (``repro.models.transformer.init``'s ``layers``), drawn from
    ``generator`` on ``device`` under leading axes ``lead`` (``(L,)``, or
    ``(N, lps)`` for the stage-stacked layout; ``()`` for one unstacked
    layer). Layers past ``cfg.num_layers`` are zero, which makes them exact
    identities through the residual."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    nl = cfg.num_layers
    dt = torch_dtype(dtype or cfg.dtype)
    lead = tuple(lead)
    assert math.prod(lead) >= nl or not lead, (lead, nl)
    out_std = 0.02 / math.sqrt(2 * nl)

    def nrm(*shape, std=0.02):
        x = torch.randn(lead + shape, generator=generator, device=device, dtype=dt)
        return x.mul_(std)

    def ones(*shape):
        return torch.ones(lead + shape, device=device, dtype=dt)

    lp: Params = {
        "ln1": ones(d),
        "ln2": ones(d),
        "wq": nrm(d, h * hd),
        "wk": nrm(d, kv * hd),
        "wv": nrm(d, kv * hd),
        "wo": nrm(h * hd, d, std=out_std),
    }
    if cfg.qk_norm:
        lp["q_norm"] = ones(hd)
        lp["k_norm"] = ones(hd)
    lp["wg"] = nrm(d, cfg.d_ff)
    lp["wu"] = nrm(d, cfg.d_ff)
    lp["wd"] = nrm(cfg.d_ff, d, std=out_std)
    if lead:
        for w in lp.values():
            w.view(-1, *w.shape[len(lead):])[nl:] = 0
    return lp


def init(cfg: ModelConfig, generator: torch.Generator, device=None,
         dtype=None, *, layer_lead: Optional[Sequence[int]] = None) -> Params:
    """Random weights (``init_layers`` under ``layer_lead``, default
    ``(L,)``) plus the embedding, final norm and, untied, the head."""
    dt = torch_dtype(dtype or cfg.dtype)
    lead = tuple(layer_lead) if layer_lead is not None else (cfg.num_layers,)
    params: Params = {
        "layers": init_layers(cfg, generator, device, dtype, lead=lead),
        "embed": L.init_embed(cfg.vocab_size, cfg.d_model, generator, device, dt),
        "final_norm": torch.ones((cfg.d_model,), device=device, dtype=dt),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = torch.randn((cfg.d_model, L.pad_vocab(cfg.vocab_size)),
                                        generator=generator, device=device,
                                        dtype=dt).mul_(0.02)
    return params


def attn_block(cfg: ModelConfig, lp: Params, x: torch.Tensor, *,
               positions: Optional[torch.Tensor] = None,
               causal_offset: Optional[int] = 0):
    """Pre-norm attention block over a whole sequence. Returns
    (residual_out, k, v)."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    hn = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    q = torch.matmul(hn, lp["wq"])
    k = torch.matmul(hn, lp["wk"])
    v = torch.matmul(hn, lp["wv"])
    q = q.reshape(b, s, q.shape[-1] // hd, hd)
    k = k.reshape(b, s, k.shape[-1] // hd, hd)
    v = v.reshape(b, s, v.shape[-1] // hd, hd)
    if cfg.qk_norm:
        q = L.rms_norm(q, lp["q_norm"], cfg.norm_eps)
        k = L.rms_norm(k, lp["k_norm"], cfg.norm_eps)
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :] + (
            0 if causal_offset is None else causal_offset)
    cos, sin = L.rope_angles(positions, hd, cfg.rope_theta)
    q = L.apply_rope(q, cos, sin)
    k = L.apply_rope(k, cos, sin)
    scale = cfg.attention_multiplier or None
    att = L.naive_attention(q, k, v, causal_offset=causal_offset, scale=scale)
    out = torch.matmul(att.reshape(b, s, -1), lp["wo"])
    return x + cfg.residual_multiplier * out, k, v


def ffn_block(cfg: ModelConfig, lp: Params, x: torch.Tensor) -> torch.Tensor:
    hn = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    out = L.swiglu({"wg": lp["wg"], "wu": lp["wu"], "wd": lp["wd"]}, hn)
    return x + cfg.residual_multiplier * out


def layer_apply(cfg: ModelConfig, lp: Params, x: torch.Tensor, *,
                positions=None, causal_offset=0):
    x, k, v = attn_block(cfg, lp, x, positions=positions,
                         causal_offset=causal_offset)
    return ffn_block(cfg, lp, x), k, v


def embed_tokens(cfg: ModelConfig, params: Params,
                 tokens: torch.Tensor) -> torch.Tensor:
    x = L.embed_lookup(params["embed"], tokens)
    if cfg.embedding_multiplier != 1.0:
        x = x * cfg.embedding_multiplier
    return x


def logits_head(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return L.unembed_logits(x, w, scale=cfg.logits_scaling)


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Full-sequence forward; returns fp32 logits [B, S, Vpad]."""
    x = embed_tokens(cfg, params, tokens)
    layers = params["layers"]
    for i in range(cfg.num_layers):
        x, _, _ = layer_apply(cfg, {k: w[i] for k, w in layers.items()}, x)
    return logits_head(cfg, params, x)
