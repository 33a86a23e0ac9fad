"""Whisper-style encoder-decoder backbone, mirroring
``repro.models.whisper``. The audio frontend (mel + conv) is a stub: the
inputs are precomputed frame embeddings [B, F, d_model].

The encoder is bidirectional, so MOCAP's chunked pipeline applies to the
decoder prefill only; the encoder runs once, as one pass over all F frames
(``encode``). As in the reference, RoPE replaces whisper's learned /
sinusoidal positions.

Params: ``embed``, ``final_norm`` and ``enc_norm``, the encoder layers
``enc_layers`` (the transformer's layer leaves, stacked [Le, ...]) and the
decoder layers ``dec_layers`` (self-attention, the cross-attention leaves
``lnx`` / ``xwq`` / ``xwk`` / ``xwv`` / ``xwo``, the SwiGLU FFN; stacked
[L, ...]). The head is the embedding, transposed.

Decode (``decode_step``) runs both attentions of a decoder layer on the
flash-decode kernel K5 (``kernels.ops.decode_attention``): the
self-attention against the KV cache written in place, as the transformer's
decode does, and the cross-attention against the cached encoder K/V
(``xk`` / ``xv``) with every one of the F frames valid.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.configs.base import ModelConfig, replace
from repro_torch.kernels import ops
from repro_torch.kvstore.quant import torch_dtype
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

Params = Dict[str, Any]


def _enc_cfg(cfg: ModelConfig) -> ModelConfig:
    return replace(cfg, num_layers=cfg.encdec.enc_layers, family="dense",
                   tie_embeddings=True)


def init_dec_layers(cfg: ModelConfig, generator: torch.Generator, device=None,
                    dtype=None, *, lead: Sequence[int] = ()) -> Params:
    """Random decoder-layer weights with the reference's shapes and stds,
    under leading axes ``lead`` (``(L,)``, or ``(N, lps)`` staged; layers
    past ``cfg.num_layers`` are zero: exact identities)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv, nl = cfg.num_heads, cfg.num_kv_heads, cfg.num_layers
    dt = torch_dtype(dtype or cfg.dtype)
    lead = tuple(lead)
    out_std = 0.02 / math.sqrt(2 * nl)

    def nrm(*shape, std=0.02):
        return torch.randn(lead + shape, generator=generator, device=device,
                           dtype=dt).mul_(std)

    def ones(*shape):
        return torch.ones(lead + shape, device=device, dtype=dt)

    lp: Params = {
        "ln1": ones(d), "wq": nrm(d, h * hd), "wk": nrm(d, kv * hd),
        "wv": nrm(d, kv * hd), "wo": nrm(h * hd, d, std=out_std),
        "lnx": ones(d), "xwq": nrm(d, h * hd), "xwk": nrm(d, kv * hd),
        "xwv": nrm(d, kv * hd), "xwo": nrm(h * hd, d, std=out_std),
        "ln2": ones(d), "wg": nrm(d, cfg.d_ff), "wu": nrm(d, cfg.d_ff),
        "wd": nrm(cfg.d_ff, d, std=out_std),
    }
    if lead:
        for w in lp.values():
            w.view(-1, *w.shape[len(lead):])[nl:] = 0
    return lp


def init(cfg: ModelConfig, generator: torch.Generator, device=None,
         dtype=None, *, layer_lead: Optional[Sequence[int]] = None) -> Params:
    """Random weights; the decoder layers under ``layer_lead`` (default
    ``(L,)``), the encoder layers under ``(Le,)``."""
    dt = torch_dtype(dtype or cfg.dtype)
    lead = tuple(layer_lead) if layer_lead is not None else (cfg.num_layers,)
    ecfg = _enc_cfg(cfg)
    return {
        "embed": L.init_embed(cfg.vocab_size, cfg.d_model, generator, device, dt),
        "final_norm": torch.ones((cfg.d_model,), device=device, dtype=dt),
        "enc_layers": T.init_layers(ecfg, generator, device, dtype,
                                    lead=(ecfg.num_layers,)),
        "enc_norm": torch.ones((cfg.d_model,), device=device, dtype=dt),
        "dec_layers": init_dec_layers(cfg, generator, device, dtype, lead=lead),
    }


def encode(cfg: ModelConfig, params: Params, frames: torch.Tensor, *,
           attend=None, impl: str = "naive", remat: bool = False) -> torch.Tensor:
    """frames [B, F, d] (stub embeddings) -> encoder output [B, F, d]:
    bidirectional layers, RoPE from position 0, the final ``enc_norm``.
    The layers' attention is ``layers.attention(impl=)`` (default the
    oracle), or ``attend(q, k, v, scale=)`` when given (in the pipeline the
    backend's ``full_block``: K1 non-causal under ``cuda``). ``remat``:
    each layer under ``layers.remat_call``."""
    ecfg = _enc_cfg(cfg)
    x = frames.to(torch_dtype(cfg.dtype))

    def body(xc, lp):
        return T.layer_apply(ecfg, lp, xc, causal_offset=None, attend=attend, impl=impl)[0]

    for lp in L.unstack(params["enc_layers"])[:ecfg.num_layers]:
        x = L.remat_call(body, remat, x, lp)
    return L.rms_norm(x, params["enc_norm"], cfg.norm_eps)


def cross_kv(cfg: ModelConfig, lp: Params, enc_out: torch.Tensor):
    """One decoder layer's cross-attention K/V [B, F, KVH, D] of the
    encoder output [B, F, d]."""
    b, f, _ = enc_out.shape
    kvh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    xk = torch.matmul(enc_out, lp["xwk"]).reshape(b, f, kvh, hd)
    xv = torch.matmul(enc_out, lp["xwv"]).reshape(b, f, kvh, hd)
    return xk, xv


def _cross_attn(cfg: ModelConfig, lp: Params, x: torch.Tensor, xk: torch.Tensor,
                xv: torch.Tensor, impl: str = "naive") -> torch.Tensor:
    """The cross-attention sub-block of the forward: the decoder positions
    x [B, S, d] attend to every encoder frame (``layers.attention(impl=)``;
    the oracle for one position, as in the reference)."""
    b, s, _ = x.shape
    hn = L.rms_norm(x, lp["lnx"], cfg.norm_eps)
    q = torch.matmul(hn, lp["xwq"]).reshape(b, s, cfg.num_heads, cfg.resolved_head_dim)
    att = L.attention(q, xk, xv, causal_offset=None, impl="naive" if s == 1 else impl)
    return x + torch.matmul(att.reshape(b, s, -1), lp["xwo"])


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
            embeds: Optional[torch.Tensor] = None, impl: str = "naive",
            remat: bool = False, return_cache: bool = False):
    """``embeds``: the stub frame embeddings [B, F, d]; ``tokens``: the
    decoder tokens [B, S]. Returns fp32 logits [B, S, Vpad] and, with
    ``return_cache``, the cache {"k", "v": [L,B,S,KVH,D], "xk", "xv":
    [L,B,F,KVH,D], "pos": [B] int32 = S}. ``impl``: every attention of the
    encoder and decoder (``layers.attention``); ``remat``: each encoder and
    decoder layer under ``layers.remat_call``."""
    if embeds is None:
        raise ValueError("whisper requires frame embeddings")
    enc_out = encode(cfg, params, embeds, impl=impl, remat=remat)
    x = L.embed_lookup(params["embed"], tokens)
    kvs = {"k": [], "v": [], "xk": [], "xv": []}

    def body(xc, lp):
        xc, k, v = T.attn_block(cfg, lp, xc, impl=impl)
        xk, xv = cross_kv(cfg, lp, enc_out)
        return T.ffn_block(cfg, lp, _cross_attn(cfg, lp, xc, xk, xv, impl)), k, v, xk, xv

    for lp in L.unstack(params["dec_layers"])[:cfg.num_layers]:
        x, k, v, xk, xv = L.remat_call(body, remat, x, lp)
        if return_cache:
            for name, t in zip(kvs, (k, v, xk, xv)):
                kvs[name].append(t)
    logits = logits_head(cfg, params, x)
    if not return_cache:
        return logits
    pos = torch.full((tokens.shape[0],), x.shape[1], dtype=torch.int32, device=x.device)
    return logits, {**{k: torch.stack(v) for k, v in kvs.items()}, "pos": pos}


def logits_head(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed_logits(x, params["embed"].T)


# ------------------------------------------------------------------ decode

def init_cache_shape(cfg: ModelConfig, batch: int, max_len: int):
    """{leaf: (shape, dtype)}: the self-attention cache at ``max_len`` and
    the cross K/V at the config's ``num_frames``."""
    nl, kv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    dt = torch_dtype(cfg.dtype)
    self_kv = (nl, batch, max_len, kv, hd)
    cross = (nl, batch, cfg.encdec.num_frames, kv, hd)
    return {"k": (self_kv, dt), "v": (self_kv, dt), "xk": (cross, dt),
            "xv": (cross, dt), "pos": ((batch,), torch.int32)}


def cross_decode(cfg: ModelConfig, lp: Params, x: torch.Tensor, xk: torch.Tensor,
                 xv: torch.Tensor, frames: torch.Tensor) -> torch.Tensor:
    """The cross-attention of one token per row x [B, 1, d] against the
    cached encoder K/V xk / xv [B, F, KVH, D] through K5, ``frames`` [B]
    int32 = F on the device."""
    b = x.shape[0]
    hn = L.rms_norm(x, lp["lnx"], cfg.norm_eps)
    q = torch.matmul(hn, lp["xwq"]).reshape(b, cfg.num_heads, cfg.resolved_head_dim)
    att = ops.decode_attention(q.contiguous(), xk, xv, frames)
    return x + torch.matmul(att.reshape(b, 1, -1), lp["xwo"])


def decode_step(cfg: ModelConfig, params: Params, cache: Params,
                tokens: torch.Tensor):
    """One-token decode. tokens [B] int. Returns (logits [B, Vpad] fp32,
    cache). Each layer's self-attention k/v is written at ``pos`` into
    ``cache["k"]`` / ``cache["v"]`` IN PLACE (as ``transformer.decode_step``
    does; the reference returns a new cache); ``xk`` / ``xv`` are read only.
    Raises if a row's ``pos`` is outside the cache."""
    pos = cache["pos"]
    T.check_pos(pos, cache["k"].shape[2])
    x = L.embed_lookup(params["embed"], tokens[:, None])
    frames = torch.full((tokens.shape[0],), cache["xk"].shape[2], dtype=torch.int32,
                        device=x.device)
    layers = params["dec_layers"]
    for i in range(cfg.num_layers):
        lp = {n: w[i] for n, w in layers.items()}
        x = T.attn_decode(cfg, lp, x, cache["k"][i], cache["v"][i], pos)
        x = cross_decode(cfg, lp, x, cache["xk"][i], cache["xv"][i], frames)
        x = T.ffn_block(cfg, lp, x)
    return logits_head(cfg, params, x)[:, 0], {**cache, "pos": pos + 1}
