"""Decoder-only transformer (GQA, qk_norm, granite scalars; a SwiGLU FFN
or, for the moe family, routed plus shared experts), mirroring the dense,
MoE and VLM parts of ``repro.models.transformer`` (the vlm family is this
backbone with stub patch embeddings spliced in front of the tokens).
Params are a dict with the reference's key names; layer params are stacked
on a leading layer axis.

Decode (``decode_step``) runs the reference's local path: one token per
batch row against a KV cache, through the flash-decode kernel K5
(``kernels.ops.decode_attention``). The seq-sharded decode of the reference
(``decode_attn_update``) spans several devices and is not ported.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kvstore.quant import torch_dtype
from repro_torch.models import layers as L

Params = Dict[str, Any]


@dataclass(frozen=True)
class ManualTPApply:
    """Manual-TP hooks of the FFN (mirrors the reference's
    ``ManualTPApply``): which param groups arrive sharded, so that their
    outputs are partials [G, tp, ...] that ``reduce`` sums over the tp
    axis (the reference's psum, a transport closure supplied by the
    caller, which charges its ledger). ``ep``: manual expert parallelism
    (each shard holds its own experts), the reference's ``ep_axes``.
    The attention's psum after the o-projection is the stage programs'
    (``core.stagestep.stage_out``). ``None`` everywhere else: the
    unsharded path."""
    reduce: Callable[[torch.Tensor], torch.Tensor]
    attn: bool = False        # wq/wk/wv/wo head-sharded -> reduce after wo
    dense: bool = False       # wg/wu/wd f-sharded -> reduce after wd
    moe: bool = False         # expert output partial (f- or expert-sharded)
    shared: bool = False      # shared-experts s_w* f-sharded
    ep: bool = False          # manual EP: each shard's own experts


def manual_tp_apply(mtp, reduce: Callable[[torch.Tensor], torch.Tensor]
                    ) -> ManualTPApply:
    """The one mapping from a ``core.staging.ManualTP`` plan (duck-typed:
    this layer sits below core) to the hooks; the stage programs and GPipe
    both build through here."""
    return ManualTPApply(reduce=reduce, attn=mtp.attn, dense=mtp.ffn,
                         moe=(mtp.moe_ffn or mtp.moe_ep), shared=mtp.shared_moe,
                         ep=mtp.moe_ep)


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
    if cfg.moe is None:
        lp["wg"] = nrm(d, cfg.d_ff)
        lp["wu"] = nrm(d, cfg.d_ff)
        lp["wd"] = nrm(cfg.d_ff, d, std=out_std)
    else:
        m = cfg.moe
        fe = m.d_expert or cfg.d_ff
        lp["router"] = nrm(d, m.num_experts)
        lp["e_wg"] = nrm(m.num_experts, d, fe)
        lp["e_wu"] = nrm(m.num_experts, d, fe)
        lp["e_wd"] = nrm(m.num_experts, fe, d, std=out_std)
        if m.num_shared_experts:
            fs = fe * m.num_shared_experts
            lp["s_wg"] = nrm(d, fs)
            lp["s_wu"] = nrm(d, fs)
            lp["s_wd"] = nrm(fs, d, std=out_std)
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
               causal_offset: Optional[int] = 0, attend=None, impl: str = "naive"):
    """Pre-norm attention block over a whole sequence. Returns
    (residual_out, k, v). The attention is ``layers.attention(impl=)``
    (the oracle ``naive_attention`` by default); ``attend(q, k, v,
    scale=)`` replaces it when given, only for ``causal_offset=None`` (the
    whisper encoder's bidirectional layers, which run K1 non-causal)."""
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
    if attend is None:
        att = L.attention(q, k, v, causal_offset=causal_offset, scale=scale, impl=impl)
    else:
        assert causal_offset is None, "attend is the non-causal attention"
        att = attend(q, k, v, scale=scale)
    out = torch.matmul(att.reshape(b, s, -1), lp["wo"])
    return x + cfg.residual_multiplier * out, k, v


def ffn_out(cfg: ModelConfig, lp: Params, hn: torch.Tensor,
            tp: Optional[ManualTPApply] = None) -> torch.Tensor:
    """The FFN of the normed input ``hn`` [B, S, d] (or stage-stacked
    [G, B, S, d] with ``lp`` leaves [G, ...]): SwiGLU, or the routed
    experts (``moe_layer``, each row dispatching over its own S tokens)
    plus the shared experts' SwiGLU.

    Under the manual TP lowering (``tp``, stage-stacked only) a sharded
    part's leaves carry a tp axis ([G, tp, ...], or [tp, ...] for the
    hybrid's unstacked shared block) and its output is a partial
    [G, tp, B, S, d]; as in the reference, the sharded parts are summed and
    reduced with ONE ``tp.reduce``, and the replicated parts add after it,
    so a replicated output is never counted tp times."""
    partial, replicated = None, None

    def acc(out, sharded: bool) -> None:
        nonlocal partial, replicated
        if sharded:
            partial = out if partial is None else partial + out
        else:
            replicated = out if replicated is None else replicated + out

    def swiglu(prefix: str, sharded: bool) -> torch.Tensor:
        w = {n: lp[prefix + n] for n in ("wg", "wu", "wd")}
        if hn.ndim == 3:
            return L.swiglu(w, hn)
        g, b, s, d = hn.shape                 # stage-stacked: [G, B*S, d] products
        if not sharded:
            return L.swiglu(w, hn.reshape(g, b * s, d)).reshape(g, b, s, d)
        shards = w["wg"].shape[-3]            # one partial a shard: [G, tp, B*S, d]
        x = hn.reshape(g, 1, b * s, d).expand(g, shards, b * s, d).contiguous()
        return L.swiglu(w, x).reshape(g, shards, b, s, d)

    on = tp is not None
    if cfg.moe is None:
        acc(swiglu("", on and tp.dense), on and tp.dense)
    else:
        m = cfg.moe
        sharded = on and tp.moe
        acc(L.moe_layer({"router": lp["router"], "wg": lp["e_wg"], "wu": lp["e_wu"],
                         "wd": lp["e_wd"]}, hn, num_experts=m.num_experts, top_k=m.top_k,
                        capacity_factor=m.capacity_factor, num_real=m.real_experts,
                        sharded=sharded, ep=sharded and tp.ep), sharded)
        if m.num_shared_experts:
            acc(swiglu("s_", on and tp.shared), on and tp.shared)
    out = replicated
    if partial is not None:
        out = tp.reduce(partial) if out is None else tp.reduce(partial) + out
    return out


def ffn_block(cfg: ModelConfig, lp: Params, x: torch.Tensor,
              tp: Optional[ManualTPApply] = None) -> torch.Tensor:
    hn = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + cfg.residual_multiplier * ffn_out(cfg, lp, hn, tp)


def layer_apply(cfg: ModelConfig, lp: Params, x: torch.Tensor, *,
                positions=None, causal_offset=0, attend=None, impl: str = "naive"):
    x, k, v = attn_block(cfg, lp, x, positions=positions,
                         causal_offset=causal_offset, attend=attend, impl=impl)
    return ffn_block(cfg, lp, x), k, v


def embed_tokens(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
                 embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens [B, St]; ``embeds`` [B, Si, d] (the vlm's stub patch
    embeddings) are spliced in front; the embedding multiplier applies
    after the splice, to both."""
    x = L.embed_lookup(params["embed"], tokens)
    if embeds is not None:
        x = torch.cat([embeds.to(x.dtype), x], dim=1)
    if cfg.embedding_multiplier != 1.0:
        x = x * cfg.embedding_multiplier
    return x


def logits_head(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return L.unembed_logits(x, w, scale=cfg.logits_scaling)


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
            embeds: Optional[torch.Tensor] = None, impl: str = "naive",
            remat: bool = False, return_cache: bool = False):
    """Full-sequence forward of ``embeds`` (optional, [B, Si, d]) then
    ``tokens`` [B, St]; returns fp32 logits [B, S, Vpad], S = Si + St, and,
    with ``return_cache``, also the cache {"k", "v": [L,B,S,KVH,D], "pos":
    [B] int32 = S}. ``impl``: the attention (``layers.attention``);
    ``remat``: each layer body under ``layers.remat_call``."""
    x = embed_tokens(cfg, params, tokens, embeds=embeds)
    ks, vs = [], []

    def body(xc, lp):
        return layer_apply(cfg, lp, xc, impl=impl)

    for lp in L.unstack(params["layers"])[:cfg.num_layers]:
        x, k, v = L.remat_call(body, remat, x, lp)
        if return_cache:
            ks.append(k)
            vs.append(v)
    logits = logits_head(cfg, params, x)
    if not return_cache:
        return logits
    pos = torch.full((tokens.shape[0],), x.shape[1], dtype=torch.int32, device=x.device)
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs), "pos": pos}


# ------------------------------------------------------------------ decode

def init_cache_shape(cfg: ModelConfig, batch: int, max_len: int):
    """{leaf: (shape, dtype)} of the KV cache."""
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    dt = torch_dtype(cfg.dtype)
    return {"k": (shape, dt), "v": (shape, dt), "pos": ((batch,), torch.int32)}


def check_pos(pos: torch.Tensor, max_len: int) -> None:
    """Asserts that every row's write position lies in [0, max_len) (the
    reference's update silently clamps to the last slot), without a host
    sync: on the CPU it raises at once, on the card the device-side assert
    fails the next call that synchronises."""
    torch._assert_async(((pos >= 0) & (pos < max_len)).all(),
                        f"a decode position lies outside a cache of {max_len}")


def attn_decode(cfg: ModelConfig, lp: Params, x: torch.Tensor, ck: torch.Tensor,
                cv: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Pre-norm attention of one token per row x [B,1,d] against the layer
    cache ck/cv [B,S,KVH,D]: writes this token's k/v at ``pos`` [B] of each
    row IN PLACE, then runs K5 over the first pos + 1 keys. Returns the
    residual output."""
    b = x.shape[0]
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    hn = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    q = torch.matmul(hn, lp["wq"]).reshape(b, 1, h, hd)
    k = torch.matmul(hn, lp["wk"]).reshape(b, 1, kv, hd)
    v = torch.matmul(hn, lp["wv"]).reshape(b, 1, kv, hd)
    if cfg.qk_norm:
        q = L.rms_norm(q, lp["q_norm"], cfg.norm_eps)
        k = L.rms_norm(k, lp["k_norm"], cfg.norm_eps)
    cos, sin = L.rope_angles(pos[:, None], hd, cfg.rope_theta)
    q = L.apply_rope(q, cos, sin)
    k = L.apply_rope(k, cos, sin)
    rows = torch.arange(b, device=x.device)
    idx = pos.long()
    ck[rows, idx] = k[:, 0]
    cv[rows, idx] = v[:, 0]
    att = ops.decode_attention(q[:, 0].contiguous(), ck, cv, pos + 1,
                               scale=cfg.attention_multiplier or None)
    out = torch.matmul(att.reshape(b, 1, h * hd), lp["wo"])
    return x + cfg.residual_multiplier * out


def decode_step(cfg: ModelConfig, params: Params, cache: Params,
                tokens: torch.Tensor):
    """One-token decode. tokens [B] int. Returns (logits [B, Vpad] fp32,
    cache). Unlike the reference, which returns a new cache, each layer's
    k/v is written at ``pos`` into ``cache["k"]`` / ``cache["v"]`` IN PLACE
    (a functional copy of a long cache every step does not fit on the card);
    the returned dict holds the same k/v tensors and ``pos + 1`` as a new
    tensor. Raises if a row's ``pos`` is outside the cache."""
    pos = cache["pos"]
    check_pos(pos, cache["k"].shape[2])
    x = embed_tokens(cfg, params, tokens[:, None])
    layers = params["layers"]
    for i in range(cfg.num_layers):
        lp = {n: w[i] for n, w in layers.items()}
        x = attn_decode(cfg, lp, x, cache["k"][i], cache["v"][i], pos)
        x = ffn_block(cfg, lp, x)
    logits = logits_head(cfg, params, x)
    return logits[:, 0], {**cache, "pos": pos + 1}
