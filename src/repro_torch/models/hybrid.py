"""Zamba2-style hybrid in PyTorch, mirroring ``repro.models.hybrid``: a
Mamba2 backbone with a SHARED attention block applied once per group of SSM
layers (same weights each application, separate KV).

Layer structure (cfg.hybrid): num_groups x (ssm_per_group Mamba2 + 1 shared
attn+FFN application) + tail_ssm_layers Mamba2. Only the attention KV takes
part in MBKR (the SSM state is O(1) per layer).

Decode works on the unstaged parameters (``mamba_groups`` [G, pg, ...],
``mamba_tail`` [tail, ...]), as the reference's does, never on the
pipeline's padded pseudo-group.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kvstore.quant import torch_dtype
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T

Params = Dict[str, Any]


def T_single_cfg(cfg: ModelConfig) -> ModelConfig:
    """The shared block as a one-layer dense transformer config."""
    return replace(cfg, num_layers=1, family="dense")


def init(cfg: ModelConfig, generator: torch.Generator, device=None,
         dtype=None) -> Params:
    """Random weights with the reference's shapes and distributions:
    groups [G, pg, ...], tail [tail, ...] and one unstacked copy of the
    transformer layer params for the shared block."""
    h = cfg.hybrid
    dt = torch_dtype(dtype or cfg.dtype)
    n_grouped = h.num_groups * h.ssm_per_group
    return {
        "embed": L.init_embed(cfg.vocab_size, cfg.d_model, generator, device, dt),
        "final_norm": torch.ones((cfg.d_model,), device=device, dtype=dt),
        "mamba_groups": S.init_block(cfg, generator, (h.num_groups, h.ssm_per_group),
                                     nl=n_grouped, device=device, dtype=dtype),
        "mamba_tail": S.init_block(cfg, generator, (h.tail_ssm_layers,),
                                   nl=h.tail_ssm_layers, device=device, dtype=dtype),
        "shared": T.init_layers(T_single_cfg(cfg), generator, device, dtype),
    }


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            *, impl: str = "naive", remat: bool = False, ssd_impl: str = "torch",
            return_cache: bool = False):
    """Full-sequence forward; returns fp32 logits [B, S, Vpad] (the head is
    the transposed embedding, as in the reference) and, with
    ``return_cache``, also the cache of ``init_cache_shape`` with pos = S.
    ``impl``: the shared block's attention; ``remat``: each group (its
    Mamba2 layers and the shared block) and each tail layer under
    ``layers.remat_call``, as the reference checkpoints its group and tail
    bodies."""
    h = cfg.hybrid
    scfg = T_single_cfg(cfg)
    x = L.embed_lookup(params["embed"], tokens)
    shared = params["shared"]
    ks, vs, g_sts, t_sts = [], [], [], []

    def group_body(xc, g_lp):
        sts = []
        for lp in L.unstack(g_lp)[:h.ssm_per_group]:
            xc, st = S.block_apply(cfg, lp, xc, ssd_impl=ssd_impl)
            sts.append(st)
        xc, k, v = T.attn_block(scfg, shared, xc, impl=impl)
        return T.ffn_block(scfg, shared, xc), k, v, sts

    def tail_body(xc, lp):
        return S.block_apply(cfg, lp, xc, ssd_impl=ssd_impl)

    for g_lp in L.unstack(params["mamba_groups"])[:h.num_groups]:
        x, k, v, sts = L.remat_call(group_body, remat, x, g_lp)
        g_sts += sts
        ks.append(k)
        vs.append(v)
    for lp in L.unstack(params["mamba_tail"])[:h.tail_ssm_layers]:
        x, st = L.remat_call(tail_body, remat, x, lp)
        t_sts.append(st)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = L.unembed_logits(x, params["embed"].T)
    if not return_cache:
        return logits

    def stack(sts, key, lead):
        return torch.stack([st[key] for st in sts]).reshape(*lead, *sts[0][key].shape)
    grouped = (h.num_groups, h.ssm_per_group)
    pos = torch.full((tokens.shape[0],), x.shape[1], dtype=torch.int32, device=x.device)
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs),
                    "g_conv": stack(g_sts, "conv", grouped),
                    "g_ssd": stack(g_sts, "ssd", grouped),
                    "t_conv": stack(t_sts, "conv", (h.tail_ssm_layers,)),
                    "t_ssd": stack(t_sts, "ssd", (h.tail_ssm_layers,)), "pos": pos}


# ------------------------------------------------------------------ decode

def init_cache_shape(cfg: ModelConfig, batch: int, max_len: int):
    """{leaf: (shape, dtype)}: the shared block's KV per group [G,B,S,KVH,D]
    in the model dtype, the Mamba2 states of the groups [G,pg,B,...] and of
    the tail [tail,B,...] in fp32, and pos [B]."""
    h = cfg.hybrid
    kv = ((h.num_groups, batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim),
          torch_dtype(cfg.dtype))
    g_st = S.state_shapes(cfg, (h.num_groups, h.ssm_per_group), batch)
    t_st = S.state_shapes(cfg, (h.tail_ssm_layers,), batch)
    return {"k": kv, "v": kv, "g_conv": g_st["conv"], "g_ssd": g_st["ssd"],
            "t_conv": t_st["conv"], "t_ssd": t_st["ssd"], "pos": ((batch,), torch.int32)}


def decode_step(cfg: ModelConfig, params: Params, cache: Params,
                tokens: torch.Tensor):
    """One-token decode. tokens [B] int. Returns (logits [B, Vpad] fp32,
    cache). Per group: ``ssm_per_group`` Mamba2 layers, then the shared
    attention block on one token through K5 and the shared FFN; then the
    tail layers. The shared block's k/v and every Mamba2 state are written
    into ``cache`` IN PLACE (see ``transformer.decode_step``); the returned
    dict holds them and ``pos + 1`` as a new tensor."""
    h = cfg.hybrid
    scfg = T_single_cfg(cfg)
    pos = cache["pos"]
    T.check_pos(pos, cache["k"].shape[2])
    x = L.embed_lookup(params["embed"], tokens[:, None])
    shared = params["shared"]
    groups, tail = params["mamba_groups"], params["mamba_tail"]
    for g in range(h.num_groups):
        for i in range(h.ssm_per_group):
            x = S.decode_layer(cfg, {k: w[g, i] for k, w in groups.items()}, x,
                               cache["g_conv"][g, i], cache["g_ssd"][g, i])
        x = T.attn_decode(scfg, shared, x, cache["k"][g], cache["v"][g], pos)
        x = T.ffn_block(scfg, shared, x)
    for i in range(h.tail_ssm_layers):
        x = S.decode_layer(cfg, {k: w[i] for k, w in tail.items()}, x,
                           cache["t_conv"][i], cache["t_ssd"][i])
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = L.unembed_logits(x, params["embed"].T)
    return logits[:, 0], {**cache, "pos": pos + 1}
