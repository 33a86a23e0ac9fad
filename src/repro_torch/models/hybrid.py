"""Zamba2-style hybrid in PyTorch, mirroring ``repro.models.hybrid``: a
Mamba2 backbone with a SHARED attention block applied once per group of SSM
layers (same weights each application, separate KV).

Layer structure (cfg.hybrid): num_groups x (ssm_per_group Mamba2 + 1 shared
attn+FFN application) + tail_ssm_layers Mamba2. Only the attention KV takes
part in MBKR (the SSM state is O(1) per layer).
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
            *, ssd_impl: str = "torch") -> torch.Tensor:
    """Full-sequence forward; returns fp32 logits [B, S, Vpad] (the head is
    the transposed embedding, as in the reference)."""
    h = cfg.hybrid
    scfg = T_single_cfg(cfg)
    x = L.embed_lookup(params["embed"], tokens)
    shared = params["shared"]
    groups, tail = params["mamba_groups"], params["mamba_tail"]
    for g in range(h.num_groups):
        for i in range(h.ssm_per_group):
            x, _ = S.block_apply(cfg, {k: w[g, i] for k, w in groups.items()}, x,
                                 ssd_impl=ssd_impl)
        x, _, _ = T.attn_block(scfg, shared, x)
        x = T.ffn_block(scfg, shared, x)
    for i in range(h.tail_ssm_layers):
        x, _ = S.block_apply(cfg, {k: w[i] for k, w in tail.items()}, x,
                             ssd_impl=ssd_impl)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed_logits(x, params["embed"].T)
