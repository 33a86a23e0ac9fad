"""Parameter staging: flat ``[L, ...]`` layer params -> stage-stacked
``[N, lps, ...]`` (zero-padded: a zero-parameter transformer or Mamba2
block is an exact identity through the residual), the stage-stacked paged
KV pool and the SSM state the stage programs carry (mirrors the dense,
moe, ssm and hybrid parts of ``repro.core.staging``; expert leaves stage as
[N, lps, E, ...])."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.plan import PipelinePlan
from repro_torch.kvstore import pages as kvpages
from repro_torch.kvstore.quant import torch_dtype
from repro_torch.models import hybrid as HY
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T

Params = Dict[str, Any]


def alloc_kv_pool(cfg: ModelConfig, plan: PipelinePlan, b: int,
                  device=None) -> Optional[kvpages.PagedPool]:
    """Every stage's paged KV pool in one stage-stacked allocation:
    payloads [N, P, lps, B, pt, K, D] in the plan's storage codec (for the
    hybrid one "layer" per group: the shared block's KV). None for the
    attention-free ssm family."""
    if cfg.attn_free:
        return None
    return kvpages.alloc_pool(plan.page_geometry, plan.codec,
                              plan.layers_per_stage, b, cfg.num_kv_heads,
                              cfg.resolved_head_dim, stages=plan.num_stages,
                              device=device)


def alloc_ssm_state(cfg: ModelConfig, plan: PipelinePlan, b: int,
                    device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (conv, ssd) state every stage carries from tick to tick, fp32
    zeros: [N, lps, B, K-1, conv_ch] and [N, lps, B, H, P, N_state], with
    a pg axis after lps for the hybrid (lps groups of pg layers)."""
    s = cfg.ssm
    _, nheads, conv_ch = S.dims(cfg)
    lead = (plan.num_stages, plan.layers_per_stage)
    if cfg.family == "hybrid":
        lead += (cfg.hybrid.ssm_per_group,)
    conv = torch.zeros(lead + (b, s.conv_kernel - 1, conv_ch), device=device)
    ssd = torch.zeros(lead + (b, nheads, s.head_dim, s.d_state), device=device)
    return conv, ssd


def stage_params(cfg: ModelConfig, params: Params, plan: PipelinePlan) -> Params:
    """Restack flat [L, ...] layer params into [N, lps, ...] (zero-padded).
    Embedding, head, final norm and the hybrid's shared block stay as they
    are (one copy serves every stage on the one device). Hybrid: the tail
    becomes pseudo-group G, zero-padded to ssm_per_group layers, and the
    G + 1 groups are zero-padded to N x lps: leaves [N, lps, pg, ...]."""
    n, lps = plan.num_stages, plan.layers_per_stage

    def pad_to(a: torch.Tensor, rows: int) -> torch.Tensor:
        pad = rows - a.shape[0]
        return torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))]) if pad else a

    def one(a: torch.Tensor) -> torch.Tensor:
        return pad_to(a, n * lps).reshape((n, lps) + tuple(a.shape[1:]))

    if cfg.family == "hybrid":
        pg = cfg.hybrid.ssm_per_group

        def fold(g: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
            return one(torch.cat([g, pad_to(t, pg)[None]]))      # [G+1, pg, ...]
        tail = params["mamba_tail"]
        return {"embed": params["embed"], "final_norm": params["final_norm"],
                "stage_layers": {k: fold(g, tail[k])
                                 for k, g in params["mamba_groups"].items()},
                "shared": params["shared"]}
    out = {"embed": params["embed"], "final_norm": params["final_norm"],
           "stage_layers": {k: one(v) for k, v in params["layers"].items()}}
    if "lm_head" in params:
        out["lm_head"] = params["lm_head"]
    return out


def init_staged(cfg: ModelConfig, plan: PipelinePlan,
                generator: torch.Generator, device=None, dtype=None) -> Params:
    """Random weights (the families' ``init``) drawn directly into the
    staged layout — no flat copy, so a full-width model needs its weights'
    memory once. Padded layers and groups are zero, as ``stage_params``
    makes them."""
    n, lps = plan.num_stages, plan.layers_per_stage
    if cfg.family in ("dense", "moe"):
        p = T.init(cfg, generator, device, dtype, layer_lead=(n, lps))
        out = {"embed": p["embed"], "final_norm": p["final_norm"],
               "stage_layers": p["layers"]}
        if "lm_head" in p:
            out["lm_head"] = p["lm_head"]
        return out
    dt = torch_dtype(dtype or cfg.dtype)
    out = {"embed": L.init_embed(cfg.vocab_size, cfg.d_model, generator, device, dt),
           "final_norm": torch.ones((cfg.d_model,), device=device, dtype=dt)}
    if cfg.family == "ssm":
        layers = S.init_block(cfg, generator, (n, lps), nl=cfg.num_layers,
                              device=device, dtype=dtype)
        for w in layers.values():
            w.view(n * lps, *w.shape[2:])[cfg.num_layers:] = 0
        out["stage_layers"] = layers
        return out
    h = cfg.hybrid
    pg = h.ssm_per_group
    groups = S.init_block(cfg, generator, (n, lps, pg),
                          nl=h.num_groups * pg, device=device, dtype=dtype)
    tail = S.init_block(cfg, generator, (h.tail_ssm_layers,),
                        nl=h.tail_ssm_layers, device=device, dtype=dtype)
    for k, w in groups.items():
        flat = w.view(n * lps, pg, *w.shape[3:])
        flat[h.num_groups:] = 0
        flat[h.num_groups, :h.tail_ssm_layers] = tail[k]
    del tail
    out["stage_layers"] = groups
    out["shared"] = T.init_layers(HY.T_single_cfg(cfg), generator, device, dtype)
    return out
