"""Parameter staging: flat ``[L, ...]`` layer params -> stage-stacked
``[N, lps, ...]`` (zero-padded: a zero-parameter block is an exact identity
through the residual), and the stage-stacked paged KV pool (mirrors the
dense subset of ``repro.core.staging``)."""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.plan import PipelinePlan
from repro_torch.kvstore import pages as kvpages
from repro_torch.models import transformer as T

Params = Dict[str, Any]


def alloc_kv_pool(cfg: ModelConfig, plan: PipelinePlan, b: int,
                  device=None) -> kvpages.PagedPool:
    """Every stage's paged KV pool in one stage-stacked allocation:
    payloads [N, P, lps, B, pt, K, D] in the plan's storage codec."""
    return kvpages.alloc_pool(plan.page_geometry, plan.codec,
                              plan.layers_per_stage, b, cfg.num_kv_heads,
                              cfg.resolved_head_dim, stages=plan.num_stages,
                              device=device)


def stage_params(cfg: ModelConfig, params: Params, plan: PipelinePlan) -> Params:
    """Restack flat [L, ...] layer params into [N, lps, ...] (zero-padded).
    Embedding, head and final norm stay as they are (one copy serves every
    stage on the one device)."""
    n, lps = plan.num_stages, plan.layers_per_stage

    def one(a: torch.Tensor) -> torch.Tensor:
        pad = n * lps - a.shape[0]
        if pad:
            a = torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])
        return a.reshape((n, lps) + tuple(a.shape[1:]))

    out = {"embed": params["embed"], "final_norm": params["final_norm"],
           "stage_layers": {k: one(v) for k, v in params["layers"].items()}}
    if "lm_head" in params:
        out["lm_head"] = params["lm_head"]
    return out


def init_staged(cfg: ModelConfig, plan: PipelinePlan,
                generator: torch.Generator, device=None, dtype=None) -> Params:
    """Random weights (``models.transformer.init``) drawn directly into the
    staged layout — no flat copy, so a full-width model needs its weights'
    memory once."""
    p = T.init(cfg, generator, device, dtype,
               layer_lead=(plan.num_stages, plan.layers_per_stage))
    out = {"embed": p["embed"], "final_norm": p["final_norm"],
           "stage_layers": p["layers"]}
    if "lm_head" in p:
        out["lm_head"] = p["lm_head"]
    return out
