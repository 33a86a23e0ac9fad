"""Parameter staging: flat ``[L, ...]`` layer params -> stage-stacked
``[N, lps, ...]`` (zero-padded: a zero-parameter transformer or Mamba2
block is an exact identity through the residual), the stage-stacked paged
KV pool and the SSM state the stage programs carry (mirrors
``repro.core.staging``; expert leaves stage as [N, lps, E, ...]; the vlm
stages as the dense family, the encdec's decoder layers as its stage
layers).

The manual tensor-parallel lowering (``ManualTP``) lives here too. The
reference maps a stage onto a group of tp chips that split each layer; on
one card the tp shards are an axis after the stage axis: ``shard_params``
lays every stage-layer leaf out as ``[N, tp, lps, ...]`` (a sharded group
cut into its shards, a replicated group stored once and broadcast over tp
with ``expand``), and the pool, the queries and the attention state fold
the shards into the batch rows (``[N, tp * B, ...]``), so every stage
program and kernel sees the LOCAL head counts the reference's chips see.
``TPLayout`` replaces the reference's ``Topology``: the tp degree and,
for the kv_split view, its (kv, qg) factors."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
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
from repro_torch.models import whisper as W

Params = Dict[str, Any]


# ------------------------------------------------- manual TP lowering plan

@dataclass(frozen=True)
class TPLayout:
    """The tp axis of one stage on the card: its degree ``tp`` and, for the
    kv_split view (the reference's ``("kv", "qg")`` TP axes), the kv-head
    factor ``kv`` (0: the plain TP axis; then ``qg`` = tp // kv)."""
    tp: int = 1
    kv: int = 0

    def __post_init__(self):
        if self.tp < 1 or (self.kv and (self.kv < 1 or self.tp % self.kv)):
            raise ValueError(f"TPLayout(tp={self.tp}, kv={self.kv}): kv must divide tp")

    @property
    def kv_split(self) -> bool:
        return self.kv > 0

    @property
    def qg(self) -> int:
        return self.tp // self.kv if self.kv else 1


@dataclass(frozen=True)
class ManualTP:
    """The manual tensor-parallel lowering (mirrors ``repro.core.staging.
    ManualTP``): which param groups are sharded over the tp axis, and so
    where the stage programs sum partials over it (a psum there). A group is
    sharded only when the split is head- or row-exact; otherwise it is
    replicated and its compute needs no reduce. ``kv_split`` / ``qg``
    replace the reference's mesh axis names: the shard index is kv-major,
    shard t = kv_i * qg + qg_i, as the reference flattens ``("kv", "qg")``."""
    tp: int
    attn: bool              # q/k/v/o head-sharded -> psum after the o-proj
    kv_div: int             # kv-head shard factor (1 when attn is False)
    ffn: bool               # dense SwiGLU f-sharded -> psum after the down-proj
    moe_ffn: bool           # expert FFN f-sharded (plain TP axis)
    moe_ep: bool            # experts sharded over the axis (kv_split view)
    shared_moe: bool        # shared-experts SwiGLU f-sharded
    kv_split: bool = False
    qg: int = 1             # kv_split: query-group factor (tp // kv)


def manual_tp_plan(cfg: ModelConfig, plan: PipelinePlan,
                   layout: Optional[TPLayout]) -> Optional[ManualTP]:
    """None unless the plan takes the manual lowering AND tp > 1; the
    decisions are the reference's ``manual_tp_plan``'s."""
    if layout is None or plan.tp_lowering != "manual" or layout.tp <= 1:
        return None
    tp = layout.tp
    kvh, h = cfg.num_kv_heads, cfg.num_heads
    if layout.kv_split:
        kv_ax, qg_ax = layout.kv, layout.qg
        attn = (kvh > 0 and kvh % kv_ax == 0
                and (h // max(kvh, 1)) % qg_ax == 0)
        kv_div = kv_ax if attn else 1
    else:
        attn = kvh > 0 and kvh % tp == 0
        kv_div = tp if attn else 1
    ffn = cfg.d_ff > 0 and cfg.d_ff % tp == 0
    moe_ffn = moe_ep = shared_moe = False
    if cfg.moe is not None:
        fe = cfg.moe.d_expert or cfg.d_ff
        if layout.kv_split:
            moe_ep = cfg.moe.num_experts % tp == 0
        else:
            moe_ffn = fe % tp == 0
        if cfg.moe.num_shared_experts:
            shared_moe = (fe * cfg.moe.num_shared_experts) % tp == 0
    if cfg.family == "ssm":
        attn, ffn = False, False
    return ManualTP(tp=tp, attn=attn, kv_div=kv_div, ffn=ffn, moe_ffn=moe_ffn,
                    moe_ep=moe_ep, shared_moe=shared_moe,
                    kv_split=layout.kv_split, qg=layout.qg)


ATTN_KEYS = ("wq", "wk", "wv", "wo", "xwq", "xwk", "xwv", "xwo")


def sharded_keys(mtp: Optional[ManualTP]) -> frozenset:
    """The param keys the plan shards (the complement of the reference's
    ``_apply_manual_tp`` strip set). Everything else is replicated: the
    embedding and head, the norms, the router, the SSM blocks."""
    if mtp is None:
        return frozenset()
    keys = set()
    if mtp.attn:
        keys |= set(ATTN_KEYS)
    if mtp.ffn:
        keys |= {"wg", "wu", "wd"}
    if mtp.moe_ffn or mtp.moe_ep:
        keys |= {"e_wg", "e_wu", "e_wd"}
    if mtp.shared_moe:
        keys |= {"s_wg", "s_wu", "s_wd"}
    return frozenset(keys)


def _shard_spec(key: str, mtp: ManualTP) -> Tuple[int, int]:
    """(axis counted from the end, shards along it) of a sharded leaf;
    every sharded group splits into tp shards, but the kv_split view's
    K/V projections split by kv head only (kv_div shards, each shared by
    the qg shards of its kv group)."""
    if key in ("wk", "wv", "xwk", "xwv"):
        return -1, mtp.kv_div
    if key in ("wq", "xwq", "wg", "wu", "s_wg", "s_wu"):
        return -1, mtp.tp
    if key in ("wo", "xwo", "wd", "s_wd"):
        return -2, mtp.tp
    if mtp.moe_ep:                       # e_wg / e_wu / e_wd: experts
        return -3, mtp.tp
    return (-2 if key == "e_wd" else -1), mtp.tp


def _shard_leaf(w: torch.Tensor, axis: int, parts: int, tp: int,
                lead: int) -> torch.Tensor:
    """``w`` cut into ``parts`` contiguous blocks along ``axis``, the block
    axis placed at dim ``lead`` and widened to tp shards (shard t takes
    block t // (tp // parts)); one contiguous copy."""
    ax = w.ndim + axis
    size = w.shape[ax]
    if size % parts:
        raise ValueError(f"axis of {size} does not split into {parts} shards")
    blocks = w.unflatten(ax, (parts, size // parts)).movedim(ax, lead)
    if parts != tp:
        blocks = blocks.unsqueeze(lead + 1).expand(
            *blocks.shape[:lead + 1], tp // parts, *blocks.shape[lead + 1:]
        ).flatten(lead, lead + 1)
    return blocks.contiguous()


def shard_group(tree: Params, mtp: ManualTP, lead: int) -> Params:
    """One param group in the tp layout: each leaf gets a tp axis at dim
    ``lead`` (1 for the stage layers [N, lps, ...], 0 for the hybrid's
    shared block): a sharded leaf is cut into its shards (a copy), a
    replicated one is broadcast (``expand``: no copy, stored once)."""
    keys = sharded_keys(mtp)
    out = {}
    for k, w in tree.items():
        if k in keys:
            axis, parts = _shard_spec(k, mtp)
            out[k] = _shard_leaf(w, axis, parts, mtp.tp, lead)
        else:
            v = w.unsqueeze(lead)
            out[k] = v.expand(*v.shape[:lead], mtp.tp, *v.shape[lead + 1:])
    return out


def shard_params(cfg: ModelConfig, staged: Params, mtp: Optional[ManualTP]) -> Params:
    """``stage_params`` / ``init_staged`` output -> the manual TP layout
    (the counterpart of the reference's ``_apply_manual_tp``): every
    stage-layer leaf [N, tp, lps, ...] (``shard_group``), the hybrid's
    shared block [tp, ...]. The embedding, the head, the final norm and
    the whisper encoder are used outside the stage programs, once for all
    shards: they stay as they are. ``mtp`` None returns ``staged``."""
    if mtp is None:
        return staged
    out = dict(staged)
    out["stage_layers"] = shard_group(staged["stage_layers"], mtp, 1)
    if cfg.family == "hybrid":
        out["shared"] = shard_group(staged["shared"], mtp, 0)
    return out


def layer_params(layers: Params, li: int, mtp: Optional[ManualTP]) -> Params:
    """Layer ``li`` of every stage: [N, ...] leaves, or under ``mtp`` a
    sharded group's [N, tp, ...] shards and a replicated group's one copy
    [N, ...]."""
    if mtp is None:
        return {k: w[:, li] for k, w in layers.items()}
    keys = sharded_keys(mtp)
    return {k: (w[:, :, li] if k in keys else w[:, 0, li]) for k, w in layers.items()}


def shared_params(shared: Params, mtp: Optional[ManualTP]) -> Params:
    """The hybrid's shared block as its programs read it: [tp, ...] shards
    of a sharded group, one copy of a replicated one."""
    if mtp is None:
        return shared
    keys = sharded_keys(mtp)
    return {k: (w if k in keys else w[0]) for k, w in shared.items()}


def check_layout(staged: Params, mtp: Optional[ManualTP]) -> None:
    """Raises unless every stage-layer leaf carries the tp axis of ``mtp``
    (dim 1 of size tp, ``shard_params``)."""
    if mtp is None:
        return
    for k, w in staged["stage_layers"].items():
        if w.ndim < 3 or w.shape[1] != mtp.tp:
            raise ValueError(f"stage_layers[{k!r}] {tuple(w.shape)}: not in the tp = "
                             f"{mtp.tp} layout (core.staging.shard_params)")


def kv_split_axes(cfg: ModelConfig, tp: int):
    """Factor the TP degree into (kv, qg) so attention shards by kv head and
    query group with no collectives (mirrors the reference's). Returns
    (kv_ax, qg_ax, padded_g): padded_g > g means q heads are zero-padded per
    kv group (``pad_q_heads``). None if the kv heads do not divide."""
    if cfg.attn_free or cfg.num_kv_heads == 0:
        return None
    kvh, h = cfg.num_kv_heads, cfg.num_heads
    g = h // kvh
    kv_ax = min(kvh, tp)
    if tp % kv_ax or kvh % kv_ax:
        return None
    qg_ax = tp // kv_ax
    g_pad = -(-g // qg_ax) * qg_ax
    return kv_ax, qg_ax, g_pad


def _pad_axis(w: torch.Tensor, axis: int, to: int) -> torch.Tensor:
    ax = w.ndim + axis if axis < 0 else axis
    extra = to - w.shape[ax]
    shape = list(w.shape)
    shape[ax] = extra
    return torch.cat([w, w.new_zeros(shape)], dim=ax)


def _layers_key(params: Params) -> str:
    return "layers" if "layers" in params else "stage_layers"


def pad_q_heads(cfg: ModelConfig, params: Params, g_pad: int) -> Tuple[ModelConfig, Params]:
    """Zero-pad the query heads of each kv group: H = kvh g -> kvh g_pad
    (mirrors the reference's). Padded heads have zero ``wq`` (uniform
    attention) and zero ``wo`` rows (no contribution): exact. Takes flat
    params (``layers`` [L, ...]) or staged ones (``stage_layers``
    [N, lps, ...])."""
    from repro_torch.configs.base import replace
    kvh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    g = cfg.num_heads // kvh
    if g_pad == g:
        return cfg, params
    key = _layers_key(params)
    lp = dict(params[key])
    wq = lp["wq"]
    wq = _pad_axis(wq.unflatten(-1, (kvh, g, hd)), -2, g_pad)
    lp["wq"] = wq.flatten(-3)
    wo = lp["wo"]
    wo = _pad_axis(wo.unflatten(-2, (kvh, g, hd)), -3, g_pad)
    lp["wo"] = wo.flatten(-4, -2)
    out = dict(params)
    out[key] = lp
    return replace(cfg, num_heads=kvh * g_pad), out


def pad_experts(cfg: ModelConfig, params: Params, e_pad: int) -> Tuple[ModelConfig, Params]:
    """Zero-pad the routed experts to ``e_pad`` for expert parallelism
    (mirrors the reference's). The padded experts' router logits are masked
    (``MoEConfig.num_real_experts``), so they are never routable: exact.
    Flat or staged params, as ``pad_q_heads``."""
    from repro_torch.configs.base import replace
    m = cfg.moe
    if m is None or e_pad == m.num_experts:
        return cfg, params
    key = _layers_key(params)
    lp = dict(params[key])
    lp["router"] = _pad_axis(lp["router"], -1, e_pad)
    for k in ("e_wg", "e_wu", "e_wd"):
        lp[k] = _pad_axis(lp[k], -3, e_pad)
    out = dict(params)
    out[key] = lp
    moe2 = dataclasses.replace(m, num_experts=e_pad, num_real_experts=m.real_experts)
    return replace(cfg, moe=moe2), out


def alloc_kv_pool(cfg: ModelConfig, plan: PipelinePlan, b: int,
                  device=None, *, mtp: Optional[ManualTP] = None
                  ) -> Optional[kvpages.PagedPool]:
    """Every stage's paged KV pool in one stage-stacked allocation:
    payloads [N, P, lps, B, pt, K, D] in the plan's storage codec (for the
    hybrid one "layer" per group: the shared block's KV). None for the
    attention-free ssm family. Under ``mtp`` each stage holds one pool a
    shard at the LOCAL kv heads (K = kvh // kv_div), the shards folded into
    the batch axis (tp * B rows, shard-major)."""
    if cfg.attn_free:
        return None
    kvh, rows = cfg.num_kv_heads, b
    if mtp is not None:
        kvh, rows = kvh // mtp.kv_div, b * mtp.tp
    return kvpages.alloc_pool(plan.page_geometry, plan.codec,
                              plan.layers_per_stage, rows, kvh,
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
    G + 1 groups are zero-padded to N x lps: leaves [N, lps, pg, ...].
    Encdec: the decoder layers are the stage layers; the encoder
    (``enc_layers``, ``enc_norm``) stays unstaged, since it runs once
    before the tick loop."""
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
    if cfg.family == "encdec":
        return {"embed": params["embed"], "final_norm": params["final_norm"],
                "stage_layers": {k: one(v) for k, v in params["dec_layers"].items()},
                "enc_layers": params["enc_layers"], "enc_norm": params["enc_norm"]}
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
    if cfg.family == "encdec":
        p = W.init(cfg, generator, device, dtype, layer_lead=(n, lps))
        p["stage_layers"] = p.pop("dec_layers")
        return p
    if cfg.family in ("dense", "moe", "vlm"):
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
