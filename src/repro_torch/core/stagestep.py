"""The stage programs: what every stage computes in one pipeline tick
(mirrors ``repro.core.stagestep``): ``tfm_stage_step`` for the dense, MoE
and vlm transformers and the whisper decoder (its cross-attention against
the encoder's K/V), ``ssm_stage_step`` for Mamba2 (conv/SSD state carried tick to
tick) and ``hybrid_stage_step`` for Zamba2 (SSM groups plus a shared
attention block whose KV takes part in MBKR, one pool "layer" per group).

The reference runs one stage per chip; here all N stages run in lockstep as
a leading tensor axis. Activations are [N, B, C, d]; projections are
batched products over the stage axis ([N, B*C, d] x [N, d, q]); attention
folds the stage axis into the batch (N*B rows), so one kernel launch per
(layer, tick) covers every stage. ``StageCtx`` carries the per-stage
scalars as host-side numpy arrays of shape [N]: the phases are known on the
host before a tick runs, so gating needs no device round trip.

Every program threads the CollectiveLedger (``led``) and the stage
telemetry (``tel``, ``obs.telemetry``), both host-side; a None one is
not charged.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import costmodel as cm
from repro_torch.core import remote
from repro_torch.core.attention import (attn_finish, attn_init, get_backend,
                                        group_queries, pool_scan)
from repro_torch.core.plan import PipelinePlan
from repro_torch.core.transport import Ledger, StageAxisTransport
from repro_torch.kvstore.pages import PagedPool
from repro_torch.models import hybrid as HY
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.obs import telemetry as obs_t
from repro_torch.obs.telemetry import StageTelemetry

Params = Dict[str, Any]


@dataclass
class StageCtx:
    """Per-tick context: ``stage``, ``phase`` and ``first_half`` are [N]."""
    cfg: ModelConfig
    plan: PipelinePlan
    stage: np.ndarray         # [N] stage ids
    phase: np.ndarray         # [N] chunk index of each stage this tick (may be OOR)
    first_half: np.ndarray    # [N] bool: stage < N/2
    scale: float
    transport: StageAxisTransport
    # hit-prefix length (chunks): the first k chunks' own pages come from
    # ``prefix_pool``, the cached prefix KV (``kvstore.prefix``), and their
    # recomputed KV goes to the scratch slot. 0 = the prefix path is off
    prefix_chunks: int = 0
    prefix_pool: Optional[PagedPool] = None

    @property
    def active(self) -> np.ndarray:
        """[N] the stage's phase is a real chunk (not fill/drain garbage)."""
        return (self.phase >= 0) & (self.phase < self.plan.num_chunks)


def attend_chunk(ctx: StageCtx, l_idx: int, q: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor, pool,
                 led: Ledger = None, tel: StageTelemetry = None):
    """Full MOCAP attention for one layer of every stage's current chunk:
    own-pool prefix + remote prefix + causal self block. q [N*B, C, H, D];
    k_new / v_new [N*B, C, K, D]. The self block runs ``plan.attn_backend``;
    every pool-sourced partial runs ``plan.pool_backend``. Returns (att,
    ledger, telemetry).

    Telemetry, as the reference charges it per stage: ``attn_work`` at each
    stage's prefix (active stages), and ``launches`` = the backend's block
    invocations a stage makes: the pool scan (one with a ``batched_pool``
    backend, else one per slot), the remote prefix, the self block."""
    plan = ctx.plan
    backend = get_backend(plan.attn_backend)
    pool_be = (backend if plan.pool_backend == plan.attn_backend
               else get_backend(plan.pool_backend))
    gb, c, h, d = q.shape
    kvh = k_new.shape[2]
    qg = group_queries(q, kvh)
    st = attn_init(gb, c, kvh, h // kvh, d, device=q.device)
    pool_l = remote._pool_layer(pool, l_idx)
    if tel is not None:
        prefix = np.clip(ctx.phase, 0, plan.num_chunks - 1) * c
        tel = obs_t.charge(tel, "attn_work", cm.attn_flops(ctx.cfg, c, prefix),
                           ctx.active)

    # 1. own local prefix: chunks j < min(phase, p2)
    st = pool_scan(pool_be, qg, pool_l, plan.slot_pages, plan.slot_own_chunk,
                   np.minimum(ctx.phase, plan.p2), ctx.scale, st)
    tel = obs_t.charge(tel, "launches",
                       1.0 if pool_be.batched_pool else float(plan.num_slots))
    # 2. remote prefix: chunks p2 <= j < phase live at the pair
    if plan.p2 < plan.num_chunks and plan.mode == "mocap":
        if plan.remote_attn == "fetch":
            st, led, tel = remote.fetch_remote(ctx, pool_be, qg, pool_l, st, led, tel)
        else:
            st, led, tel = remote.qship_remote(ctx, pool_be, qg, pool_l, st, led, tel)
    # 3. causal self block
    st = backend.self_block(qg, k_new, v_new, ctx.scale, st)
    tel = obs_t.charge(tel, "launches", 1.0)
    return attn_finish(st, q.dtype), led, tel


def _stage_w(w: torch.Tensor, ndim: int) -> torch.Tensor:
    """A per-stage vector [N, f] shaped to broadcast against [N, ..., f]."""
    return w.reshape(w.shape[0], *([1] * (ndim - 2)), w.shape[-1])


def _rope(ctx: StageCtx, x: torch.Tensor):
    """cos, sin [N*B, C, half] at every stage's positions this tick."""
    n, b, c, _ = x.shape
    plan = ctx.plan
    positions = (np.clip(ctx.phase, 0, plan.num_chunks - 1)[:, None]
                 * plan.chunk_len + np.arange(c)[None, :])       # [N, C]
    cos, sin = L.rope_angles(torch.as_tensor(positions, device=x.device),
                             ctx.cfg.resolved_head_dim, ctx.cfg.rope_theta)
    return cos.repeat_interleave(b, dim=0), sin.repeat_interleave(b, dim=0)


def _stack_kv(ks, vs, n: int, b: int):
    """Per-layer [N*B, C, K, D] lists -> [N, lps, B, C, K, D] each."""
    def one(xs):
        return torch.stack(xs, dim=1).reshape(n, b, len(xs), *xs[0].shape[1:]).transpose(1, 2)
    return one(ks), one(vs)


def stage_qkv(cfg: ModelConfig, lp: Params, x: torch.Tensor, cos, sin):
    """The attention block's inputs of one layer at every stage: rms_norm,
    the q/k/v projections, qk-norm and RoPE. ``lp`` leaves are [N, ...];
    x [N, B, C, d]. Returns q [N*B, C, H, D], k / v [N*B, C, K, D]."""
    n, b, c, dm = x.shape
    hd = cfg.resolved_head_dim
    hn = L.rms_norm(x, _stage_w(lp["ln1"], 4), cfg.norm_eps).reshape(n, b * c, dm)
    q = torch.matmul(hn, lp["wq"]).reshape(n, b, c, -1, hd)
    k = torch.matmul(hn, lp["wk"]).reshape(n, b, c, -1, hd)
    v = torch.matmul(hn, lp["wv"]).reshape(n, b, c, -1, hd)
    if cfg.qk_norm:
        q = L.rms_norm(q, _stage_w(lp["q_norm"], 5), cfg.norm_eps)
        k = L.rms_norm(k, _stage_w(lp["k_norm"], 5), cfg.norm_eps)
    q = L.apply_rope(q.flatten(0, 1), cos, sin)
    k = L.apply_rope(k.flatten(0, 1), cos, sin)
    return q, k, v.flatten(0, 1)


def stage_out(cfg: ModelConfig, lp: Params, x: torch.Tensor,
              att: torch.Tensor) -> torch.Tensor:
    """The o-projection of the attention output ``att`` [N*B, C, H, D] of
    one layer at every stage, added into the residual x [N, B, C, d]."""
    n, b, c, dm = x.shape
    upd = torch.matmul(att.reshape(n, b * c, -1), lp["wo"])
    return x + cfg.residual_multiplier * upd.reshape(n, b, c, dm)


def stage_ffn(cfg: ModelConfig, lp: Params, x: torch.Tensor) -> torch.Tensor:
    """The FFN block of one layer at every stage (``transformer.ffn_out``:
    SwiGLU; or, moe, each (stage, row) dispatching its chunk's C tokens to
    its stage's experts, so capacity is per chunk, as in the reference's
    stage program)."""
    hn = L.rms_norm(x, _stage_w(lp["ln2"], 4), cfg.norm_eps)
    return x + cfg.residual_multiplier * T.ffn_out(cfg, lp, hn)


def stage_out_ffn(cfg: ModelConfig, lp: Params, x: torch.Tensor,
                  att: torch.Tensor) -> torch.Tensor:
    """The rest of one layer at every stage: ``stage_out``, then
    ``stage_ffn``."""
    return stage_ffn(cfg, lp, stage_out(cfg, lp, x, att))


def cross_attend(ctx: StageCtx, lp: Params, x: torch.Tensor, xk: torch.Tensor,
                 xv: torch.Tensor, tel: StageTelemetry = None):
    """The whisper decoder's cross-attention of one layer at every stage:
    ``lnx`` norm, ``xwq``, the chunk's C queries against the stage's F
    encoder keys (non-causal), ``xwo`` and the residual add. x [N, B, C, d];
    xk / xv [N*B, F, KVH, D]. The attention is the plan's backend's
    ``full_block``: K1 non-causal (``ops.full_attention``) under ``cuda``.
    Telemetry: one ``launches`` a stage, as the reference charges it.
    Returns (x, telemetry)."""
    cfg = ctx.cfg
    n, b, c, dm = x.shape
    hn = L.rms_norm(x, _stage_w(lp["lnx"], 4), cfg.norm_eps).reshape(n, b * c, dm)
    q = torch.matmul(hn, lp["xwq"]).reshape(n * b, c, -1, cfg.resolved_head_dim)
    att = get_backend(ctx.plan.attn_backend).full_block(q, xk, xv)
    upd = torch.matmul(att.reshape(n, b * c, -1), lp["xwo"])
    return x + upd.reshape(n, b, c, dm), obs_t.charge(tel, "launches", 1.0)


def tfm_stage_step(ctx: StageCtx, layers: Params, x: torch.Tensor, pool,
                   led: Ledger = None, tel: StageTelemetry = None, *,
                   cross=None):
    """Apply every stage's lps layers to its chunk ``ctx.phase``.
    ``layers`` leaves are [N, lps, ...]; x [N, B, C, d]. ``cross``: the
    whisper decoder's (xk, xv), each [N, lps, B, F, KVH, D] with every
    layer's slice ``[:, li]`` contiguous (``pipeline.stage_cross_kv``).
    Returns (x_out, pool, ledger, telemetry); the pool is updated in
    place."""
    n, b = x.shape[:2]
    cos, sin = _rope(ctx, x)
    ks, vs = [], []
    for li in range(ctx.plan.layers_per_stage):
        lp = {k: w[:, li] for k, w in layers.items()}
        q, k, v = stage_qkv(ctx.cfg, lp, x, cos, sin)
        att, led, tel = attend_chunk(ctx, li, q, k, v, pool, led, tel)
        if cross is None:
            x = stage_out_ffn(ctx.cfg, lp, x, att)
        else:
            xk, xv = (t[:, li].reshape(n * b, *t.shape[3:]) for t in cross)
            x, tel = cross_attend(ctx, lp, stage_out(ctx.cfg, lp, x, att), xk, xv, tel)
            x = stage_ffn(ctx.cfg, lp, x)
        ks.append(k)
        vs.append(v)
    pool, led, tel = remote.write_pools(ctx, pool, *_stack_kv(ks, vs, n, b), led, tel)
    return x, pool, led, tel


def _mamba(ctx: StageCtx, lp: Params, x: torch.Tensor, conv: torch.Tensor,
           ssd: torch.Tensor) -> torch.Tensor:
    """One Mamba2 layer of every stage. ``conv`` / ``ssd`` are this layer's
    [N, B, ...] state views, updated in place; a stage at phase <= 0 (the
    start of its request, or a bubble tick before it) starts from zeros."""
    fresh = np.flatnonzero(ctx.phase <= 0)
    if fresh.size:
        idx = torch.as_tensor(fresh, device=x.device)
        conv[idx] = 0
        ssd[idx] = 0
    x, st = S.block_apply(ctx.cfg, lp, x, state={"conv": conv, "ssd": ssd},
                          ssd_impl=ctx.plan.ssm_backend)
    conv.copy_(st["conv"])
    ssd.copy_(st["ssd"])
    return x


def ssm_stage_step(ctx: StageCtx, layers: Params, x: torch.Tensor, state,
                   led: Ledger = None, tel: StageTelemetry = None):
    """Mamba2 stage: every stage's lps blocks over its chunk, the (conv,
    ssd) state [N, lps, B, ...] carried tick to tick (updated in place).
    The SSD inner loop routes through ``plan.ssm_backend``. No pool and no
    transfer: the ledger passes through. Telemetry: ``attn_work`` (the
    cost model's SSD work), and lps ``launches`` a stage under the ``cuda``
    SSD (K4). Returns (x_out, state, ledger, telemetry)."""
    lps = ctx.plan.layers_per_stage
    tel = obs_t.charge(tel, "attn_work",
                       lps * cm.attn_flops(ctx.cfg, x.shape[2], 0), ctx.active)
    if ctx.plan.ssm_backend == "cuda":
        tel = obs_t.charge(tel, "launches", float(lps))
    conv, ssd = state
    for li in range(lps):
        x = _mamba(ctx, {k: w[:, li] for k, w in layers.items()}, x,
                   conv[:, li], ssd[:, li])
    return x, state, led, tel


def hybrid_stage_step(ctx: StageCtx, groups: Params, shared: Params,
                      x: torch.Tensor, state, pool, led: Ledger = None,
                      tel: StageTelemetry = None):
    """Zamba2 stage = lps groups of (pg Mamba2 + the shared attention
    block). ``groups`` leaves are [N, lps, pg, ...]; ``shared`` is one
    unstacked transformer layer; state [N, lps, pg, B, ...]. The shared
    block's update and FFN apply only where the group is real (global group
    id stage * lps + gi < num_groups); its K/V are written for every group,
    the tail pseudo-group and the padding included, as in the reference.
    Telemetry as the reference charges it: the shared block's attention
    (``attend_chunk``) and its pool writes; the Mamba2 layers charge none.
    Returns (x_out, state, pool, ledger, telemetry); state and pool update
    in place."""
    cfg, plan = ctx.cfg, ctx.plan
    scfg = HY.T_single_cfg(cfg)
    n, b, c, dm = x.shape
    hd = cfg.resolved_head_dim
    cos, sin = _rope(ctx, x)
    conv, ssd = state
    ks, vs = [], []
    for gi in range(plan.layers_per_stage):
        for li in range(cfg.hybrid.ssm_per_group):
            x = _mamba(ctx, {k: w[:, gi, li] for k, w in groups.items()}, x,
                       conv[:, gi, li], ssd[:, gi, li])
        has_attn = torch.as_tensor(ctx.stage * plan.layers_per_stage + gi
                                   < cfg.hybrid.num_groups,
                                   device=x.device).reshape(n, 1, 1, 1)
        hn = L.rms_norm(x, shared["ln1"], cfg.norm_eps).reshape(n, b * c, dm)
        q = torch.matmul(hn, shared["wq"]).reshape(n * b, c, -1, hd)
        k = torch.matmul(hn, shared["wk"]).reshape(n * b, c, -1, hd)
        v = torch.matmul(hn, shared["wv"]).reshape(n * b, c, -1, hd)
        q = L.apply_rope(q, cos, sin)
        k = L.apply_rope(k, cos, sin)
        att, led, tel = attend_chunk(ctx, gi, q, k, v, pool, led, tel)
        upd = torch.matmul(att.reshape(n, b * c, -1), shared["wo"])
        x = x + torch.where(has_attn, upd.reshape(n, b, c, dm), 0.0)
        ffn = T.ffn_block(scfg, shared, x) - x            # isolate the update
        x = x + torch.where(has_attn, ffn, 0.0)
        ks.append(k)
        vs.append(v)
    pool, led, tel = remote.write_pools(ctx, pool, *_stack_kv(ks, vs, n, b), led, tel)
    return x, state, pool, led, tel
