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

Under the manual TP lowering (``ctx.mtp``, ``core.staging.ManualTP``) a
stage is tp chips that split each layer, emulated as a tp axis: the
residual stream [N, B, C, d] is replicated (stored once), a sharded
group's projections give [N, tp, ...] shards, attention runs on the
LOCAL heads with the shards folded into the batch rows (N * tp * B), and
the programs insert the reference's psums (``transport.tp_psum``, a sum
over the tp axis charged to the ledger's ``tp`` key): one after each
attention o-projection (and whisper's cross-attention ``xwo``), one after
each FFN whose parts are sharded.
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
from repro_torch.core.staging import (ManualTP, layer_params, shared_params)
from repro_torch.core.transport import Ledger, StageAxisTransport, charge, nbytes
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
    mtp: Optional[ManualTP] = None   # the manual TP lowering (None: tp = 1)

    @property
    def active(self) -> np.ndarray:
        """[N] the stage's phase is a real chunk (not fill/drain garbage)."""
        return (self.phase >= 0) & (self.phase < self.plan.num_chunks)

    @property
    def tp(self) -> int:
        return 1 if self.mtp is None else self.mtp.tp


def tp_apply(ctx: StageCtx) -> Optional[T.ManualTPApply]:
    """The FFN's manual-TP hooks (the reduce closure is ledger-free; the
    programs charge its bytes where they call it, as the reference)."""
    if ctx.mtp is None:
        return None
    tr = ctx.transport
    return T.manual_tp_apply(ctx.mtp, lambda y: tr.tp_psum(y)[0])


def _ffn_reduced(cfg: ModelConfig, tpa: Optional[T.ManualTPApply]) -> bool:
    """The reference's condition for the FFN's one psum: some part of this
    config's FFN is sharded (dense; or the experts, or present shared
    experts)."""
    return tpa is not None and (
        tpa.dense if cfg.moe is None else
        (tpa.moe or (cfg.moe.num_shared_experts > 0 and tpa.shared)))


def _psum_bytes(ctx: StageCtx, x: torch.Tensor) -> float:
    """Ring all-reduce bytes of one tp psum of a residual-shaped x
    [N, ...]: 2(k-1)/k of one chip's [B, C, d] partial, times the stage's
    tp chips."""
    k = ctx.tp
    return 2.0 * (k - 1) / k * nbytes(x) * k


def attend_chunk(ctx: StageCtx, l_idx: int, q: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor, pool,
                 led: Ledger = None, tel: StageTelemetry = None):
    """Full MOCAP attention for one layer of every stage's current chunk:
    own-pool prefix + remote prefix + causal self block. q [N*B, C, H, D];
    k_new / v_new [N*B, C, K, D] (under the manual TP lowering N*tp*B
    rows at the local head counts). The self block runs ``plan.attn_backend``;
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
    """cos, sin [N, C, half] at every stage's positions this tick."""
    n, b, c, _ = x.shape
    plan = ctx.plan
    positions = (np.clip(ctx.phase, 0, plan.num_chunks - 1)[:, None]
                 * plan.chunk_len + np.arange(c)[None, :])       # [N, C]
    return L.rope_angles(torch.as_tensor(positions, device=x.device),
                         ctx.cfg.resolved_head_dim, ctx.cfg.rope_theta)


def _stack_kv(ks, vs, n: int, b: int):
    """Per-layer [N*B, C, K, D] lists -> [N, lps, B, C, K, D] each."""
    def one(xs):
        return torch.stack(xs, dim=1).reshape(n, b, len(xs), *xs[0].shape[1:]).transpose(1, 2)
    return one(ks), one(vs)


def _shards(hn: torch.Tensor, mtp: Optional[ManualTP]) -> torch.Tensor:
    """The normed input of a sharded group's projections: [N, rows, d] ->
    [N, tp, rows, d], one copy a shard (a product batched over (N, tp))."""
    n, r, d = hn.shape
    return hn.unsqueeze(1).expand(n, mtp.tp, r, d).contiguous()


def qkv_heads(cfg: ModelConfig, lp: Params, hn: torch.Tensor, b: int, keys,
              mtp: Optional[ManualTP] = None):
    """The projections ``keys`` of the normed input hn [N, B*C, d] as
    heads [N, T, B, C, heads, D]: T = tp for a head-sharded group under
    the manual TP lowering (its leaves [N, tp, d, q]), else 1."""
    n, rows, _ = hn.shape
    hd = cfg.resolved_head_dim
    if mtp is not None and mtp.attn:
        hn = _shards(hn, mtp)
    out = []
    for key in keys:
        y = torch.matmul(hn, lp[key])
        out.append(y.reshape(n, -1, b, rows // b, y.shape[-1] // hd, hd))
    return out


def fold_shards(x: torch.Tensor, tp: int) -> torch.Tensor:
    """[N, T, B, ...] -> [N * tp * B, ...]: the shards folded into the
    batch rows, stage-major then shard-major; a replicated x (T = 1 < tp)
    is broadcast to every shard (a copy: each shard's attention reads its
    own rows, as each chip holds its own)."""
    if x.shape[1] != tp:
        x = x.expand(x.shape[0], tp, *x.shape[2:])
    return x.reshape(-1, *x.shape[3:])


def rope_fold(q, k, v, cos, sin, b: int, tp: int):
    """RoPE on q and k [N, T, B, C, heads, D] at per-stage angles cos /
    sin [N, C, half] (or shared ones [C, half]), then every tensor folded
    to [N*tp*B, C, heads, D] (``fold_shards``)."""
    n, rows = q.shape[0], q.shape[1] * b
    if cos.ndim == 3:                   # one row of angles a query row
        cos, sin = cos.repeat_interleave(rows, 0), sin.repeat_interleave(rows, 0)
    q = L.apply_rope(q.flatten(0, 2), cos, sin).unflatten(0, (n, -1, b))
    k = L.apply_rope(k.flatten(0, 2), cos, sin).unflatten(0, (n, -1, b))
    return fold_shards(q, tp), fold_shards(k, tp), fold_shards(v, tp)


def stage_qkv(cfg: ModelConfig, lp: Params, x: torch.Tensor, cos, sin,
              mtp: Optional[ManualTP] = None):
    """The attention block's inputs of one layer at every stage: rms_norm,
    the q/k/v projections, qk-norm and RoPE. ``lp`` leaves are [N, ...]
    (a head-sharded group's [N, tp, ...] under ``mtp``); x [N, B, C, d];
    cos / sin [N, C, half] (each stage's positions) or [C, half] (shared).
    Returns q [N*T*B, C, H, D], k / v [N*T*B, C, K, D] at the local head
    counts, T = tp under ``mtp`` (else 1)."""
    n, b, c, dm = x.shape
    hn = L.rms_norm(x, _stage_w(lp["ln1"], 4), cfg.norm_eps).reshape(n, b * c, dm)
    q, k, v = qkv_heads(cfg, lp, hn, b, ("wq", "wk", "wv"), mtp)
    if cfg.qk_norm:
        q = L.rms_norm(q, _stage_w(lp["q_norm"], 6), cfg.norm_eps)
        k = L.rms_norm(k, _stage_w(lp["k_norm"], 6), cfg.norm_eps)
    return rope_fold(q, k, v, cos, sin, b, 1 if mtp is None else mtp.tp)


def tp_out(ctx: Optional[StageCtx], w: torch.Tensor, att: torch.Tensor,
           n: int, led: Ledger = None, mtp: Optional[ManualTP] = None):
    """The output projection ``w`` of the attention output att
    [N*T*B, C, H, D] -> [N, B*C, d]. Head-sharded (``mtp.attn``): each
    shard's partial [N, tp, B*C, d] against its own rows of ``w``
    [N, tp, H*D, d] (or the hybrid's [tp, H*D, d]), then the psum over
    the shards, charged to the ledger where ``ctx`` is given, under each
    stage's ``active`` flag. Replicated: the shards' outputs are copies,
    so shard 0's goes through the one ``w``. Returns (update, ledger)."""
    tp = 1 if mtp is None else mtp.tp
    a = att.reshape(n, tp, -1, att.shape[-2] * att.shape[-1])
    if mtp is None or not mtp.attn:
        return torch.matmul(a[:, 0], w), led
    part = torch.matmul(a, w)
    if ctx is None:
        return part.sum(dim=1), led
    return ctx.transport.tp_psum(part, led, active=ctx.active)


def stage_out(cfg: ModelConfig, lp: Params, x: torch.Tensor,
              att: torch.Tensor, ctx: Optional[StageCtx] = None,
              led: Ledger = None, mtp: Optional[ManualTP] = None):
    """The o-projection of the attention output ``att`` [N*T*B, C, H, D]
    of one layer at every stage (``tp_out``: its psum under ``mtp``),
    added into the residual x [N, B, C, d]. Returns (x, ledger)."""
    n, b, c, dm = x.shape
    upd, led = tp_out(ctx, lp["wo"], att, n, led, mtp)
    return x + cfg.residual_multiplier * upd.reshape(n, b, c, dm), led


def stage_ffn(cfg: ModelConfig, lp: Params, x: torch.Tensor,
              tpa: Optional[T.ManualTPApply] = None) -> torch.Tensor:
    """The FFN block of one layer at every stage (``transformer.ffn_out``:
    SwiGLU; or, moe, each (stage, row) dispatching its chunk's C tokens to
    its stage's experts, so capacity is per chunk, as in the reference's
    stage program; ``tpa``: the manual TP lowering's partials and their
    one reduce)."""
    hn = L.rms_norm(x, _stage_w(lp["ln2"], 4), cfg.norm_eps)
    return x + cfg.residual_multiplier * T.ffn_out(cfg, lp, hn, tpa)


def _ffn_charged(cfg: ModelConfig, lp: Params, x: torch.Tensor,
                 ctx: Optional[StageCtx], led: Ledger,
                 tpa: Optional[T.ManualTPApply]):
    """``stage_ffn``, its psum (``tpa``) charged to the ledger under the
    reference's condition where ``ctx`` is given. Returns (x, ledger)."""
    x = stage_ffn(cfg, lp, x, tpa)
    if ctx is not None and _ffn_reduced(cfg, tpa):
        led = charge(led, "tp", _psum_bytes(ctx, x), ctx.active)
    return x, led


def stage_out_ffn(cfg: ModelConfig, lp: Params, x: torch.Tensor,
                  att: torch.Tensor, ctx: Optional[StageCtx] = None,
                  led: Ledger = None, mtp: Optional[ManualTP] = None,
                  tpa: Optional[T.ManualTPApply] = None):
    """The rest of one layer at every stage: ``stage_out``, then
    ``stage_ffn``, their psums charged where ``ctx`` is given. Returns (x,
    ledger)."""
    x, led = stage_out(cfg, lp, x, att, ctx, led, mtp)
    return _ffn_charged(cfg, lp, x, ctx, led, tpa)


def cross_attend(ctx: StageCtx, lp: Params, x: torch.Tensor, xk: torch.Tensor,
                 xv: torch.Tensor, led: Ledger = None, tel: StageTelemetry = None):
    """The whisper decoder's cross-attention of one layer at every stage:
    ``lnx`` norm, ``xwq``, the chunk's C queries against the stage's F
    encoder keys (non-causal), ``xwo`` and the residual add. x [N, B, C, d];
    xk / xv [N*T*B, F, KVH, D] (T = tp under the manual TP lowering, at the
    local heads; ``xwo``'s psum then, charged to the ledger). The attention
    is the plan's backend's ``full_block``: K1 non-causal
    (``ops.full_attention``) under ``cuda``. Telemetry: one ``launches`` a
    stage, as the reference charges it. Returns (x, ledger, telemetry)."""
    cfg, mtp = ctx.cfg, ctx.mtp
    n, b, c, dm = x.shape
    hn = L.rms_norm(x, _stage_w(lp["lnx"], 4), cfg.norm_eps).reshape(n, b * c, dm)
    (q,) = qkv_heads(cfg, lp, hn, b, ("xwq",), mtp)
    att = get_backend(ctx.plan.attn_backend).full_block(fold_shards(q, ctx.tp), xk, xv)
    upd, led = tp_out(ctx, lp["xwo"], att, n, led, mtp)
    return x + upd.reshape(n, b, c, dm), led, obs_t.charge(tel, "launches", 1.0)


def tfm_stage_step(ctx: StageCtx, layers: Params, x: torch.Tensor, pool,
                   led: Ledger = None, tel: StageTelemetry = None, *,
                   cross=None):
    """Apply every stage's lps layers to its chunk ``ctx.phase``.
    ``layers`` leaves are [N, lps, ...] ([N, tp, lps, ...] under the manual
    TP lowering, ``core.staging.shard_params``); x [N, B, C, d]. ``cross``:
    the whisper decoder's (xk, xv), each [N, lps, T*B, F, KVH, D] with
    every layer's slice ``[:, li]`` contiguous (``pipeline.stage_cross_kv``).
    Returns (x_out, pool, ledger, telemetry); the pool is updated in
    place."""
    n, b = x.shape[:2]
    mtp = ctx.mtp
    tpa = tp_apply(ctx)
    cos, sin = _rope(ctx, x)
    ks, vs = [], []
    for li in range(ctx.plan.layers_per_stage):
        lp = layer_params(layers, li, mtp)
        q, k, v = stage_qkv(ctx.cfg, lp, x, cos, sin, mtp)
        att, led, tel = attend_chunk(ctx, li, q, k, v, pool, led, tel)
        x, led = stage_out(ctx.cfg, lp, x, att, ctx, led, mtp)
        if cross is not None:
            xk, xv = (t[:, li].reshape(-1, *t.shape[3:]) for t in cross)
            x, led, tel = cross_attend(ctx, lp, x, xk, xv, led, tel)
        x, led = _ffn_charged(ctx.cfg, lp, x, ctx, led, tpa)
        ks.append(k)
        vs.append(v)
    pool, led, tel = remote.write_pools(ctx, pool, *_stack_kv(ks, vs, n, ctx.tp * b),
                                        led, tel)
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
    transfer: the ledger passes through (the manual TP lowering shards
    nothing here, as in the reference). Telemetry: ``attn_work`` (the
    cost model's SSD work), and lps ``launches`` a stage under the ``cuda``
    SSD (K4). Returns (x_out, state, ledger, telemetry)."""
    lps = ctx.plan.layers_per_stage
    tel = obs_t.charge(tel, "attn_work",
                       lps * cm.attn_flops(ctx.cfg, x.shape[2], 0), ctx.active)
    if ctx.plan.ssm_backend == "cuda":
        tel = obs_t.charge(tel, "launches", float(lps))
    conv, ssd = state
    for li in range(lps):     # replicated under the manual TP lowering
        x = _mamba(ctx, layer_params(layers, li, ctx.mtp), x, conv[:, li], ssd[:, li])
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
    Under the manual TP lowering the shared block is sharded as the plan
    says (its leaves [tp, ...], psums after ``wo`` and the FFN, charged
    under every stage's ``active`` flag as the reference does) and the
    Mamba2 groups are replicated ([N, tp, lps, pg, ...] broadcast views).
    Telemetry as the reference charges it: the shared block's attention
    (``attend_chunk``) and its pool writes; the Mamba2 layers charge none.
    Returns (x_out, state, pool, ledger, telemetry); state and pool update
    in place."""
    cfg, plan, mtp = ctx.cfg, ctx.plan, ctx.mtp
    scfg = HY.T_single_cfg(cfg)
    tpa = tp_apply(ctx)
    n, b, c, dm = x.shape
    cos, sin = _rope(ctx, x)
    conv, ssd = state
    sh = shared_params(shared, mtp)
    if mtp is not None:
        groups = {k: w[:, 0] for k, w in groups.items()}
    ks, vs = [], []
    for gi in range(plan.layers_per_stage):
        for li in range(cfg.hybrid.ssm_per_group):
            x = _mamba(ctx, {k: w[:, gi, li] for k, w in groups.items()}, x,
                       conv[:, gi, li], ssd[:, gi, li])
        has_attn = torch.as_tensor(ctx.stage * plan.layers_per_stage + gi
                                   < cfg.hybrid.num_groups,
                                   device=x.device).reshape(n, 1, 1, 1)
        hn = L.rms_norm(x, sh["ln1"], cfg.norm_eps).reshape(n, b * c, dm)
        q, k, v = rope_fold(*qkv_heads(cfg, sh, hn, b, ("wq", "wk", "wv"), mtp),
                            cos, sin, b, ctx.tp)
        att, led, tel = attend_chunk(ctx, gi, q, k, v, pool, led, tel)
        upd, led = tp_out(ctx, sh["wo"], att, n, led, mtp)
        x = x + torch.where(has_attn, upd.reshape(n, b, c, dm), 0.0)
        ffn = T.ffn_block(scfg, sh, x, tpa) - x            # isolate the update
        if tpa is not None and tpa.dense:
            led = charge(led, "tp", _psum_bytes(ctx, x), ctx.active)
        x = x + torch.where(has_attn, ffn, 0.0)
        ks.append(k)
        vs.append(v)
    pool, led, tel = remote.write_pools(ctx, pool, *_stack_kv(ks, vs, n, ctx.tp * b),
                                        led, tel)
    return x, state, pool, led, tel
