"""Chunked-pipeline prefill driver — MOCAP's execution model on one GPU
(mirrors ``repro.core.pipeline`` for every family, modes mocap and
terapipe; mode gpipe dispatches to ``core.gpipe``).

The reference maps the N pipeline stages onto N devices in SPMD lockstep
(``shard_map`` + ``ppermute``). Here the stage axis is the leading tensor
dimension: the stage-stacked params ``[N, lps, ...]``, the stage-stacked
paged KV pool, the SSM state and the activations ``[N, B, C, d]``. Each
tick runs every stage as batched ops, the fill/drain bubble included as in
the reference, and the ring shift is a roll by one on the stage axis.

The reference's manual tensor-parallel lowering (a stage = tp chips that
split each layer, explicit psums) runs as a tp axis after the stage axis
(``layout``, ``core.staging.TPLayout`` / ``ManualTP``): the params in the
``shard_params`` layout, the pool and the attention rows at the local
heads with the shards folded into the batch rows, the residual stream
replicated (stored once) and the psums summed over the tp axis.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch import device as devices
from repro_torch.configs.base import ModelConfig
from repro_torch.core import transport as tx
from repro_torch.core.attention import get_backend
from repro_torch.core.gpipe import gpipe_prefill
from repro_torch.core.plan import PipelinePlan, build_plan  # noqa: F401
from repro_torch.core.stagestep import (StageCtx, fold_shards, hybrid_stage_step,
                                       ssm_stage_step, tfm_stage_step)
from repro_torch.core.staging import (Params, alloc_kv_pool,  # noqa: F401
                                      alloc_ssm_state, check_layout,
                                      kv_split_axes, layer_params,
                                      manual_tp_plan, pad_experts, pad_q_heads,
                                      stage_params, TPLayout)
from repro_torch.kvstore import pages as kvpages
from repro_torch.kvstore.pages import POOL_FIELDS, PagedPool
from repro_torch.kvstore.quant import torch_dtype
from repro_torch.models import layers as L
from repro_torch.models import whisper as W
from repro_torch.obs import telemetry as obs_t


@torch.no_grad()
def prefill_pipeline(cfg: ModelConfig, staged: Params, tokens, plan: PipelinePlan,
                     *, device=None, embeds=None, return_ledger: bool = False,
                     return_telemetry: bool = False,
                     prefix_chunks: int = 0,
                     prefix_pool: Optional[PagedPool] = None,
                     return_kv: bool = False, tick_hook=None, health=None,
                     layout: Optional[TPLayout] = None):
    """Chunked-pipeline prefill of ``tokens`` [B, S]; returns the fp32
    next-token logits [B, Vpad] (prefill only: one output token).

    ``staged`` is ``stage_params`` output on ``device`` (default the card;
    ``device="cpu"`` runs on the CPU). ``return_ledger`` also returns the
    CollectiveLedger: per-category wire bytes summed over stages, as the
    reference's ``return_ledger`` does. A ``gpipe`` plan runs the
    microbatch baseline (``core.gpipe``, dense only), which has no ledger.

    ``embeds`` [B, F, d]: the stub frontend. For the vlm family (patch
    embeddings) the stream is the F embeddings, then ``tokens`` [B, S - F]
    (S = M x C, F need not be a multiple of C): stage 0 takes each
    position of its chunk from the one side or the other, so a chunk that
    straddles position F is exact, and the embedding multiplier applies
    after the splice. For the encdec family (frame embeddings) the encoder
    runs once before the tick loop (``whisper.encode``; its attention is K1
    non-causal under the ``cuda`` backend, its oracle under ``torch``), and
    each stage's decoder layers attend to the encoder output through their
    own cross K/V (``stage_cross_kv``); ``tokens`` are the decoder's
    [B, S]. Other families take no embeds.

    ``return_telemetry``: also return the stage telemetry
    (``obs.telemetry``): one float64 ``[N, T]`` numpy array per key (pool
    occupancy, resident KV bytes, spill / fetch / qship events, attention
    work, the reference's logical launches, prefix hits). It is host
    arithmetic on the host-side stage predicates, charged where the ledger
    is, snapshotted once a tick: no device op, no synchronize, and the
    logits are bit-identical with it off.

    ``tick_hook``: a zero-arg callable called at the END of every tick,
    after the tick's work is enqueued (``obs.profile.TickSpanCollector.
    note``: a CUDA event on the stream, the measured spans).

    ``health``: an ``obs.health.HealthMonitor``; arms the non-finite
    sentinel. Each tick counts the non-finite values of every stage's
    output on the device into column t of one ``[N, T]`` int32 tensor;
    after the loop the tensor is masked to the active (stage, tick) cells
    (bubble garbage pages no one) and read ONCE into
    ``health.note_nonfinite_profile``: no per-tick ``.item()`` or
    synchronize. With ``health=None`` nothing extra is launched.

    ``prefix_chunks`` / ``prefix_pool`` / ``return_kv``: the device half of
    the prefix KV cache (``kvstore.prefix``; dense and MoE only). The first
    ``prefix_chunks`` chunks of every sequence read cached KV from
    ``prefix_pool`` (a stage-stacked ``PagedPool`` snapshot [N, P, lps, B,
    ...], as ``return_kv`` gives it) instead of the KV they just computed:
    ``core.remote.write_pools`` sends those chunks' writes to the scratch
    slot, charges the ``prefix_hit`` ledger key, and copies the chunks' own
    pages from the snapshot into the freshly allocated pool. The snapshot
    is read, never aliased or written. ``return_kv`` also returns the
    final stage-stacked pool (scales included when quantized), with every
    own chunk (index < p2) in its own slot: where MBKR lent that slot to the
    pair's spill after the chunk's last read (the first half of the
    stages), the chunk's pages are put back, so that any hit length up to
    ``min(p2, M - 1)`` can be seeded from it. (The reference returns the
    pool as it ends and seeds it whole at the start; its seeded logits then
    differ from the unseeded run's once ``prefix_chunks`` reaches a lent
    slot, chunk 4 at N = M = 8.) The put-back moves no telemetry residency:
    that follows the plan's lifecycle. Return order is
    ``logits[, ledger][, telemetry][, kv]``, as the reference's.

    ``layout`` (``core.staging.TPLayout``, the counterpart of the
    reference's ``topo``): with tp > 1 the manual TP lowering
    (``manual_tp_plan``) runs, and ``staged`` must be in its layout
    (``shard_params``). The ledger then counts every tp chip's bytes, as
    the reference's does after its collect over the stage and tp axes (the
    ``tp`` key: the psums). The pool and ``return_kv``'s snapshot hold a
    pool a shard, the shards folded into the batch axis ([N, P, lps,
    tp * B, pt, kvh // kv_div, D]); the prefix path needs kv_div == tp, as
    the reference asserts."""
    armed = bool(prefix_chunks) or prefix_pool is not None or return_kv
    if plan.mode == "gpipe":
        if return_ledger:
            raise ValueError("gpipe has no MBKR transport ledger")
        if armed:
            raise ValueError("the prefix KV cache rides the chunked-pipeline "
                             "paged pool only, not gpipe")
        if tick_hook is not None or health is not None:
            raise ValueError("tick_hook / health probe only the chunked pipeline, not gpipe")
        if embeds is not None:
            raise ValueError("gpipe runs the dense family, which takes no embeds")
        return gpipe_prefill(cfg, staged, tokens, plan, device=device,
                             return_telemetry=return_telemetry, layout=layout)
    if plan.mode not in ("mocap", "terapipe"):
        raise ValueError(f"unknown mode {plan.mode!r}")
    if armed and cfg.family not in ("dense", "moe"):
        raise ValueError("the prefix KV cache needs the pure paged-pool "
                         f"families (dense / moe), not {cfg.family!r}")
    mtp = manual_tp_plan(cfg, plan, layout)
    check_layout(staged, mtp)
    if armed and mtp is not None and mtp.kv_div != mtp.tp:
        raise ValueError("prefix pool I/O under manual TP needs kv_div == tp "
                         f"(kv_div {mtp.kv_div}, tp {mtp.tp})")
    if prefix_chunks and prefix_pool is None:
        raise ValueError("prefix_chunks > 0 requires a seeded prefix_pool")
    if not 0 <= prefix_chunks <= min(plan.p2, plan.num_chunks - 1):
        raise ValueError(f"prefix_chunks {prefix_chunks}: prefix hits must stay "
                         "within own-resident, non-final chunks "
                         f"(<= min(p2 {plan.p2}, M - 1))")
    dev = devices.resolve(device)
    if staged["embed"].device.type != dev.type:
        raise ValueError(f"params on {staged['embed'].device}, run on {dev}")
    tokens = _on(tokens, dev).long()
    n, m, c = plan.num_stages, plan.num_chunks, plan.chunk_len
    b = tokens.shape[0]
    family = cfg.family
    if family == "encdec" and embeds is None:
        raise ValueError("the encdec family needs frame embeddings (embeds=)")
    if embeds is not None and family not in ("vlm", "encdec"):
        raise ValueError(f"family {family!r} takes no embeds")
    n_front = 0
    if embeds is not None:
        embeds = _on(embeds, dev)
        if embeds.shape[0] != b or embeds.shape[2] != cfg.d_model:
            raise ValueError(f"embeds {tuple(embeds.shape)} vs {b} rows of d {cfg.d_model}")
        n_front = embeds.shape[1] if family == "vlm" else 0
    if n_front + tokens.shape[1] != m * c:
        raise ValueError(f"{n_front} embeds + tokens {tuple(tokens.shape)} "
                         f"vs plan {m} x {c}")
    dt = torch_dtype(cfg.dtype)
    tp = 1 if mtp is None else mtp.tp
    transport = tx.StageAxisTransport(replicas=tp)
    scale = cfg.attention_multiplier or 1.0 / math.sqrt(cfg.resolved_head_dim or 1)
    stages = np.arange(n)
    first_half = stages < n // 2

    if family not in ("dense", "moe", "ssm", "hybrid", "vlm", "encdec"):
        raise ValueError(f"family {family!r} is not ported")
    cross = None
    if family == "encdec":         # the encoder runs once, outside the tick loop
        enc_out = W.encode(cfg, staged, embeds,
                           attend=get_backend(plan.attn_backend).full_block)
        cross = stage_cross_kv(cfg, staged["stage_layers"], enc_out, mtp)
        del enc_out
    pool = alloc_kv_pool(cfg, plan, b, device=dev, mtp=mtp)  # None for ssm
    if prefix_pool is not None:
        _check_seed(pool, prefix_pool)
    lent = []      # own chunks in slots the pair's spill overwrites later
    state = (alloc_ssm_state(cfg, plan, b, device=dev)
             if family in ("ssm", "hybrid") else None)
    x = torch.zeros((n, b, c, cfg.d_model), dtype=dt, device=dev)
    x_last = torch.zeros((n, b, cfg.d_model), dtype=torch.float32, device=dev)
    led = tx.ledger_init()
    rec = obs_t.TelemetryRecorder(n) if return_telemetry else None
    tel = None if rec is None else rec.tel
    # one chunk's STORED pool bytes (the telemetry's residency price), over
    # the stage's tp shards at their local kv heads
    chunk_bytes = 0.0 if family == "ssm" else obs_t.chunk_stored_bytes(
        plan, plan.layers_per_stage, tp * b, c,
        cfg.num_kv_heads // (1 if mtp is None else mtp.kv_div), cfg.resolved_head_dim)
    bad = (torch.zeros((n, plan.num_ticks), dtype=torch.int32, device=dev)
           if health is not None else None)
    for t in range(plan.num_ticks):
        phase = t - stages
        ctx = StageCtx(cfg=cfg, plan=plan, stage=stages, phase=phase,
                       first_half=first_half, scale=scale, transport=transport,
                       prefix_chunks=prefix_chunks, prefix_pool=prefix_pool, mtp=mtp)
        # stage 0 embeds chunk clip(t); the others take the ring buffer
        tc = min(max(t, 0), m - 1)
        x_emb = chunk_embed(staged["embed"], tokens, embeds if n_front else None,
                            tc * c, c)
        if cfg.embedding_multiplier != 1.0:
            x_emb = x_emb * cfg.embedding_multiplier
        x[0] = x_emb.to(dt)
        if family == "ssm":
            x_out, state, led, tel = ssm_stage_step(
                ctx, staged["stage_layers"], x, state, led, tel)
        elif family == "hybrid":
            x_out, state, pool, led, tel = hybrid_stage_step(
                ctx, staged["stage_layers"], staged["shared"], x, state, pool,
                led, tel)
        else:
            x_out, pool, led, tel = tfm_stage_step(
                ctx, staged["stage_layers"], x, pool, led, tel, cross=cross)
        if rec is not None:
            if family != "ssm":
                tel = obs_t.charge_tick_residency(tel, ctx, chunk_bytes)
            rec.snapshot()
        if bad is not None:
            bad[:, t] = nonfinite_per_stage(x_out)
        if return_kv:
            own = ((phase >= 0) & (phase < plan.p2)
                   & np.isin(plan.own_slot[np.clip(phase, 0, m - 1)],
                             plan.host_slots_used))
            if own.any():
                hs = np.flatnonzero(own)
                pages = plan.slot_pages[plan.own_slot[phase[hs]]]
                lent.append((hs, pages, kvpages.take_pages(pool, hs, pages)))
        # the last token's hidden state, at the last stage's last chunk
        for s in np.flatnonzero((stages == n - 1) & (phase == m - 1)):
            x_last[s] = x_out[s, :, -1].float()
        ring_active = (phase >= 0) & (phase < m) & (stages < n - 1)
        x, led = transport.ring_shift(x_out, led, active=ring_active)
        if tick_hook is not None:
            tick_hook()
    # replicate the final hidden state across stages
    x_last, led = transport.stage_psum(x_last, led)
    h = L.rms_norm(x_last[0][:, None, :].to(dt), staged["final_norm"], cfg.norm_eps)
    w = staged["lm_head"] if "lm_head" in staged else staged["embed"].T
    logits = L.unembed_logits(h, w, scale=cfg.logits_scaling)[:, 0]
    if bad is not None:       # the one read of the sentinel's counts
        ph = np.arange(plan.num_ticks)[None, :] - stages[:, None]
        active = torch.as_tensor((ph >= 0) & (ph < m), device=dev)
        health.note_nonfinite_profile((bad * active).cpu().numpy())
    out = [logits]
    if return_ledger:
        out.append(tx.ledger_to_dict(led))
    if return_telemetry:
        out.append(rec.profile())
    if return_kv:
        for hs, pages, taken in lent:
            kvpages.put_pages(pool, hs, pages, taken)
        out.append(pool)
    return out[0] if len(out) == 1 else tuple(out)


def _on(x, dev) -> torch.Tensor:
    """A tensor or an array-like on ``dev``."""
    return torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x), device=dev)


def chunk_embed(embed: torch.Tensor, tokens: torch.Tensor,
                embeds: Optional[torch.Tensor], lo: int, c: int) -> torch.Tensor:
    """The input embeddings of stream positions [lo, lo + c): the token
    embeddings of ``tokens`` [B, S] or, with the vlm's ``embeds`` [B, F, d]
    in front, position p < F from ``embeds[:, p]`` (cast to the embedding's
    dtype) and position p >= F from token p - F, so a chunk that straddles
    F takes each side exactly (the reference's per-position select)."""
    f = 0 if embeds is None else embeds.shape[1]
    hi = lo + c
    parts = []
    if lo < f:
        parts.append(embeds[:, lo:min(hi, f)].to(embed.dtype))
    if hi > f:
        parts.append(L.embed_lookup(embed, tokens[:, max(lo - f, 0):hi - f]))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def stage_cross_kv(cfg: ModelConfig, layers: Params, enc_out: torch.Tensor,
                   mtp=None):
    """Every stage's cross K/V of the encoder output ``enc_out`` [B, F, d]
    through its own ``xwk`` / ``xwv`` [N, lps, d, KVH*D]: (xk, xv), each
    [N, lps, B, F, KVH, D] on the stage axis, laid out layer-major in
    memory, so that a layer's slice ``[:, li]`` is one contiguous
    [N, B, F, KVH, D] block that the cross-attention kernel reads in
    place. Under the manual TP lowering (``mtp``) each shard's own K/V at
    its local heads, the shards folded into the batch axis: [N, lps,
    tp * B, F, KVH / kv_div, D]."""
    w0 = layers["xwk"]
    n, lps = w0.shape[0], w0.shape[1 if mtp is None else 2]
    b, f, d = enc_out.shape
    hd = cfg.resolved_head_dim
    tp = 1 if mtp is None else mtp.tp
    flat = enc_out.reshape(1, b * f, d)

    def one(key: str) -> torch.Tensor:
        per = []
        for li in range(lps):
            w = layer_params({key: layers[key]}, li, mtp)[key]
            y = torch.matmul(flat if w.ndim == 3 else flat[None], w)
            y = fold_shards(y.reshape(n, -1, b, f, y.shape[-1] // hd, hd), tp)
            per.append(y.reshape(n, tp * b, *y.shape[1:]))
        return torch.stack(per).transpose(0, 1)
    return one("xwk"), one("xwv")


def nonfinite_per_stage(x: torch.Tensor) -> torch.Tensor:
    """The non-finite values of each stage's slice of ``x`` [N, ...], int64
    [N], on x's device. ``x * 0`` is 0 where x is finite and NaN where it
    is not, so ``(x * 0) != 0`` flags them, in x's dtype; the flags are
    summed in fp32 along the last axis (exact: a row holds far fewer than
    2**24 values), then in int64 over the rows. Three passes over x, no
    full-size bool or int64 copy (``isfinite`` is four passes on its own)."""
    flags = torch.mul(x, 0).ne_(0)
    return flags.sum(-1, dtype=torch.float32).reshape(x.shape[0], -1).sum(
        1, dtype=torch.int64)


def _check_seed(pool: PagedPool, seed: PagedPool) -> None:
    """The snapshot ``seed`` has the fresh ``pool``'s layout and device."""
    for name in POOL_FIELDS:
        dst, src = getattr(pool, name), getattr(seed, name)
        if (dst is None) != (src is None):
            raise ValueError(f"prefix_pool.{name}: the snapshot's codec differs "
                             "from the plan's")
        if dst is not None and (tuple(src.shape) != tuple(dst.shape)
                                or src.dtype != dst.dtype or src.device != dst.device):
            raise ValueError(
                f"prefix_pool.{name} {tuple(src.shape)} {src.dtype} on {src.device} "
                f"vs the plan's pool {tuple(dst.shape)} {dst.dtype} on {dst.device}")
