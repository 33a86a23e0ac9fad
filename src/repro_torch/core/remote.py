"""Remote KV access: the spill / fetch / qship transfers (mirrors
``repro.core.remote``).

MBKR spills chunks with index >= p2 at creation to the paired stage
(stage i <-> i + N/2). At attention time a debtor reaches its remote
prefix by ``fetch`` (re-read each spilled chunk-layer from the pair) or
``qship`` (ship the query to the creditor, which returns the partial
online-softmax state).

The N stages are a leading axis on one device: every per-stage quantity
(``ctx.phase``, the slot a stage writes, the validity of a slot) is a
host-side numpy array of shape [N], and the stage-stacked tensors fold the
stage axis into the batch (N*B rows) where attention runs. All movement
between stages goes through ``ctx.transport``, which charges the ledger the
bytes one stage's slice puts on the wire, once per stage whose predicate
holds — the reference's per-chip model summed over chips. The stage
telemetry's event counts (``obs.telemetry``) use the same predicates, so
events x ``per_event_wire_bytes`` equals the ledger.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.attention import (AttentionBackend, State, attn_combine,
                                        attn_init, pool_scan)
from repro_torch.core.transport import Ledger, charge
from repro_torch.kvstore import pages as kvpages
from repro_torch.kvstore import quant as kvquant
from repro_torch.kvstore.quant import torch_dtype
from repro_torch.obs import telemetry as obs_t
from repro_torch.obs.telemetry import StageTelemetry, chunk_stored_bytes


def pair_phase(ctx) -> np.ndarray:
    """[N] the chunk index each stage's PAIR is computing this tick."""
    n2 = ctx.plan.pair_shift
    return np.where(ctx.first_half, ctx.phase - n2, ctx.phase + n2)


def host_table(ctx) -> np.ndarray:
    """[N, M] chunk -> host slot table of each stage's half of the pairing."""
    plan = ctx.plan
    return np.where(ctx.first_half[:, None], plan.host_slot_a[None],
                    plan.host_slot_b[None])


def _stages(x: torch.Tensor, n: int) -> torch.Tensor:
    """[N*B, ...] -> [N, B, ...] (the stage axis back in front)."""
    return x.reshape(n, x.shape[0] // n, *x.shape[1:])


def spill_permute(ctx, kv: torch.Tensor, led: Ledger = None, *, active=None):
    """Cross-half spill transfer for a passthrough pool; ``kv`` [N, 2, lps,
    B, C, K, D]. int8 ``spill_dtype``: the wire carries the int8 payload and
    one fp32 scale per (tensor, layer, batch, kv head); the receiver
    dequantizes into the model dtype."""
    plan, tr = ctx.plan, ctx.transport
    if plan.spill_dtype != "int8":
        return tr.pair_shift(kv, led, tag="spill", active=active)
    x = kv.float()
    amax = x.abs().amax(dim=(-3, -1), keepdim=True)
    scale = torch.clamp(amax, min=1e-6) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127)
    q8, led = tr.pair_shift(q.to(torch.int8), led, tag="spill", active=active)
    s, led = tr.pair_shift(scale, led, tag="spill", active=active)
    return (q8.float() * s).to(kv.dtype), led


def _pool_layer(pool: kvpages.PagedPool, l_idx: int):
    """Views of one layer of the stage-stacked pool: payloads
    [N, P, B, pt, K, D] and scales [N, P, B, 1, K, 1] (None when
    passthrough). Views, not copies: K3 reads them in place."""
    ks = None if pool.k_scale is None else pool.k_scale[:, :, l_idx]
    vs = None if pool.v_scale is None else pool.v_scale[:, :, l_idx]
    return pool.k[:, :, l_idx], pool.v[:, :, l_idx], ks, vs


def fetch_remote(ctx, backend: AttentionBackend, qg, pool_l, st: State,
                 led: Ledger = None, tel: StageTelemetry = None):
    """Fetch wire: each spilled chunk-layer j in [p2, M) comes from the pair
    by one permute (encoded pages, plus scales when quantized); it counts
    on the ledger iff the receiver consumes it (j < phase < M). A pool
    backend that fuses slot stacks (``batched_pool``) takes the landed
    stack in one ``pool_block``; otherwise one combine per landed chunk
    (the streamed reference order). Telemetry: one ``fetch_events`` per
    consumed chunk-layer (the ledger's gate) and the pool partials'
    ``launches`` (one batched, else one per landed chunk). Returns (state,
    ledger, telemetry)."""
    plan, tr = ctx.plan, ctx.transport
    n = plan.num_stages
    host_tbl = host_table(ctx)
    phase = ctx.phase
    landed = []
    for j in range(plan.p2, plan.num_chunks):
        pages = plan.slot_pages[host_tbl[:, j]]                 # [N, ppc]
        kq, vq, ks, vs = kvpages.gather_chunk(*pool_l, pages)
        active = (j < phase) & (phase < plan.num_chunks)
        pk, led = tr.pair_shift(
            kvquant.stack([_stages(kq, n), _stages(vq, n)], dim=1), led,
            tag="fetch", active=active)
        kq, vq = pk[:, 0].flatten(0, 1), pk[:, 1].flatten(0, 1)
        if ks is not None:
            # [ppc, N*B, 1, K, 1] -> per stage [N, 2, ppc, B, 1, K, 1]
            wire = torch.stack([_stages(ks.movedim(0, 1), n),
                                _stages(vs.movedim(0, 1), n)], dim=1)
            wire = wire.movedim(3, 2)
            ps, led = tr.pair_shift(wire, led, tag="fetch", active=active)
            ks = ps[:, 0].movedim(1, 0).flatten(1, 2)
            vs = ps[:, 1].movedim(1, 0).flatten(1, 2)
        tel = obs_t.charge(tel, "fetch_events", 1.0, active)
        landed.append((kq, vq, ks, vs, j))

    if backend.batched_pool:
        kqs = kvquant.stack([x[0] for x in landed])
        vqs = kvquant.stack([x[1] for x in landed])
        kss = vss = None
        if plan.codec.quantized:
            kss = torch.stack([x[2] for x in landed])
            vss = torch.stack([x[3] for x in landed])
        js = np.arange(plan.p2, plan.num_chunks)
        valid = torch.as_tensor(js[None, :] < phase[:, None], device=qg.device)
        st = backend.pool_block(qg, kqs, vqs, kss, vss, valid, ctx.scale, st)
        return st, led, obs_t.charge(tel, "launches", 1.0)
    for kq, vq, ks, vs, j in landed:
        valid = torch.as_tensor(j < phase, device=qg.device)
        st = backend.chunk_block_q(qg, kq, vq, ks, vs, valid, ctx.scale, st)
        tel = obs_t.charge(tel, "launches", 1.0)
    return st, led, tel


def qship_remote(ctx, backend: AttentionBackend, qg, pool_l, st: State,
                 led: Ledger = None, tel: StageTelemetry = None):
    """Ship each stage's query to its pair, which scans ONLY the host slots
    it keeps for it and ships back (m, l, acc); useful iff p2 < phase < M.
    Telemetry: one ``qship_events`` per useful round trip, and the
    creditor scan's ``launches``. Returns (state, ledger, telemetry)."""
    plan, tr = ctx.plan, ctx.transport
    n = plan.num_stages
    gb, c, kvh, g, d = qg.shape
    sd = torch_dtype(plan.ship_dtype)
    phase = ctx.phase
    active = (phase > plan.p2) & (phase < plan.num_chunks)
    q_pair, led = tr.pair_shift(_stages(qg.to(sd), n), led, tag="qship_q",
                                active=active)
    q_pair = q_pair.flatten(0, 1).to(qg.dtype)
    host_chunk = np.where(ctx.first_half[:, None],
                          plan.slot_host_chunk_a[None],
                          plan.slot_host_chunk_b[None])
    st_r = attn_init(gb, c, kvh, g, d, device=qg.device)
    st_r = pool_scan(backend, q_pair, pool_l, plan.slot_pages, host_chunk,
                     pair_phase(ctx), ctx.scale, st_r,
                     slots=plan.host_slots_used)
    ml, led = tr.pair_shift(
        torch.stack([_stages(st_r[0], n), _stages(st_r[1], n)], dim=1), led,
        tag="qship_state", active=active)
    a_r, led = tr.pair_shift(_stages(st_r[2].to(sd), n), led,
                             tag="qship_state", active=active)
    back = (ml[:, 0].flatten(0, 1), ml[:, 1].flatten(0, 1),
            a_r.flatten(0, 1).float())
    tel = obs_t.charge(tel, "qship_events", 1.0, active)
    tel = obs_t.charge(tel, "launches", 1.0 if backend.batched_pool
                       else float(len(plan.host_slots_used)))
    return attn_combine(st, back), led, tel


def write_pools(ctx, pool: kvpages.PagedPool, stage_k: torch.Tensor,
                stage_v: torch.Tensor, led: Ledger = None,
                tel: StageTelemetry = None):
    """End-of-tick page writes, in place. ``stage_k``/``stage_v``
    [N, lps, B, C, K, D]. Each stage encodes its fresh chunk once and
    scatters it to its own slot (phase < p2) or, under mocap, ships it
    cross-half to the pair, which scatters it under its host table.
    Inactive phases write the scratch slot. The own write comes first.

    With the prefix path on (``ctx.prefix_chunks = k > 0``) the first ``k``
    phases write their recomputed KV to the scratch slot, as in the
    reference, and each such stage charges the ``prefix_hit`` ledger key the
    chunk's stored bytes (``obs.telemetry.prefix_saved_model`` is its
    closed form). Their own slot then takes the chunk's pages from the seed
    (``ctx.prefix_pool``, the cached prefix KV): copied at the phase the
    chunk is written, not at the start of the run, because MBKR lends an
    own slot to the pair's spill earlier in the cycle on the second half
    of the stages, which would overwrite a seed copied at the start.
    Telemetry: one ``prefix_hit`` per redirected store and one
    ``spill_events`` per useful spill. Returns (pool, ledger, telemetry)."""
    plan = ctx.plan
    codec = plan.codec
    n, m = plan.num_stages, plan.num_chunks
    phase = ctx.phase
    active = (phase >= 0) & (phase < m)
    pidx = np.clip(phase, 0, m - 1)
    own_slot = np.where(active & (phase < plan.p2), plan.own_slot[pidx],
                        plan.scratch)
    if ctx.prefix_chunks > 0:
        hit = active & (phase < ctx.prefix_chunks)
        own_slot = np.where(hit, plan.scratch, own_slot)
        _, lps, b, c, kvh, hd = stage_k.shape
        led = charge(led, "prefix_hit",
                     chunk_stored_bytes(plan, lps, b, c, kvh, hd), hit)
        tel = obs_t.charge(tel, "prefix_hit", 1.0, hit)
    kq, ksc = kvquant.encode(codec, stage_k, pages=plan.pages_per_chunk)
    vq, vsc = kvquant.encode(codec, stage_v, pages=plan.pages_per_chunk)
    kvpages.scatter_chunk_raw(pool, plan.slot_pages[own_slot], kq, vq, ksc, vsc)
    if ctx.prefix_chunks > 0 and hit.any():
        hs = np.flatnonzero(hit)
        pages = plan.slot_pages[plan.own_slot[phase[hs]]]
        kvpages.put_pages(pool, hs, pages,
                          kvpages.take_pages(ctx.prefix_pool, hs, pages))

    if plan.p2 < m and plan.mode == "mocap":
        pp = pair_phase(ctx)                 # the chunk my pair just computed
        host_tbl = host_table(ctx)
        hslot = np.where((pp >= plan.p2) & (pp < m),
                         host_tbl[np.arange(n), np.clip(pp, 0, m - 1)],
                         plan.scratch)
        ship_active = (phase >= plan.p2) & (phase < m)
        tel = obs_t.charge(tel, "spill_events", 1.0, ship_active)
        tr = ctx.transport
        if codec.quantized:
            sq, led = tr.pair_shift(kvquant.stack([kq, vq], dim=1), led,
                                    tag="spill", active=ship_active)
            # scales [ppc, N, ...] -> stage axis in front for the wire
            ss, led = tr.pair_shift(
                torch.stack([ksc.movedim(0, 1), vsc.movedim(0, 1)], dim=1),
                led, tag="spill", active=ship_active)
            kvpages.scatter_chunk_raw(pool, plan.slot_pages[hslot],
                                      sq[:, 0], sq[:, 1],
                                      ss[:, 0].movedim(1, 0),
                                      ss[:, 1].movedim(1, 0))
        else:
            spill, led = spill_permute(ctx, torch.stack([stage_k, stage_v], dim=1),
                                       led, active=ship_active)
            kvpages.scatter_chunk_raw(pool, plan.slot_pages[hslot],
                                      spill[:, 0], spill[:, 1], None, None)
    return pool, led, tel
