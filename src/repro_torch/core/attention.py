"""Online-softmax attention state + the pluggable backend registry (mirrors
``repro.core.attention``).

One chunk's attention is a COMBINE of partial states over several KV
sources (own pool slots, remote partials, the causal self block). State is
``(m, l, acc)``: running max and denominator [GB, K, G, C] and the
unnormalized accumulator [GB, K, G, C, D], all fp32.

The port runs the N pipeline stages as a leading axis folded into the batch
(GB = N * B rows). Validity gates therefore come per GROUP of B rows: a
``valid`` tensor is [groups] for one stored chunk and [groups, S] for a
stack of S slots.

Backends:
- ``torch`` — the per-block reference (``attn_update``), mirrors
  ``JnpBackend`` including the cast of p to v's dtype before PV.
- ``cuda``  — kernel K1 (``ops.chunk_attention``) for the self and chunk
  blocks, kernel K2 (``ops.pool_attention``) for a whole slot stack in one
  launch; mirrors ``PallasBackend``.
- ``paged`` — pool partials through kernel K3 (``ops.pool_attention_paged``)
  straight off the page store; mirrors ``PagedPallasBackend``.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kvstore import pages as kvpages
from repro_torch.kvstore import quant as kvquant

NEG_INF = float(-1e30)  # finite -inf stand-in: keeps masked softmax NaN-free

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


# ======================================================= state algebra (fp32)

def group_queries(q: torch.Tensor, kvh: int) -> torch.Tensor:
    """[B,C,H,D] -> [B,C,K,G,D] (query heads grouped per kv head)."""
    b, c, h, d = q.shape
    return q.reshape(b, c, kvh, h // kvh, d)


def attn_init(b: int, c: int, kvh: int, g: int, d: int, device=None) -> State:
    return (torch.full((b, kvh, g, c), NEG_INF, device=device),
            torch.zeros((b, kvh, g, c), device=device),
            torch.zeros((b, kvh, g, c, d), device=device))


def _safe(m: torch.Tensor) -> torch.Tensor:
    return torch.where(m < NEG_INF / 2, torch.zeros_like(m), m)


def attn_update(qg, k, v, mask, scale, st: State) -> State:
    """One online-softmax block update (the reference path).
    qg [B,C,K,G,D]; k, v [B,Ck,K,D]; mask broadcastable to [B,K,G,C,Ck]."""
    m, l, acc = st
    s = torch.einsum("bckgd,bskd->bkgcs", qg.float(), k.float()) * scale
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m, s.amax(dim=-1))
    m_safe = _safe(m_new)
    p = torch.exp(s - m_safe[..., None])
    corr = torch.exp(m - m_safe)
    l_new = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bkgcs,bskd->bkgcd", p.to(v.dtype).float(), v.float())
    return m_new, l_new, acc * corr[..., None] + pv


def attn_combine(st1: State, st2: State) -> State:
    m1, l1, a1 = st1
    m2, l2, a2 = st2
    m = torch.maximum(m1, m2)
    m_safe = _safe(m)
    c1, c2 = torch.exp(m1 - m_safe), torch.exp(m2 - m_safe)
    return m, l1 * c1 + l2 * c2, a1 * c1[..., None] + a2 * c2[..., None]


def attn_finish(st: State, q_dtype) -> torch.Tensor:
    m, l, acc = st
    b, kvh, g, c, d = acc.shape
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, c, kvh * g, d).to(q_dtype)


def group_rows(valid: torch.Tensor, rows: int) -> torch.Tensor:
    """Per-group flags [G] -> per-row flags [rows] (rows = G * B)."""
    return valid.repeat_interleave(rows // valid.shape[0])


# =========================================================== backend registry

class AttentionBackend:
    """One way to compute a partial attention state: ``self_block``
    (causal, within the chunk) and ``chunk_block`` (one stored chunk, fully
    visible, gated per group by ``valid``). ``batched_pool`` advertises a
    fused multi-slot ``pool_block``; ``paged_pool`` advertises
    ``pool_block_paged`` straight off the page store."""

    name = "abstract"
    batched_pool = False
    paged_pool = False

    def self_block(self, qg, k, v, scale, st: State) -> State:
        raise NotImplementedError

    def chunk_block(self, qg, k, v, valid, scale, st: State) -> State:
        raise NotImplementedError

    def pool_block(self, qg, kq, vq, ks, vs, valid, scale, st: State) -> State:
        """A stack of stored chunks: payloads [S, GB, Ck, K, D], per-page
        scales [S, ppc, GB, 1, K, 1] (None when passthrough), ``valid``
        [G, S]. Base: the per-slot loop through ``chunk_block_q``."""
        for s in range(kq.shape[0]):
            st = self.chunk_block_q(qg, kq[s], vq[s],
                                    None if ks is None else ks[s],
                                    None if vs is None else vs[s],
                                    valid[:, s], scale, st)
        return st

    def chunk_block_q(self, qg, kq, vq, k_scale, v_scale, valid, scale,
                      st: State) -> State:
        """``chunk_block`` over an ENCODED stored chunk: payload
        [GB, Ck, K, D] + per-page scales [ppc, GB, 1, K, 1]. Default:
        dequantize on read, then the plain block."""
        if k_scale is not None:
            pt = kq.shape[1] // k_scale.shape[0]
            k_scale = kvquant.expand_page_scale(k_scale, pt)
            v_scale = kvquant.expand_page_scale(v_scale, pt)
        k = kvquant.decode(kq, k_scale, qg.dtype)
        v = kvquant.decode(vq, v_scale, qg.dtype)
        return self.chunk_block(qg, k, v, valid, scale, st)


class TorchBackend(AttentionBackend):
    """The per-block reference (runs on any device)."""

    name = "torch"

    def self_block(self, qg, k, v, scale, st: State) -> State:
        c = qg.shape[1]
        tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=qg.device))
        return attn_update(qg, k, v, tri, scale, st)

    def chunk_block(self, qg, k, v, valid, scale, st: State) -> State:
        mask = group_rows(valid, qg.shape[0])[:, None, None, None, None]
        return attn_update(qg, k, v, mask, scale, st)


class CudaBackend(AttentionBackend):
    """Kernel backend: K1 for the self and chunk blocks, K2 for a whole
    slot stack in one launch. The kernels return (m, l) and the fp32
    accumulator, so their results join the combine chain at full
    precision."""

    name = "cuda"
    batched_pool = True

    @staticmethod
    def _to_state(m, l, acc, kvh: int) -> State:
        b, c, h, d = acc.shape
        g = h // kvh
        acc = acc.reshape(b, c, kvh, g, d).permute(0, 2, 3, 1, 4)
        return m.reshape(b, kvh, g, c), l.reshape(b, kvh, g, c), acc

    @staticmethod
    def _flat_q(qg) -> torch.Tensor:
        b, c, kvh, g, d = qg.shape
        return qg.reshape(b, c, kvh * g, d).contiguous()

    def _kernel_state(self, qg, k, v, scale, causal_offset: int,
                      k_scale=None, v_scale=None) -> State:
        _, m, l, acc = ops.chunk_attention(
            self._flat_q(qg), k.contiguous(), v.contiguous(),
            causal_offset=causal_offset, scale=float(scale),
            return_state=True, k_scale=k_scale, v_scale=v_scale)
        return self._to_state(m, l, acc, qg.shape[2])

    @staticmethod
    def _gate(s2: State, valid) -> State:
        rows = group_rows(valid, s2[0].shape[0])
        keep = lambda x: rows.reshape(-1, *([1] * (x.ndim - 1)))
        return (torch.where(keep(s2[0]), s2[0], torch.full_like(s2[0], NEG_INF)),
                torch.where(keep(s2[1]), s2[1], torch.zeros_like(s2[1])),
                torch.where(keep(s2[2]), s2[2], torch.zeros_like(s2[2])))

    def self_block(self, qg, k, v, scale, st: State) -> State:
        return attn_combine(st, self._kernel_state(qg, k, v, scale, 0))

    def chunk_block(self, qg, k, v, valid, scale, st: State) -> State:
        s2 = self._kernel_state(qg, k, v, scale, int(k.shape[1]))
        return attn_combine(st, self._gate(s2, valid))

    def chunk_block_q(self, qg, kq, vq, k_scale, v_scale, valid, scale,
                      st: State) -> State:
        """Quantized pages go straight into K1, which dequantizes after the
        load (per-token scale rows)."""
        if k_scale is None:
            return self.chunk_block(qg, kq, vq, valid, scale, st)
        pt = kq.shape[1] // k_scale.shape[0]
        ksc = kvquant.expand_page_scale(k_scale, pt)[..., 0].contiguous()
        vsc = kvquant.expand_page_scale(v_scale, pt)[..., 0].contiguous()
        s2 = self._kernel_state(qg, kq, vq, scale, int(kq.shape[1]), ksc, vsc)
        return attn_combine(st, self._gate(s2, valid))

    def pool_block(self, qg, kq, vq, ks, vs, valid, scale, st: State) -> State:
        """ONE K2 launch over every stored chunk of the stack, per-(group,
        slot) gating and dequant inside the kernel."""
        ksc = vsc = None
        if ks is not None:
            pt = kq.shape[2] // ks.shape[1]
            ksc = kvquant.expand_page_scale(ks.movedim(1, 0), pt)[..., 0].contiguous()
            vsc = kvquant.expand_page_scale(vs.movedim(1, 0), pt)[..., 0].contiguous()
        m, l, acc = ops.pool_attention(
            self._flat_q(qg), kq.contiguous(), vq.contiguous(), valid,
            scale=float(scale), k_scale=ksc, v_scale=vsc)
        return attn_combine(st, self._to_state(m, l, acc, qg.shape[2]))


class PagedBackend(CudaBackend):
    """Pool partials through K3, which reads pages in place from the page
    store through handle rows — no gathered slot stack. Self and chunk
    blocks inherit K1."""

    name = "paged"
    paged_pool = True

    def pool_block_paged(self, qg, pool_l, page_rows, valid, scale,
                         st: State) -> State:
        """ONE K3 launch off the layer's page-store slice ``pool_l`` (views
        of the stage-stacked pool, strides and all); ``page_rows``
        [S, ppc]; ``valid`` [G, S]."""
        k_l, v_l, ks_l, vs_l = pool_l
        ppc = page_rows.shape[1]
        handles = torch.as_tensor(np.asarray(page_rows, np.int32).reshape(-1),
                                  device=qg.device)
        m, l, acc = ops.pool_attention_paged(
            self._flat_q(qg), k_l, v_l, handles, valid, ppc=ppc,
            scale=float(scale), k_scale=ks_l, v_scale=vs_l)
        return attn_combine(st, self._to_state(m, l, acc, qg.shape[2]))

    def pool_block(self, qg, kq, vq, ks, vs, valid, scale, st: State) -> State:
        """Stacked-interface entry (the batched-fetch landing buffer): view
        the stack [S, G*B, Ck, K, D] as a grouped page store
        [G, S*ppc, B, pt, K, D] with identity handles and reuse K3. With
        ppc == 1 the view is free; per-page quantized stacks pay one copy of
        the landing buffer (n_remote chunks, not the pool)."""
        s, gb, ck, kvh, d = kq.shape
        ng = valid.shape[0]
        b = gb // ng
        ppc = 1 if ks is None else ks.shape[1]
        pt = ck // ppc

        def pageize(x):
            x = x.reshape(s, ng, b, ppc, pt, kvh, d).permute(1, 0, 3, 2, 4, 5, 6)
            return x.reshape(ng, s * ppc, b, pt, kvh, d)

        ksc = vsc = None
        if ks is not None:  # [S, ppc, G*B, 1, K, 1] -> [G, S*ppc, B, 1, K, 1]
            def pscale(x):
                x = x.reshape(s, ppc, ng, b, 1, kvh, 1).permute(2, 0, 1, 3, 4, 5, 6)
                return x.reshape(ng, s * ppc, b, 1, kvh, 1)
            ksc, vsc = pscale(ks), pscale(vs)
        handles = torch.arange(s * ppc, dtype=torch.int32, device=qg.device)
        m, l, acc = ops.pool_attention_paged(
            self._flat_q(qg), pageize(kq), pageize(vq), handles, valid,
            ppc=ppc, scale=float(scale), k_scale=ksc, v_scale=vsc)
        return attn_combine(st, self._to_state(m, l, acc, qg.shape[2]))


_BACKENDS: Dict[str, Callable[[], AttentionBackend]] = {}


def register_backend(name: str, factory: Callable[[], AttentionBackend]) -> None:
    _BACKENDS[name] = factory


def get_backend(name: str) -> AttentionBackend:
    if name not in _BACKENDS:
        raise KeyError(f"unknown attention backend {name!r}; "
                       f"registered: {sorted(_BACKENDS)}")
    return _BACKENDS[name]()


register_backend("torch", TorchBackend)
register_backend("cuda", CudaBackend)
register_backend("paged", PagedBackend)


# ============================================================ pool traversal

def pool_scan(backend: AttentionBackend, qg, pool_l, slot_pages, slot_chunk,
              limit, scale, st: State, slots: Optional[np.ndarray] = None) -> State:
    """Accumulate attention over pool slots whose stored chunk < ``limit``.

    ``pool_l`` = (k_l, v_l, ks_l, vs_l): this layer's slices of the paged
    pool, [P, B, pt, K, D] for one stage or [N, P, B, pt, K, D]
    stage-stacked (then qg holds N*B rows). ``slot_chunk`` [slots+1] (the
    same for every stage) or [G, slots+1]; ``limit`` [G] (numpy: the phases
    are known on the host). ``slots``: static subset of slots to visit (the
    creditor scan).

    Three traversal orders, reconciled by the tests: ``paged_pool`` hands
    the page-handle rows to K3 (zero gather); ``batched_pool`` gathers
    every visited slot in one shot for one K2 launch; otherwise one
    ``chunk_block_q`` per slot (the reference order)."""
    k_l, v_l, ks_l, vs_l = pool_l
    limit = np.atleast_1d(np.asarray(limit))
    slot_chunk = np.asarray(slot_chunk)
    if slots is not None:
        if len(slots) == 0:
            return st
        idx = np.asarray(slots, np.int64)
        chunk_ids = slot_chunk[..., idx]
        page_rows = kvpages.handle_rows(slot_pages, slots)
    else:
        nslots = slot_pages.shape[0] - 1
        if nslots <= 0:
            return st
        chunk_ids = slot_chunk[..., :nslots]
        page_rows = kvpages.handle_rows(slot_pages)
    chunk_ids = np.broadcast_to(chunk_ids, (len(limit), page_rows.shape[0]))
    valid_np = (chunk_ids >= 0) & (chunk_ids < limit[:, None])
    valid = torch.as_tensor(valid_np, device=qg.device)

    if backend.paged_pool:
        return backend.pool_block_paged(qg, pool_l, page_rows, valid, scale, st)
    if backend.batched_pool:
        # materializes the dense [S, G*B, C, K, D] stack — the feed of K2
        kq, vq, ks, vs = kvpages.gather_chunks(k_l, v_l, ks_l, vs_l, page_rows)
        return backend.pool_block(qg, kq, vq, ks, vs, valid, scale, st)
    stacked = k_l.ndim == 6
    for s in range(page_rows.shape[0]):
        pages = (np.broadcast_to(page_rows[s], (len(limit), page_rows.shape[1]))
                 if stacked else page_rows[s])
        kq, vq, ks, vs = kvpages.gather_chunk(k_l, v_l, ks_l, vs_l, pages)
        st = backend.chunk_block_q(qg, kq, vq, ks, vs, valid[:, s], scale, st)
    return st
