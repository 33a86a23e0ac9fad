"""Plain PyTorch versions of the kernels: the same signatures and outputs as
the wrappers in ``kernels.ops``. The three attention kernels take the math
of the reference's ``_block_update`` in fp32 over all visible keys at once;
the SSD scan (K4) takes the reference's per-chunk ``_ssd_kernel`` algorithm;
the flash-decode (K5) the materialized softmax with K5's semantics.

The wrappers use them for tensors on the CPU; ``chip_smoke.py`` holds each
CUDA kernel against them on the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def _state(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           mask: torch.Tensor, scale: float):
    """Online-softmax state of q [B,C,H,D] over k/v [B,T,KVH,D] (fp32,
    dequantized) under ``mask`` broadcastable to [B,KVH,G,C,T]. Returns
    (m, l) [B,H,C] and acc [B,C,H,D], as the kernels do."""
    b, c, h, d = q.shape
    kvh = k.shape[2]
    qg = q.float().reshape(b, c, kvh, h // kvh, d)
    s = torch.einsum("bckgd,btkd->bkgct", qg, k) * scale
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = torch.clamp(s.amax(dim=-1), min=NEG_INF) if s.shape[-1] else \
        torch.full(s.shape[:-1], NEG_INF, device=q.device)
    m_safe = torch.where(m < NEG_INF / 2, torch.zeros_like(m), m)
    p = torch.exp(s - m_safe[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgct,btkd->bckgd", p, v)
    return (m.reshape(b, h, c), l.reshape(b, h, c), acc.reshape(b, c, h, d))


def _dequant(x: torch.Tensor, sc: Optional[torch.Tensor]) -> torch.Tensor:
    x = x.float()
    return x if sc is None else x * sc.float()[..., None]


def chunk_attention_plain(q, k, v, *, causal_offset: int = 0,
                          scale: Optional[float] = None,
                          kv_len: Optional[int] = None,
                          k_scale=None, v_scale=None):
    """K1. q [B,C,H,D]; k/v [B,T,KVH,D] (scales [B,T,KVH] when quantized).
    Key j is visible to query i iff j <= i + causal_offset and j < kv_len.
    Returns (out [B,C,H,D] in q's dtype, m, l [B,H,C], acc [B,C,H,D])."""
    b, c, h, d = q.shape
    t = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kv_len = t if kv_len is None else kv_len
    qpos = torch.arange(c, device=q.device)[:, None] + causal_offset
    kpos = torch.arange(t, device=q.device)[None, :]
    mask = (kpos <= qpos) & (kpos < kv_len)
    m, l, acc = _state(q, _dequant(k, k_scale), _dequant(v, v_scale), mask, scale)
    out = acc / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype), m, l, acc


def _groups(valid: torch.Tensor) -> torch.Tensor:
    valid = torch.as_tensor(valid)
    return (valid[None] if valid.ndim == 1 else valid) != 0


def pool_attention_plain(q, k, v, valid, *, scale: Optional[float] = None,
                         kv_len: Optional[int] = None, k_scale=None,
                         v_scale=None):
    """K2. q [G*B,C,H,D]; a stack of S stored chunks k/v [S,G*B,T,KVH,D]
    (scales [S,G*B,T,KVH]); ``valid`` [S] or [G,S]. Every stored chunk is
    fully visible below ``kv_len``; an invalid (group, slot) contributes
    nothing, so an all-invalid group gives exactly (-1e30, 0, 0). Returns
    (m, l) [G*B,H,C] and acc [G*B,C,H,D]."""
    gb, c, h, d = q.shape
    s_n, _, t, kvh, _ = k.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kv_len = t if kv_len is None else kv_len
    ok = _groups(valid).to(q.device)                          # [G, S]
    ng = ok.shape[0]
    ok = ok.repeat_interleave(gb // ng, dim=0)                # [GB, S]
    tok = torch.arange(t, device=q.device) < kv_len
    mask = (ok[:, :, None] & tok[None, None, :]).reshape(gb, 1, 1, 1, s_n * t)

    def flat(x, sc):                                          # -> [GB, S*T, K, D]
        return _dequant(x, sc).permute(1, 0, 2, 3, 4).reshape(gb, s_n * t, kvh, d)
    return _state(q, flat(k, k_scale), flat(v, v_scale), mask, scale)


def pool_attention_paged_plain(q, k_pages, v_pages, handles, valid, *,
                               ppc: int, scale: Optional[float] = None,
                               kv_len: Optional[int] = None, k_scale=None,
                               v_scale=None):
    """K3. The state of K2 over pages read through ``handles`` [S*ppc] from
    the page store k/v [P,B,pt,KVH,D] or, stage-stacked, [G,P,B,pt,KVH,D]
    (per-page scales [P,B,1,KVH,1] / [G,P,B,1,KVH,1]); ``kv_len`` defaults
    to ppc*pt. This plain version gathers the pages (the kernel does not)."""
    if k_pages.ndim == 5:
        k_pages, v_pages = k_pages[None], v_pages[None]
        if k_scale is not None:
            k_scale, v_scale = k_scale[None], v_scale[None]
    ng, _, b, pt, kvh, d = k_pages.shape
    hnd = torch.as_tensor(handles, device=k_pages.device).long().reshape(-1)
    s_n = hnd.numel() // ppc
    kv_len = ppc * pt if kv_len is None else kv_len

    def stack(x):    # [G, P, B, pt, ...] -> [S, G*B, ppc*pt, ...]
        x = x[:, hnd].reshape(ng, s_n, ppc, b, pt, *x.shape[4:])
        x = x.permute(1, 0, 3, 2, 4, *range(5, x.ndim))
        return x.reshape(s_n, ng * b, ppc * pt, *x.shape[5:])

    ksc = vsc = None
    if k_scale is not None:
        def per_token(sc):   # [G, P, B, 1, K, 1] -> [S, G*B, T, K]
            sc = sc[..., 0].expand(*sc.shape[:3], pt, sc.shape[4])
            return stack(sc)
        ksc, vsc = per_token(k_scale), per_token(v_scale)
    return pool_attention_plain(q, stack(k_pages), stack(v_pages), valid,
                                scale=scale, kv_len=kv_len, k_scale=ksc,
                                v_scale=vsc)


# ------------------------------------------------------------------ SSD (K4)

def per_row(w: torch.Tensor, rows: int) -> torch.Tensor:
    """A per-head vector [H] (one layer) or [Gs, H] (one layer per stage
    group of ``rows // Gs`` rows) -> fp32 [rows, H]."""
    w = w.float()
    w = w[None] if w.ndim == 1 else w
    if rows % w.shape[0]:
        raise ValueError(f"{w.shape[0]} stage groups do not divide {rows} rows")
    return w.repeat_interleave(rows // w.shape[0], dim=0)


def ssd_plain(x, dt, a_log, b, c, d_skip, *, chunk: int, init_state=None):
    """K4: Mamba2's chunked SSD scan, one chunk of ``chunk`` positions at a
    time with the state carried between chunks in fp32 (the algorithm of
    the reference's ``_ssd_kernel``). x [R,T,H,P]; dt [R,T,H] (after
    softplus); b, c [R,T,G,N] (head h reads group h // (H/G)); a_log and
    d_skip [H] or [Gs,H] for Gs equal stage groups of rows; init_state
    [R,H,P,N] or None. ``chunk`` must divide T. Returns (y [R,T,H,P] in
    x's dtype, final state [R,H,P,N] fp32)."""
    r, t, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if t % chunk:
        raise ValueError(f"chunk {chunk} does not divide T = {t}")
    a = -torch.exp(per_row(a_log, r))[:, None, :]             # [R,1,H]
    dsk = per_row(d_skip, r)[:, None, :, None]                # [R,1,H,1]
    state = (torch.zeros((r, h, p, n), device=x.device) if init_state is None
             else init_state.float().clone())
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    ys = []
    for c0 in range(0, t, chunk):
        sl = slice(c0, c0 + chunk)
        xc = x[:, sl].float()                                 # [R,Q,H,P]
        dtc = dt[:, sl].float()                               # [R,Q,H]
        bh = b[:, sl].float().repeat_interleave(h // g, dim=2)  # [R,Q,H,N]
        ch = c[:, sl].float().repeat_interleave(h // g, dim=2)
        cs = torch.cumsum(dtc * a, dim=1)                     # [R,Q,H]
        xdt = xc * dtc[..., None]
        # intra-chunk: L[i,j] = exp(cs_i - cs_j) for j <= i, masked BEFORE
        # the exponential (above the diagonal the difference is positive)
        seg = cs[:, :, None, :] - cs[:, None, :, :]           # [R,Qi,Qj,H]
        lmat = torch.exp(seg.masked_fill(~tri[None, :, :, None], float("-inf")))
        cb = torch.einsum("rihn,rjhn->rijh", ch, bh)
        y = torch.einsum("rijh,rjhp->rihp", cb * lmat, xdt)
        # off-diagonal: the state carried in from the earlier chunks
        y = y + torch.einsum("rihn,rhpn->rihp", ch, state) * torch.exp(cs)[..., None]
        ys.append(y + xc * dsk)
        decay_out = torch.exp(cs[:, -1:] - cs)                # [R,Q,H]
        state = (state * torch.exp(cs[:, -1])[..., None, None]
                 + torch.einsum("rqhp,rqhn->rhpn", xdt * decay_out[..., None], bh))
    return torch.cat(ys, dim=1).to(x.dtype), state


# --------------------------------------------------------- flash-decode (K5)

def decode_attention_plain(q, k, v, kv_len, *, scale: Optional[float] = None):
    """K5: one query token per batch row against a KV cache. q [B,H,D];
    k/v [B,S,KVH,D] (head h reads kv head h // (H/KVH)); kv_len [B] valid
    lengths. The softmax over the first kv_len[b] keys with p kept in fp32
    before PV (``_decode_kernel``'s order) and one normalisation by
    max(l, 1e-30): a row with kv_len = 0 gives zeros, as the kernel does,
    where the reference oracle's softmax over an all -inf row gives NaN.
    Returns [B,H,D] in q's dtype."""
    b, h, d = q.shape
    s_len, kvh = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.float().reshape(b, kvh, h // kvh, d)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * scale
    valid = torch.arange(s_len, device=q.device)[None, :] < \
        torch.as_tensor(kv_len, device=q.device)[:, None]
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isfinite(m), m, torch.zeros_like(m)))
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, h, d).to(q.dtype)
