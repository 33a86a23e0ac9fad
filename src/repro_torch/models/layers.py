"""Shared layers: RMSNorm, RoPE, SwiGLU, the token-choice MoE, embedding /
unembedding, the attention implementations and the cross-entropy loss
(mirrors ``repro.models.layers``).

Attention has two implementations, selected by ``impl``:

- ``"naive"``     the materialized-scores oracle (the default of the
                  forwards, which the serve and decode paths hold to);
- ``"xla_flash"`` the blocked online softmax over key blocks of
                  ``DEFAULT_BLOCK_K`` (the reference's training default),
                  plain torch ops, so autograd differentiates it.

The reference's third, ``"pallas"``, is K1, which has no backward: the
chunked pipeline reaches it through ``kernels.ops``.

Weights are plain tensors. Products go through ``torch.matmul``, which
broadcasts a leading stage axis: ``[N, B*C, d] @ [N, d, f]`` runs all N
pipeline stages as one batched product.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

DEFAULT_BLOCK_K = 1024


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in fp32, cast back to x's dtype; ``w`` broadcasts against x."""
    dt = x.dtype
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (y * w.float()).to(dt)


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [..., S] -> cos, sin [..., S, head_dim // 2] (fp32)."""
    half = head_dim // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=torch.float32,
                                     device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, D]; cos/sin [S, half] or [B, S, half]."""
    half = x.shape[-1] // 2
    if cos.ndim == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def naive_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal_offset: Optional[int] = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Oracle. q [B, Sq, H, D], k/v [B, Skv, K, D]; ``causal_offset`` is the
    position of q[0] minus that of k[0]; ``None`` disables masking."""
    b, sq, h, d = q.shape
    kheads = k.shape[2]
    scale = scale or (1.0 / math.sqrt(d))
    qg = q.reshape(b, sq, kheads, h // kheads, d).float()
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    if causal_offset is not None:
        qpos = torch.arange(sq, device=q.device)[:, None] + causal_offset
        kpos = torch.arange(k.shape[1], device=q.device)[None, :]
        scores = scores.masked_fill(~(kpos <= qpos), float("-inf"))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(), v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


def flash_attention_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal_offset: Optional[int] = 0, scale: Optional[float] = None,
                        block_k: int = DEFAULT_BLOCK_K) -> torch.Tensor:
    """Blocked online-softmax attention over key blocks of ``block_k`` (the
    reference's ``lax.scan`` as a Python loop); memory O(Sq * block_k)
    instead of O(Sq * Skv). Scores, p and the accumulator are fp32 (the
    reference's ``preferred_element_type``: q, k and v are widened before
    each product, p is rounded to v's dtype first, as there). The naive
    oracle when ``Skv <= block_k``."""
    b, sq, h, d = q.shape
    skv, kheads = k.shape[1], k.shape[2]
    if skv <= block_k:
        return naive_attention(q, k, v, causal_offset=causal_offset, scale=scale)
    scale = scale or (1.0 / math.sqrt(d))
    nblk = -(-skv // block_k)
    pad = nblk * block_k - skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    g = h // kheads
    qg = q.reshape(b, sq, kheads, g, d).float()
    qpos = torch.arange(sq, device=q.device)[:, None] + (
        0 if causal_offset is None else causal_offset)
    m = torch.full((b, kheads, g, sq), float("-inf"), device=q.device)
    l = torch.zeros((b, kheads, g, sq), device=q.device)
    acc = torch.zeros((b, kheads, g, sq, d), device=q.device)
    for j in range(nblk):
        kj = k[:, j * block_k:(j + 1) * block_k]
        vj = v[:, j * block_k:(j + 1) * block_k]
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, kj.float()) * scale
        kpos = j * block_k + torch.arange(block_k, device=q.device)[None, :]
        valid = kpos < skv
        if causal_offset is not None:
            valid = valid & (kpos <= qpos)
        s = s.masked_fill(~valid, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        # guard fully-masked rows (m_new == -inf)
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        corr = torch.exp(torch.where(torch.isfinite(m), m - m_safe, float("-inf")))
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(vj.dtype).float(), vj.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


def attention(q, k, v, *, causal_offset: Optional[int] = 0,
              scale: Optional[float] = None, impl: str = "naive",
              block_k: int = DEFAULT_BLOCK_K) -> torch.Tensor:
    """``naive_attention`` or ``flash_attention_xla`` by ``impl``."""
    if impl == "naive":
        return naive_attention(q, k, v, causal_offset=causal_offset, scale=scale)
    if impl == "xla_flash":
        return flash_attention_xla(q, k, v, causal_offset=causal_offset, scale=scale,
                                   block_k=block_k)
    raise ValueError(f"unknown attention impl {impl!r}; known: naive, xla_flash")


def zeros(shapes, device=None):
    """{leaf: (shape, dtype)} -> {leaf: zeros} on ``device`` (a cache or a
    decode state from its ``init_*_shape``)."""
    return {k: torch.zeros(shape, dtype=dt, device=device)
            for k, (shape, dt) in shapes.items()}


def swiglu(params, x: torch.Tensor) -> torch.Tensor:
    """x [..., d] with wg/wu [..., d, f], wd [..., f, d]."""
    g = torch.matmul(x, params["wg"])
    u = torch.matmul(x, params["wu"])
    return torch.matmul(F.silu(g) * u, params["wd"])


def moe_capacity(s: int, top_k: int, num_real: int, capacity_factor: float) -> int:
    """Slots an expert has for a dispatch over ``s`` tokens (the
    reference's rule, float expression and all)."""
    return max(int(math.ceil(s * top_k / num_real * capacity_factor)), top_k)


def moe_route(x: torch.Tensor, router: torch.Tensor, *, top_k: int,
              num_real: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Router of the token-choice MoE. x [..., S, d]; router [..., d, E]
    (leading axes broadcast as ``torch.matmul`` does). Logits in fp32
    (the reference's ``preferred_element_type``); experts past
    ``num_real`` are never routable. The k choices come from a stable
    descending sort, so equal logits pick the lower expert, as
    ``jax.lax.top_k`` does (a zero chunk or a zero router ties every
    expert). Returns (weights [..., S, k] fp32: the softmax over the k
    chosen logits, choices [..., S, k] int64)."""
    logits = torch.matmul(x.float(), router.float())
    e = logits.shape[-1]
    if num_real and num_real < e:
        logits = logits.masked_fill(torch.arange(e, device=x.device) >= num_real, -1e30)
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    vals = vals[..., :top_k]
    u = torch.exp(vals - vals.amax(dim=-1, keepdim=True))
    return u / u.sum(dim=-1, keepdim=True), idx[..., :top_k]


def moe_dispatch(choices: torch.Tensor, weights: torch.Tensor, num_experts: int,
                 cap: int):
    """Capacity-bounded sort dispatch of each row's (token, slot) pairs
    (the reference's ``dispatch_one``). choices / weights [R, S, k]. The
    pairs of an expert keep token order (a stable sort), the first ``cap``
    of them get slots 0..cap-1 and the rest are dropped; every shape is
    static and nothing is read back to the host. Returns (tok, valid, w)
    [R, E, cap] (token id int32, slot used, fp32 weight; an empty slot
    holds token 0, weight 0) and pos [R, S*k]: each pair's flat slot
    e * cap + rank, or E * cap when it was dropped."""
    r, s, k = choices.shape
    e = num_experts
    dev = choices.device
    flat_e = choices.reshape(r, s * k)
    order = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = flat_e.gather(1, order)
    # rank within an expert's run of the sorted pairs: position minus the
    # run's start (the pairs routed to lower experts)
    counts = torch.zeros((r, e), dtype=torch.long, device=dev).scatter_add_(
        1, flat_e, torch.ones_like(flat_e))
    start = (counts.cumsum(1) - counts).gather(1, sorted_e)
    rank = torch.arange(s * k, device=dev) - start
    keep = rank < cap
    drop = e * cap                                  # the discarded slot
    slot = torch.where(keep, sorted_e * cap + rank, drop)
    size = (r, e * cap + 1)
    tok = torch.zeros(size, dtype=torch.int32, device=dev).scatter_(
        1, slot, (order // k).to(torch.int32))
    valid = torch.zeros(size, dtype=torch.bool, device=dev).scatter_(1, slot, True)
    w = torch.zeros(size, dtype=torch.float32, device=dev).scatter_(
        1, slot, weights.reshape(r, s * k).float().gather(1, order))
    pos = torch.empty_like(slot).scatter_(1, order, slot)
    return (tok[:, :drop].reshape(r, e, cap), valid[:, :drop].reshape(r, e, cap),
            w[:, :drop].reshape(r, e, cap), pos)


def expert_ffn(xs: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
               wd: torch.Tensor) -> torch.Tensor:
    """The SwiGLU of E experts at once: xs [E, n, d] with wg / wu [E, d, f],
    wd [E, f, d] -> [E, n, d] (``moe_layer``'s expert products; a fresh
    tensor, so autograd differentiates it)."""
    h = F.silu(torch.matmul(xs, wg)) * torch.matmul(xs, wu)
    return torch.matmul(h, wd)


def moe_layer(params, x: torch.Tensor, *, num_experts: int, top_k: int,
              capacity_factor: float, num_real: int = 0, sharded: bool = False,
              ep: bool = False) -> torch.Tensor:
    """Token-choice top-k MoE with per-row capacity-bounded sort dispatch
    (the reference's ``moe_layer``, default layout). x [B, S, d] with
    router [d, E], wg / wu [E, d, f], wd [E, f, d]; or, stage-stacked,
    x [G, B, S, d] with a leading G on every weight (each group's rows use
    its own experts). Each row dispatches over its own S tokens with
    ``moe_capacity(S, ...)`` slots an expert. The expert FFNs run as
    products batched over the E experts, one group at a time ([E, B*cap,
    d] @ [E, d, f]): a layer's expert weights of the G pipeline stages
    are views ``[:, layer]`` of [G, lps, E, d, f], which no single strided
    batch over (G, E) covers, and folding them would copy every expert's
    weights at every call. The combine inverts the dispatch: each token
    sums its k slots' weighted outputs in slot order in fp32, then casts
    to x's dtype (the reference scatter-adds in x's dtype; this is
    deterministic and at most one rounding from it).

    ``sharded`` (the manual TP lowering, stage-stacked only): the expert
    weights carry a tp axis after G, [G, tp, E / tp, d, f] under expert
    parallelism (``ep``: shard t holds experts [t E / tp, (t + 1) E / tp),
    kv-major as the reference slices them) or [G, tp, E, d, f / tp]
    (f-sharded). Routing and dispatch are computed once, replicated, as in
    the reference; each shard runs its own expert rows, and the return is
    every shard's PARTIAL combine [G, tp, B, S, d] (its own experts' slots,
    or its f-slice of every slot), which the caller sums over the tp axis
    (the reference's psum). Padded experts are never routable
    (``num_real``)."""
    grouped = params["router"].ndim == 3
    if not grouped:
        params = {n: w[None] for n, w in params.items()}
        x = x[None]
    g, b, s, d = x.shape
    e, k = num_experts, top_k
    cap = moe_capacity(s, k, num_real or e, capacity_factor)
    weights, choices = moe_route(x.reshape(g, b * s, d), params["router"], top_k=k,
                                 num_real=num_real)
    tok, valid, wgt, pos = moe_dispatch(choices.reshape(g * b, s, k),
                                        weights.reshape(g * b, s, k), e, cap)
    xr = x.reshape(g * b, s, d)
    xd = xr.gather(1, tok.reshape(g * b, e * cap, 1).long().expand(-1, -1, d))
    xd = xd * valid.reshape(g * b, e * cap, 1).to(x.dtype)
    xd = xd.reshape(g, b, e, cap, d).transpose(1, 2).reshape(g, e, b * cap, d)

    def pairs_of(y: torch.Tensor) -> torch.Tensor:
        """Each (token, slot)'s weighted output [G, B, S, k, d] of the
        expert outputs y [G, E, B*cap, d] (zero for a dropped pair)."""
        y = y.reshape(g, e, b, cap, d).transpose(1, 2).reshape(g * b, e * cap, d)
        y = y * (wgt * valid).reshape(g * b, e * cap, 1).to(y.dtype)
        kept = pos < e * cap
        pairs = y.gather(1, torch.where(kept, pos, 0)[..., None].expand(-1, -1, d))
        return torch.where(kept[..., None], pairs, 0).reshape(g, b, s, k, d)

    if not sharded:
        y = torch.stack([expert_ffn(xd[i], params["wg"][i], params["wu"][i], params["wd"][i])
                         for i in range(g)])
        out = pairs_of(y).float().sum(3).to(x.dtype)
        return out if grouped else out[0]
    shards = params["wg"].shape[1]
    if ep:
        e_loc = e // shards
        y = torch.stack([torch.cat([expert_ffn(xd[i, t * e_loc:(t + 1) * e_loc],
                                               params["wg"][i, t], params["wu"][i, t],
                                               params["wd"][i, t])
                                    for t in range(shards)]) for i in range(g)])
        pairs = pairs_of(y)
        owner = (choices.reshape(g, b, s, k) // e_loc)[..., None]
        parts = [torch.where(owner == t, pairs, 0).float().sum(3) for t in range(shards)]
    else:
        parts = []
        for t in range(shards):
            y = torch.stack([expert_ffn(xd[i], params["wg"][i, t], params["wu"][i, t],
                                        params["wd"][i, t]) for i in range(g)])
            parts.append(pairs_of(y).float().sum(3))
    return torch.stack(parts, dim=1).to(x.dtype)


def unstack(stacked: dict, lead: int = 1) -> list:
    """Stacked layer params (leaves [L, ...], or [G, pg, ...] with
    ``lead`` 2) -> one dict of views a layer, in order. One ``unbind`` a
    leaf, so autograd stacks a leaf's gradient once, not one full-size
    scatter a layer."""
    names = list(stacked)
    cols = [stacked[n].flatten(0, lead - 1).unbind(0) for n in names]
    return [dict(zip(names, ws)) for ws in zip(*cols)]


def remat_call(fn, remat: bool, *args):
    """``fn(*args)``; with ``remat``, under ``torch.utils.checkpoint``
    (non-reentrant): its activations are recomputed in the backward
    instead of saved, the counterpart of the reference's
    ``jax.checkpoint(policy=nothing_saveable)``."""
    return checkpoint(fn, *args, use_reentrant=False) if remat else fn(*args)


def pad_vocab(v: int, multiple: int = 128) -> int:
    return -(-v // multiple) * multiple


def init_embed(vocab_size: int, d_model: int, generator: torch.Generator,
               device=None, dtype=None) -> torch.Tensor:
    """A random embedding table [Vpad, d] with the reference's std 0.02."""
    return torch.randn((pad_vocab(vocab_size), d_model), generator=generator,
                       device=device, dtype=dtype).mul_(0.02)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """table [Vpad, d], tokens [B, S] -> [B, S, d]."""
    return table[tokens.long()]


def unembed_logits(x: torch.Tensor, w: torch.Tensor, *,
                   scale: float = 1.0) -> torch.Tensor:
    """x [B, S, d] @ w [d, Vpad] -> fp32 logits (fp32 products, as the
    reference's ``preferred_element_type=float32``)."""
    logits = torch.matmul(x.float(), w.float())
    if scale != 1.0:
        logits = logits / scale
    return logits


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab_size: int) -> torch.Tensor:
    """Mean token cross-entropy over fp32 logits [B, S, Vpad] (the padded
    vocab masked to -inf) and labels [B, S]: logsumexp minus the true
    logit, then the mean (the reference's ``cross_entropy``)."""
    if logits.shape[-1] > vocab_size:
        pad = torch.arange(logits.shape[-1], device=logits.device) >= vocab_size
        logits = logits.masked_fill(pad, float("-inf"))
    lse = torch.logsumexp(logits, dim=-1)
    true_logit = logits.gather(-1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - true_logit)
