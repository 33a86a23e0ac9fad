"""Shared layers: RMSNorm, RoPE, SwiGLU, the token-choice MoE, embedding /
unembedding and the materialized-scores attention oracle (mirrors
``repro.models.layers``).

Weights are plain tensors. Products go through ``torch.matmul``, which
broadcasts a leading stage axis: ``[N, B*C, d] @ [N, d, f]`` runs all N
pipeline stages as one batched product.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


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


def moe_layer(params, x: torch.Tensor, *, num_experts: int, top_k: int,
              capacity_factor: float, num_real: int = 0) -> torch.Tensor:
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
    deterministic and at most one rounding from it)."""
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
    y = xd.new_empty((g, e, b * cap, d))
    for i in range(g):
        h = F.silu(torch.matmul(xd[i], params["wg"][i])) * torch.matmul(xd[i], params["wu"][i])
        torch.matmul(h, params["wd"][i], out=y[i])
    y = y.reshape(g, e, b, cap, d).transpose(1, 2).reshape(g * b, e * cap, d)
    y = y * (wgt * valid).reshape(g * b, e * cap, 1).to(y.dtype)
    kept = pos < e * cap
    pairs = y.gather(1, torch.where(kept, pos, 0)[..., None].expand(-1, -1, d))
    pairs = torch.where(kept[..., None], pairs, 0)
    out = pairs.reshape(g, b, s, k, d).float().sum(3).to(x.dtype)
    return out if grouped else out[0]


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
