"""Shared dense layers: RMSNorm, RoPE, SwiGLU, embedding / unembedding and
the materialized-scores attention oracle (mirrors ``repro.models.layers``).

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
