"""Mamba2 (SSD — state-space duality) in PyTorch, mirroring
``repro.models.ssm``.

State layout per layer: dict(conv=[B, K-1, conv_ch], ssd=[B, H, P, N]),
both fp32. ``block_apply`` also takes stage-stacked weights (leaves
[N, ...]) over x [N, B, T, d]: the stage axis folds into the rows of the
SSD scan (N*B rows), whose ``a_log`` / ``d_skip`` then hold one row per
stage. The depthwise conv, softplus and SiLU stay plain torch, as the
reference computes them outside any Pallas kernel.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import per_row
from repro_torch.kvstore.quant import torch_dtype
from repro_torch.models import layers as L

Params = Dict[str, Any]

# kept in fp32 whatever the model dtype (the reference's init)
FP32_PARAMS = frozenset({"a_log", "dt_bias", "d_skip"})


def dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nheads = d_in // s.head_dim
    conv_ch = d_in + 2 * s.n_groups * s.d_state
    return d_in, nheads, conv_ch


# ----------------------------------------------------------------- SSD core

def segsum(x: torch.Tensor) -> torch.Tensor:
    """x [..., T] -> [..., T, T] with out[i,j] = sum_{k=j+1..i} x[k], -inf for j>i."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    return out.masked_fill(~mask, float("-inf"))


def ssd_chunked(x, dt, a_log, b, c, d_skip, *, chunk: int,
                init_state: Optional[torch.Tensor] = None):
    """Chunked SSD scan (Mamba2 alg. 1 "minimal"), the ``torch`` SSD
    backend. x [B,T,H,P]; dt [B,T,H] (post-softplus); a_log, d_skip [H] or
    [Gs,H] (one row per stage group); b, c [B,T,G,N]. Returns
    y [B,T,H,P] in x's dtype and the final state [B,H,P,N] fp32."""
    bs, t, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    hg = h // g
    nc = -(-t // chunk)
    pad = nc * chunk - t
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
    a = -torch.exp(per_row(a_log, bs))                        # [B,H] negative
    da = dt.float() * a[:, None, :]                           # [B,T,H]
    xdt = x.float() * dt.float()[..., None]
    xc = xdt.reshape(bs, nc, chunk, h, p)
    dac = da.reshape(bs, nc, chunk, h).permute(0, 1, 3, 2)    # [B,nc,H,Q]
    bh = b.float().reshape(bs, nc, chunk, g, n).repeat_interleave(hg, dim=3)
    ch = c.float().reshape(bs, nc, chunk, g, n).repeat_interleave(hg, dim=3)
    # intra-chunk ("diagonal") term
    lmat = torch.exp(segsum(dac))                             # [B,nc,H,Q,Q]
    cb = torch.einsum("bcqhn,bckhn->bchqk", ch, bh)
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", cb * lmat, xc)
    # chunk states: decay from position q to the END of the chunk
    dac_cs = torch.cumsum(dac, dim=-1)                        # [B,nc,H,Q]
    decay_out = torch.exp(dac_cs[..., -1:] - dac_cs)
    states = torch.einsum("bchq,bcqhn,bcqhp->bchpn", decay_out, bh, xc)
    # inter-chunk recurrence
    chunk_decay = torch.exp(dac_cs[..., -1])                  # [B,nc,H]
    st = (torch.zeros((bs, h, p, n), device=x.device) if init_state is None
          else init_state.float())
    prev = []
    for ci in range(nc):
        prev.append(st)
        st = st * chunk_decay[:, ci, :, None, None] + states[:, ci]
    prev_states = torch.stack(prev, dim=1)                    # [B,nc,H,P,N]
    # inter-chunk ("off-diagonal") output
    y_off = torch.einsum("bcqhn,bchpn,bchq->bcqhp", ch, prev_states,
                         torch.exp(dac_cs))
    y = (y_diag + y_off).reshape(bs, nc * chunk, h, p)
    y = y + x.float() * per_row(d_skip, bs)[:, None, :, None]
    if pad:
        y = y[:, :t]
    return y.to(x.dtype), st


def _ssd_cuda(x, dt, a_log, b, c, d_skip, *, chunk: int,
              init_state: Optional[torch.Tensor] = None):
    """Kernel K4 behind the ``ssm_backend`` knob (``ops.ssd``, looked up at
    call time); same signature and semantics as ``ssd_chunked``. The
    projections hand over strided views, the kernel takes dense rows."""
    return ops.ssd(x.contiguous(), dt.contiguous(), a_log, b.contiguous(),
                   c.contiguous(), d_skip, chunk=chunk,
                   init_state=None if init_state is None else init_state.contiguous())


# SSD inner-loop registry, selected per plan via ``RunConfig.ssm_backend``
SSD_IMPLS = {"torch": ssd_chunked, "cuda": _ssd_cuda}


# ------------------------------------------------------------------- conv1d

def causal_conv(x, w, bias, *, init_state=None):
    """Depthwise causal conv. x [B,T,C]; w [K,C] (or per row [B,K,C]);
    bias [C] (or [B,C]). Returns (y, the last K-1 inputs)."""
    k = w.shape[-2]
    if init_state is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([init_state.to(x.dtype), x], dim=1)
    wk = w if w.ndim == 3 else w[None]
    t = x.shape[1]
    y = sum(xp[:, i:i + t, :] * wk[:, i][:, None, :] for i in range(k))
    tail = xp[:, xp.shape[1] - (k - 1):, :]
    return y + (bias if bias.ndim == 1 else bias[:, None, :]), tail


# ------------------------------------------------------------------- block

def init_block(cfg: ModelConfig, generator: torch.Generator,
               lead: Sequence[int], *, nl: int, device=None,
               dtype=None) -> Params:
    """Random Mamba2 block weights with the reference's shapes and
    distributions (``repro.models.ssm.init_block``) under leading axes
    ``lead``; ``nl`` is the layer count the out-projection std is scaled
    by. ``a_log``, ``dt_bias`` and ``d_skip`` are fp32."""
    d = cfg.d_model
    s = cfg.ssm
    d_in, nheads, conv_ch = dims(cfg)
    dt = torch_dtype(dtype or cfg.dtype)
    lead = tuple(lead)

    def nrm(*shape, std=0.02):
        x = torch.randn(lead + shape, generator=generator, device=device, dtype=dt)
        return x.mul_(std)

    u = torch.rand(lead + (nheads,), generator=generator, device=device)
    dt_init = torch.exp(u * (math.log(s.dt_max) - math.log(s.dt_min))
                        + math.log(s.dt_min))
    return {
        "ln": torch.ones(lead + (d,), device=device, dtype=dt),
        "in_proj": nrm(d, 2 * d_in + 2 * s.n_groups * s.d_state + nheads),
        "conv_w": nrm(s.conv_kernel, conv_ch, std=0.2),
        "conv_b": torch.zeros(lead + (conv_ch,), device=device, dtype=dt),
        "a_log": torch.log(torch.arange(1, nheads + 1, dtype=torch.float32,
                                        device=device)).expand(lead + (nheads,)).clone(),
        "dt_bias": dt_init + torch.log(-torch.expm1(-dt_init)),   # inverse softplus
        "d_skip": torch.ones(lead + (nheads,), device=device),
        "gate_norm": torch.ones(lead + (d_in,), device=device, dtype=dt),
        "out_proj": nrm(d_in, d, std=0.02 / math.sqrt(2 * nl)),
    }


def block_apply(cfg: ModelConfig, lp: Params, x: torch.Tensor, *,
                state: Optional[Dict[str, torch.Tensor]] = None,
                ssd_impl: str = "torch"):
    """Mamba2 block over a (chunk of a) sequence. Returns (y, new_state).

    One layer: x [B,T,d] and lp leaves as ``init_block`` makes them for one
    layer. Stage-stacked: x [N,B,T,d], lp leaves [N, ...] and state leaves
    [N,B,...]. ``ssd_impl`` picks the SSD inner loop from ``SSD_IMPLS``."""
    if x.ndim == 3:
        y, st = block_apply(
            cfg, {k: w[None] for k, w in lp.items()}, x[None],
            state=None if state is None else {k: v[None] for k, v in state.items()},
            ssd_impl=ssd_impl)
        return y[0], {k: v[0] for k, v in st.items()}
    if ssd_impl not in SSD_IMPLS:
        raise KeyError(f"unknown ssm backend {ssd_impl!r}; "
                       f"registered: {sorted(SSD_IMPLS)}")
    n, b, t, d = x.shape
    s = cfg.ssm
    d_in, nheads, conv_ch = dims(cfg)
    gn = s.n_groups * s.d_state

    def rows(w: torch.Tensor) -> torch.Tensor:   # [N, ...] -> [N*B, ...]
        return w.repeat_interleave(b, dim=0)

    hn = L.rms_norm(x, lp["ln"][:, None, None, :], cfg.norm_eps)
    zxbcdt = torch.matmul(hn.reshape(n, b * t, d), lp["in_proj"]).reshape(n * b, t, -1)
    z, xbc, dtv = torch.split(zxbcdt, [d_in, conv_ch, nheads], dim=-1)
    conv_init = None if state is None else state["conv"].flatten(0, 1)
    xbc, conv_tail = causal_conv(xbc, rows(lp["conv_w"]), rows(lp["conv_b"]),
                                 init_state=conv_init)
    xbc = F.silu(xbc)
    xs, bmat, cmat = torch.split(xbc, [d_in, gn, gn], dim=-1)
    xh = xs.reshape(n * b, t, nheads, s.head_dim)
    bmat = bmat.reshape(n * b, t, s.n_groups, s.d_state)
    cmat = cmat.reshape(n * b, t, s.n_groups, s.d_state)
    dtv = F.softplus(dtv.float() + rows(lp["dt_bias"]).float()[:, None, :])
    ssd_init = None if state is None else state["ssd"].flatten(0, 1)
    y, new_ssd = SSD_IMPLS[ssd_impl](xh, dtv, lp["a_log"], bmat, cmat,
                                     lp["d_skip"], chunk=s.chunk_size,
                                     init_state=ssd_init)
    y = y.reshape(n * b, t, d_in) * F.silu(z.float()).to(y.dtype)
    y = L.rms_norm(y.reshape(n, b * t, d_in), lp["gate_norm"][:, None, :], cfg.norm_eps)
    out = torch.matmul(y, lp["out_proj"]).reshape(n, b, t, d)
    new_state = {"conv": conv_tail.float().reshape(n, b, *conv_tail.shape[1:]),
                 "ssd": new_ssd.reshape(n, b, *new_ssd.shape[1:])}
    return x + out, new_state


# ---------------------------------------------------------------- LM wiring

def init(cfg: ModelConfig, generator: torch.Generator, device=None,
         dtype=None) -> Params:
    dt = torch_dtype(dtype or cfg.dtype)
    return {
        "embed": L.init_embed(cfg.vocab_size, cfg.d_model, generator, device, dt),
        "final_norm": torch.ones((cfg.d_model,), device=device, dtype=dt),
        "layers": init_block(cfg, generator, (cfg.num_layers,), nl=cfg.num_layers,
                             device=device, dtype=dtype),
    }


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            *, ssd_impl: str = "torch") -> torch.Tensor:
    """Full-sequence forward; returns fp32 logits [B, S, Vpad]."""
    x = L.embed_lookup(params["embed"], tokens)
    layers = params["layers"]
    for i in range(cfg.num_layers):
        x, _ = block_apply(cfg, {k: w[i] for k, w in layers.items()}, x,
                           ssd_impl=ssd_impl)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed_logits(x, params["embed"].T)
