"""Mamba2 (SSD — state-space duality) in PyTorch, mirroring
``repro.models.ssm``.

State layout per layer: dict(conv=[B, K-1, conv_ch], ssd=[B, H, P, N]),
both fp32. ``block_apply`` also takes stage-stacked weights (leaves
[N, ...]) over x [N, B, T, d]: the stage axis folds into the rows of the
SSD scan (N*B rows), whose ``a_log`` / ``d_skip`` then hold one row per
stage. The depthwise conv, softplus and SiLU stay plain torch, as the
reference computes them outside any Pallas kernel.

Decode (``block_decode``, ``decode_step``) advances one token with the
single-token SSD update, two small einsums as in the reference (no kernel).
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
    call time); same signature and semantics as ``ssd_chunked``. x, b and c
    are the block's views into its conv output, which K4 reads in place
    (``ops.ssd_strides``)."""
    return ops.ssd(x, dt.contiguous(), a_log, b, c, d_skip, chunk=chunk,
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


def causal_conv_step(x, w, bias, conv_state):
    """One decode step of the conv. x [B,C]; w [K,C]; conv_state [B,K-1,C]
    (fp32), rounded to x's dtype before the taps as in the reference.
    Returns (y [B,C], the new state [B,K-1,C] in x's dtype)."""
    full = torch.cat([conv_state.to(x.dtype), x[:, None, :]], dim=1)   # [B,K,C]
    return torch.einsum("bkc,kc->bc", full, w) + bias, full[:, 1:]


def ssd_decode_step(x, dt, a_log, b, c, d_skip, state):
    """Single-token SSD update. x [B,H,P]; dt [B,H] (after softplus); b, c
    [B,G,N]; a_log, d_skip [H]; state [B,H,P,N] fp32. Returns (y [B,H,P] in
    x's dtype, the new state fp32)."""
    h, g = x.shape[1], b.shape[1]
    dtf = dt.float()
    dec = torch.exp(dtf * -torch.exp(a_log.float()))                  # [B,H]
    bh = b.float().repeat_interleave(h // g, dim=1)                   # [B,H,N]
    ch = c.float().repeat_interleave(h // g, dim=1)
    xdt = x.float() * dtf[..., None]                                  # [B,H,P]
    new_state = state * dec[:, :, None, None] + torch.einsum("bhp,bhn->bhpn", xdt, bh)
    y = torch.einsum("bhn,bhpn->bhp", ch, new_state)
    y = y + x.float() * d_skip.float()[None, :, None]
    return y.to(x.dtype), new_state


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


def block_decode(cfg: ModelConfig, lp: Params, x: torch.Tensor,
                 state: Dict[str, torch.Tensor]):
    """One layer, one token: x [B,1,d]; state {"conv": [B,K-1,C], "ssd":
    [B,H,P,N]} fp32. Returns (y [B,1,d], the new state, fp32)."""
    b = x.shape[0]
    s = cfg.ssm
    d_in, nheads, conv_ch = dims(cfg)
    gn = s.n_groups * s.d_state
    hn = L.rms_norm(x[:, 0], lp["ln"], cfg.norm_eps)
    z, xbc, dtv = torch.split(torch.matmul(hn, lp["in_proj"]), [d_in, conv_ch, nheads],
                              dim=-1)
    xbc, conv_state = causal_conv_step(xbc, lp["conv_w"], lp["conv_b"], state["conv"])
    xs, bmat, cmat = torch.split(F.silu(xbc), [d_in, gn, gn], dim=-1)
    dtv = F.softplus(dtv.float() + lp["dt_bias"].float())
    y, new_ssd = ssd_decode_step(xs.reshape(b, nheads, s.head_dim), dtv, lp["a_log"],
                                 bmat.reshape(b, s.n_groups, s.d_state),
                                 cmat.reshape(b, s.n_groups, s.d_state), lp["d_skip"],
                                 state["ssd"])
    y = y.reshape(b, d_in)
    y = L.rms_norm(y * F.silu(z.float()).to(y.dtype), lp["gate_norm"], cfg.norm_eps)
    out = torch.matmul(y, lp["out_proj"])
    return x + out[:, None], {"conv": conv_state.float(), "ssd": new_ssd}


def decode_layer(cfg: ModelConfig, lp: Params, x: torch.Tensor,
                 conv: torch.Tensor, ssd: torch.Tensor) -> torch.Tensor:
    """``block_decode`` whose new state is written IN PLACE into the layer's
    state tensors ``conv`` [B,K-1,C] and ``ssd`` [B,H,P,N]."""
    x, st = block_decode(cfg, lp, x, {"conv": conv, "ssd": ssd})
    conv.copy_(st["conv"])
    ssd.copy_(st["ssd"])
    return x


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
            *, embeds: Optional[torch.Tensor] = None, impl: str = "naive",
            remat: bool = False, ssd_impl: str = "torch", return_cache: bool = False):
    """Full-sequence forward of ``embeds`` (optional, [B, Si, d], spliced in
    front as in the reference) then ``tokens``; returns fp32 logits
    [B, S, Vpad] and, with ``return_cache``, also the state {"conv":
    [L,B,K-1,C], "ssd": [L,B,H,P,N] fp32, "pos": [B] int32 = S}. ``impl``
    is taken for the families' common signature (no attention here);
    ``remat``: each block under ``layers.remat_call``."""
    x = L.embed_lookup(params["embed"], tokens)
    if embeds is not None:
        x = torch.cat([embeds.to(x.dtype), x], dim=1)
    sts = []

    def body(xc, lp):
        return block_apply(cfg, lp, xc, ssd_impl=ssd_impl)

    for lp in L.unstack(params["layers"])[:cfg.num_layers]:
        x, st = L.remat_call(body, remat, x, lp)
        sts.append(st)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = L.unembed_logits(x, params["embed"].T)
    if not return_cache:
        return logits
    pos = torch.full((tokens.shape[0],), x.shape[1], dtype=torch.int32, device=x.device)
    return logits, {"conv": torch.stack([st["conv"] for st in sts]),
                    "ssd": torch.stack([st["ssd"] for st in sts]), "pos": pos}


def state_shapes(cfg: ModelConfig, lead: Sequence[int], batch: int):
    """{"conv", "ssd": (shape, fp32)} of Mamba2 states under leading axes
    ``lead``."""
    s = cfg.ssm
    _, nheads, conv_ch = dims(cfg)
    lead = tuple(lead)
    return {"conv": (lead + (batch, s.conv_kernel - 1, conv_ch), torch.float32),
            "ssd": (lead + (batch, nheads, s.head_dim, s.d_state), torch.float32)}


def init_cache_shape(cfg: ModelConfig, batch: int, max_len: int):
    """{leaf: (shape, dtype)} of the decode state (the reference's
    ``init_state_shape``); it has no length, so ``max_len`` is unused."""
    return {**state_shapes(cfg, (cfg.num_layers,), batch),
            "pos": ((batch,), torch.int32)}


def decode_step(cfg: ModelConfig, params: Params, state: Params,
                tokens: torch.Tensor):
    """One-token decode. tokens [B] int. Returns (logits [B, Vpad] fp32,
    state). The conv and SSD states are updated IN PLACE (the reference
    returns new ones); the returned dict holds them and ``pos + 1`` as a new
    tensor."""
    x = L.embed_lookup(params["embed"], tokens[:, None])
    layers = params["layers"]
    for i in range(cfg.num_layers):
        x = decode_layer(cfg, {k: w[i] for k, w in layers.items()}, x,
                         state["conv"][i], state["ssd"][i])
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = L.unembed_logits(x, params["embed"].T)
    return logits[:, 0], {**state, "pos": state["pos"] + 1}
