"""Plain PyTorch reference of the dense decoder family (Qwen3: grouped-query
attention with RMSNorm on each head's q and k, rotary positions on the two
halves of a head, a SwiGLU MLP, pre-norm residuals, an untied head).

Written from the published architecture (Hugging Face ``Qwen3ForCausalLM``)
in float32 with TF32 off, and independent of the program: it imports
nothing of ``repro_torch`` and remakes every weight from the run's seed
(``harness.weights``), one layer at a time. It returns the next-token
logits of each prompt, the one output a prefill-only request has.

``precision="fp8"`` is the control of the check: every matrix product's
inputs (weights per output column, activations per row, q / k / v per
(token, head), the attention probabilities per row) are rounded to
float8 e4m3 with a scale of their own, as an fp8 path would hold them; the
products still sum in float32. ``control_readings`` runs it beside the
float32 reference, on the same prompts.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from portbench.harness import weights as W

FP8_MAX = 448.0        # the largest finite float8 e4m3fn


def dims(conf: dict) -> Dict[str, int]:
    d = conf["hidden_size"]
    h = conf["num_attention_heads"]
    return dict(d=d, h=h, kv=conf["num_key_value_heads"],
                hd=conf.get("head_dim") or d // h, f=conf["intermediate_size"],
                v=conf["vocab_size"], layers=conf["num_hidden_layers"])


def layer_spec(conf: dict) -> W.Spec:
    """One layer's leaves, in the (in, out) orientation of ``x @ w``. The
    output projections' std shrinks with depth (0.02 / sqrt(2 L)), the usual
    random initialisation, so the residual stream stays in range."""
    m = dims(conf)
    d, h, kv, hd, f = m["d"], m["h"], m["kv"], m["hd"], m["f"]
    out_std = 0.02 / math.sqrt(2 * m["layers"])
    spec = [("ln1", (d,), "norm"), ("ln2", (d,), "norm"),
            ("wq", (d, h * hd), 0.02), ("wk", (d, kv * hd), 0.02),
            ("wv", (d, kv * hd), 0.02), ("wo", (h * hd, d), out_std)]
    if conf.get("qk_norm"):
        spec += [("q_norm", (hd,), "norm"), ("k_norm", (hd,), "norm")]
    spec += [("wg", (d, f), 0.02), ("wu", (d, f), 0.02), ("wd", (f, d), out_std)]
    return spec


def global_specs(conf: dict) -> Dict[str, W.Spec]:
    """The groups outside the layers, by tag."""
    m = dims(conf)
    return {"embed": [("embed", (m["v"], m["d"]), 0.02)],
            "final_norm": [("final_norm", (m["d"],), "norm")],
            "head": [("lm_head", (m["d"], m["v"]), 0.02)]}


def layer_tag(i: int) -> str:
    return f"layer{i}"


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


class Arith:
    """The products and the rounding of their inputs at one precision."""

    def __init__(self, precision: str):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision {precision!r}: fp32 | fp8")
        self.fp8 = precision == "fp8"

    def w(self, w: torch.Tensor) -> torch.Tensor:
        return _fp8(w, 0) if self.fp8 else w

    def a(self, x: torch.Tensor) -> torch.Tensor:
        return _fp8(x, -1) if self.fp8 else x

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.a(x) @ w


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [S, H, D] at positions 0..S-1: the first and second halves of each
    head are the pair rotated (Hugging Face's ``rotate_half``)."""
    s, _, dh = x.shape
    half = dh // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64, device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv
    cos, sin = ang.cos().float()[:, None, :], ang.sin().float()[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, ar: Arith, q_block: int) -> torch.Tensor:
    """q [S, H, D], k / v [S, KV, D] -> [S, H, D]; softmax(q k^T / sqrt(D))
    over keys j <= i, a block of queries at a time (scores [KV, G, b, j])."""
    s, h, dh = q.shape
    kvh = k.shape[1]
    g = h // kvh
    scale = 1.0 / math.sqrt(dh)
    q, k, v = ar.a(q), ar.a(k), ar.a(v)
    out = torch.empty_like(q)
    for q0 in range(0, s, q_block):
        q1 = min(s, q0 + q_block)
        qb = q[q0:q1].reshape(q1 - q0, kvh, g, dh)
        sc = torch.einsum("bkgd,tkd->kgbt", qb, k[:q1]) * scale
        keep = (torch.arange(q1, device=q.device)[None, :]
                <= torch.arange(q0, q1, device=q.device)[:, None])
        sc = sc.masked_fill(~keep, float("-inf"))
        p = ar.a(torch.softmax(sc, dim=-1))
        out[q0:q1] = torch.einsum("kgbt,tkd->bkgd", p, v[:q1]).reshape(q1 - q0, h, dh)
        del sc, p
    return out


def layer(conf: dict, lw: Dict[str, torch.Tensor], x: torch.Tensor, ar: Arith,
          q_block: int, row_block: int) -> torch.Tensor:
    """One pre-norm block on x [S, d] (float32)."""
    m = dims(conf)
    eps = conf["rms_norm_eps"]
    s = x.shape[0]
    hn = rms_norm(x, lw["ln1"], eps)
    q = ar.mm(hn, lw["wq"]).view(s, m["h"], m["hd"])
    k = ar.mm(hn, lw["wk"]).view(s, m["kv"], m["hd"])
    v = ar.mm(hn, lw["wv"]).view(s, m["kv"], m["hd"])
    del hn
    if conf.get("qk_norm"):
        q = rms_norm(q, lw["q_norm"], eps)
        k = rms_norm(k, lw["k_norm"], eps)
    q, k = rope(q, conf["rope_theta"]), rope(k, conf["rope_theta"])
    att = causal_attention(q, k, v, ar, q_block).reshape(s, -1)
    del q, k, v
    x = x + ar.mm(att, lw["wo"])
    del att
    for r0 in range(0, s, row_block):
        xb = x[r0:r0 + row_block]
        hn = rms_norm(xb, lw["ln2"], eps)
        mid = torch.nn.functional.silu(ar.mm(hn, lw["wg"])) * ar.mm(hn, lw["wu"])
        xb += ar.mm(mid, lw["wd"])
        del hn, mid
    return x


def _weights(conf: dict, seed: int, device, ar: Arith):
    """Each layer's weights in float32 (matrices rounded by ``ar``), one
    layer at a time, remade from the seed."""
    spec = layer_spec(conf)
    for i in range(conf["num_hidden_layers"]):
        yield {n: ar.w(t.float()) if t.ndim == 2 else t.float()
               for n, t in W.draw(spec, seed, layer_tag(i), device).items()}


def final_hidden(conf: dict, seed: int, prompts: Sequence[np.ndarray], device,
                 precisions: Sequence[str] = ("fp32",), *, q_block: int = 1024,
                 row_block: int = 8192) -> Dict[str, List[torch.Tensor]]:
    """{precision: [the normed last hidden states [S_r, d] (float32) of each
    prompt]}: the model run at each of ``precisions`` side by side, the
    weights remade from ``seed`` layer by layer."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ars = {p: Arith(p) for p in precisions}
    g = global_specs(conf)
    emb = W.draw(g["embed"], seed, "embed", device)["embed"]
    first = [emb[torch.as_tensor(np.asarray(p), device=device).long()].float()
             for p in prompts]
    del emb
    xs = {p: [x.clone() for x in first] for p in precisions}
    del first
    with torch.no_grad():
        layers = {p: _weights(conf, seed, device, ar) for p, ar in ars.items()}
        for _ in range(conf["num_hidden_layers"]):
            for p, ar in ars.items():
                lw = next(layers[p])
                xs[p] = [layer(conf, lw, x, ar, q_block, row_block) for x in xs[p]]
                del lw
        fn = W.draw(g["final_norm"], seed, "final_norm", device)["final_norm"].float()
        return {p: [rms_norm(x, fn, conf["rms_norm_eps"]) for x in xs[p]] for p in precisions}


def head(conf: dict, seed: int, device, precision: str = "fp32") -> torch.Tensor:
    """The head [d, V] in float32, rounded as ``precision`` holds it."""
    w = W.draw(global_specs(conf)["head"], seed, "head", device)["lm_head"]
    return Arith(precision).w(w.float())


def next_token_logits(conf: dict, seed: int, prompts: Sequence[np.ndarray], device,
                      *, precision: str = "fp32", q_block: int = 1024,
                      row_block: int = 8192) -> np.ndarray:
    """The float32 logits [R, V] that follow each prompt (token ids [S_r])."""
    hs = final_hidden(conf, seed, prompts, device, (precision,), q_block=q_block,
                      row_block=row_block)[precision]
    last = torch.stack([h[-1] for h in hs])
    del hs
    with torch.no_grad():
        return Arith(precision).mm(last, head(conf, seed, device, precision)).cpu().numpy()


def control_readings(conf: dict, seed: int, prompts: Sequence[np.ndarray], device, *,
                     precision: str = "fp8", q_block: int = 1024,
                     row_block: int = 8192) -> Dict[str, np.ndarray]:
    """The control of the check beside the float32 reference, on the same
    prompts and in one pass over the layers: ``logits`` (the float32
    next-token logits [R, V], what the program's are compared with) and
    ``control`` (the control's [R, V])."""
    hs = final_hidden(conf, seed, prompts, device, ("fp32", precision), q_block=q_block,
                      row_block=row_block)
    ar = Arith(precision)
    with torch.no_grad():
        logits = torch.stack([h[-1] for h in hs["fp32"]]) @ head(conf, seed, device)
        control = ar.mm(torch.stack([h[-1] for h in hs[precision]]),
                        head(conf, seed, device, precision))
    return {"logits": logits.cpu().numpy(), "control": control.cpu().numpy()}
