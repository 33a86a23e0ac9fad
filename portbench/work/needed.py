"""The work a prompt needs, from the configuration's shapes alone: not the
work the program does. Launch splits, pipeline bubble rows, padding layers
and padding groups change nothing here, so a change that removes waste
raises the shares that divide by these numbers, and one that adds waste
lowers them.

Frozen copy: the peaks and the per-kernel formulas come from
``src/repro_torch/roofline/analysis.py`` (``HW_H100``, ``_chunk_attention``,
``_ssd``, ``kernel_bound``) at commit f0f447b. ``model_flops`` there (2 N D)
is replaced: it leaves out causal attention and charges the head at every
position, while a prefill-only request returns one position's logits.

Per request of S prompt tokens, dense family:
- 2 x the weights of every matrix product a token passes through x S (the
  norms' element-wise products are left out: under 1e-4 of the total);
- 2 x d_model x vocab for the one returned position;
- causal attention, 4 x head_dim x q_heads x S (S + 1) / 2 a layer.
"""
from __future__ import annotations

from typing import Tuple

# NVIDIA H100 SXM data sheet, dense rates at its 700 W limit
HW_H100 = {
    "peak_flops": 989e12,      # bf16 dense FLOP/s (tensor cores)
    "hbm_bw": 3.35e12,         # B/s
}


def _dims(conf: dict):
    d, h = conf["hidden_size"], conf["num_attention_heads"]
    return (d, h, conf["num_key_value_heads"], conf.get("head_dim") or d // h,
            conf["intermediate_size"], conf["vocab_size"], conf["num_hidden_layers"])


def layer_matmul_weights(conf: dict) -> int:
    """Weights of one dense layer's matrix products: q, k, v, o and the
    SwiGLU's gate, up and down."""
    d, h, kv, hd, f, _, _ = _dims(conf)
    return d * h * hd + 2 * d * kv * hd + h * hd * d + 3 * d * f


def causal_attention_work(conf: dict, s: int, elem_bytes: int = 2) -> Tuple[float, float]:
    """(FLOPs, bytes) of one layer's causal self-attention over S tokens,
    ``_chunk_attention``'s formula at C = S, causal offset 0: query i sees
    keys 0..i; q, k and v read once and the output written once."""
    _, h, kv, hd, _, _, _ = _dims(conf)
    flops = 4.0 * hd * h * s * (s + 1) / 2
    nbytes = elem_bytes * (2.0 * s * h * hd + 2.0 * s * kv * hd)
    return flops, nbytes


def request_flops(conf: dict, s: int) -> float:
    """FLOPs one prefill-only request of S tokens needs (module docstring)."""
    d, _, _, _, _, v, layers = _dims(conf)
    attn, _ = causal_attention_work(conf, s)
    return layers * (2.0 * layer_matmul_weights(conf) * s + attn) + 2.0 * d * v


def least_seconds(flops: float, nbytes: float) -> float:
    """``kernel_bound`` for bf16 products: the larger of bytes over the
    memory rate and operations over the peak rate."""
    return max(nbytes / HW_H100["hbm_bw"], flops / HW_H100["peak_flops"])


def attention_least_seconds(conf: dict, s: int) -> float:
    """The least time of the causal attention one request of S tokens needs,
    over all its layers, on the published peaks."""
    flops, nbytes = causal_attention_work(conf, s)
    return conf["num_hidden_layers"] * least_seconds(flops, nbytes)
