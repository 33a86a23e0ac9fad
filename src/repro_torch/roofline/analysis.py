"""Three-term roofline of one step on one H100, the counterpart of
``repro.roofline.analysis``.

The reference reads its terms off a compiled XLA artifact (``hlo_graph``).
The port reads them off a count of the eager program on meta tensors
(``roofline.op_graph.count``): the same definitions, one device.

    compute term    = flops_dev / peak FLOP/s (bf16, dense)
    memory term     = bytes_dev / HBM rate, bytes_dev the LEAST traffic
                      (perfect producer-consumer fusion, as the reference's
                      ``stream_bytes``); ``bytes_dev_eager`` is every byte
                      the eager program materialises, kept beside it
    collective term = 0 on one card (kept for the reference's keys): the stage axis
                      is a tensor dimension, and its rolls are HBM traffic,
                      counted in the eager bytes. The CollectiveLedger's
                      bytes (what N chips would put on the wire) stay in
                      ``coll_by_kind``.

    MODEL_FLOPS       = 6*N_active*D (train) | 2*N_active*D (prefill/decode)
    useful_ratio      = MODEL_FLOPS / (flops_dev * chips)
    roofline_fraction = ideal_time(MODEL_FLOPS) / max(term)

``kernel_work`` holds the one formula per hand-written kernel (K1-K5) of
the work it does, computed from its shapes: each input byte read once,
each output byte written once, and only the work this call's data needs
(K2 / K3 count the valid (group, slot) pairs, K1 its causal pairs and
``kv_len``, K5 its rows' ``kv_len``). The dry run charges it for each
kernel call, and ``chip_smoke.py`` derives each kernel's bound from it.

Hardware constants: NVIDIA H100 SXM data sheet, at its 700 W limit.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

HW_H100 = {
    "peak_flops": 989e12,      # bf16 dense FLOP/s (tensor cores)
    "peak_flops_fp32": 67e12,  # fp32 FLOP/s outside the tensor cores
    "hbm_bw": 3.35e12,         # B/s
    "hbm_cap": 80e9,           # B
}


def model_flops(cfg, shape) -> float:
    """Useful model FLOPs (GLOBAL): 6*N*D train, 2*N*D forward; MoE counts
    active params only."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch  # decode: one token / request


@dataclass
class RooflineTerms:
    flops_dev: float              # products + kernels' work, every call counted
    bytes_dev: float              # least traffic (perfect fusion / the kernels)
    coll_dev: float               # 0 on one card
    coll_by_kind: Dict[str, float]  # the CollectiveLedger's bytes, for reference
    chips: int
    model_flops: float
    bytes_dev_eager: float = 0.0  # every byte the eager program materialises
    flop_counter_flops: float = 0.0  # FlopCounterMode's total, for reference
    peak_bytes_per_dev: float = 0.0
    hw: Dict[str, float] = field(default_factory=lambda: dict(HW_H100))

    @property
    def compute_s(self) -> float:
        return self.flops_dev / self.hw["peak_flops"]

    @property
    def memory_s(self) -> float:
        return self.bytes_dev / self.hw["hbm_bw"]

    @property
    def collective_s(self) -> float:
        """0: one card puts nothing on a wire (``coll_dev`` is 0); kept for
        the reference's record keys."""
        return 0.0

    @property
    def dominant(self) -> str:
        t = {"compute": self.compute_s, "memory": self.memory_s,
             "collective": self.collective_s}
        return max(t, key=t.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        tot = self.flops_dev * self.chips
        return self.model_flops / tot if tot else 0.0

    @property
    def roofline_fraction(self) -> float:
        if self.bound_s <= 0:
            return 0.0
        ideal = self.model_flops / (self.chips * self.hw["peak_flops"])
        return ideal / self.bound_s

    def to_dict(self) -> Dict[str, Any]:
        return {
            "flops_dev": self.flops_dev, "bytes_dev": self.bytes_dev,
            "coll_dev": self.coll_dev, "coll_by_kind": self.coll_by_kind,
            "chips": self.chips, "model_flops": self.model_flops,
            "bytes_dev_eager": self.bytes_dev_eager,
            "flop_counter_flops": self.flop_counter_flops,
            "peak_bytes_per_dev": self.peak_bytes_per_dev,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
            "hw": dict(self.hw),
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "RooflineTerms":
        return RooflineTerms(
            flops_dev=d["flops_dev"], bytes_dev=d["bytes_dev"],
            coll_dev=d["coll_dev"], coll_by_kind=d.get("coll_by_kind", {}),
            chips=d["chips"], model_flops=d["model_flops"],
            bytes_dev_eager=d.get("bytes_dev_eager", 0.0),
            flop_counter_flops=d.get("flop_counter_flops", 0.0),
            peak_bytes_per_dev=d.get("peak_bytes_per_dev", 0.0),
            hw=dict(d.get("hw", HW_H100)))

    def summary(self) -> str:
        return (f"compute {self.compute_s*1e3:8.2f} ms | memory "
                f"{self.memory_s*1e3:8.2f} ms | collective "
                f"{self.collective_s*1e3:8.2f} ms | {self.dominant:<10} | "
                f"useful {self.useful_ratio*100:5.1f}% | roofline "
                f"{self.roofline_fraction*100:5.1f}%")


def collective_bytes(ledger) -> Dict[str, float]:
    """The CollectiveLedger's bytes by kind (``prefill_pipeline(
    return_ledger=True)``): what the stages would put on the wire across
    chips; the counterpart of the reference's HLO collective bytes."""
    return {k: float(v) for k, v in (ledger or {}).items()}


def analyze_counted(cost, cfg, shape, *, coll_by_kind: Optional[Dict[str, float]] = None,
                    flop_counter_flops: float = 0.0) -> RooflineTerms:
    """The terms of one counted step (``op_graph.count``'s ``GraphCost``),
    the counterpart of the reference's ``analyze_lowered``."""
    return RooflineTerms(
        flops_dev=cost.flops, bytes_dev=cost.stream_bytes, coll_dev=0.0,
        coll_by_kind=dict(coll_by_kind or {}), chips=1,
        model_flops=model_flops(cfg, shape), bytes_dev_eager=cost.bytes_,
        flop_counter_flops=float(flop_counter_flops),
        peak_bytes_per_dev=float(cost.peak_live_bytes))


# ------------------------------------------------------------- the kernels

def _nb(t) -> float:
    """Bytes of a tensor's elements (0 for None)."""
    return 0.0 if t is None else float(t.numel() * t.element_size())


def _rate_dtype(q) -> str:
    """The products' type: bf16 q runs the tensor cores, fp32 q not."""
    return "float32" if q.dtype == torch.float32 else "bfloat16"


def _valid_pairs(valid, rows: int, slots: int) -> Tuple[int, int]:
    """(valid (group, slot) pairs, groups) of a K2 / K3 ``valid`` given as
    host values ([S] or [G, S])."""
    v = np.asarray(valid)
    v = v.reshape(-1, slots) if v.ndim != 2 else v
    if v.shape[1] != slots or rows % v.shape[0]:
        raise ValueError(f"valid {v.shape} does not fit {rows} rows x {slots} slots")
    return int(np.count_nonzero(v)), v.shape[0]


def _state_bytes(gb: int, c: int, h: int, d: int) -> float:
    """(m, l) [G*B, H, C] and acc [G*B, C, H, D], fp32."""
    return 4.0 * (2 * gb * h * c + gb * c * h * d)


def _chunk_attention(q, k, v, k_scale=None, v_scale=None, *, causal_offset: int = 0,
                     kv_len: Optional[int] = None, return_state: bool = False):
    b, c, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    kv_len = t if kv_len is None else int(kv_len)
    # key j is visible to query i iff j <= i + causal_offset and j < kv_len
    seen = np.clip(np.arange(c) + int(causal_offset) + 1, 0, kv_len)
    keys = int(seen[-1]) if c else 0
    flops = 4.0 * d * b * h * float(seen.sum())
    kv_el = b * keys * kvh
    nbytes = 2 * _nb(q) + 2.0 * kv_el * d * k.element_size()
    if k_scale is not None:
        nbytes += 2.0 * kv_el * 4
    if return_state:
        nbytes += _state_bytes(b, c, h, d)
    return flops, nbytes, _rate_dtype(q)


def _pool_attention(q, k, v, valid, k_scale=None, v_scale=None, *,
                    kv_len: Optional[int] = None):
    gb, c, h, d = q.shape
    s, _, t, kvh, _ = k.shape
    kv_len = t if kv_len is None else int(kv_len)
    n_valid, groups = _valid_pairs(valid, gb, s)
    rows = gb // groups
    kv_el = n_valid * rows * kv_len * kvh
    nbytes = (_nb(q) + groups * s + _state_bytes(gb, c, h, d)
              + 2.0 * kv_el * d * k.element_size())
    if k_scale is not None:
        nbytes += 2.0 * kv_el * 4
    return 4.0 * d * n_valid * rows * h * c * kv_len, nbytes, _rate_dtype(q)


def _pool_attention_paged(q, k_pages, v_pages, handles: int, valid, k_scale=None,
                          v_scale=None, *, ppc: int, kv_len: Optional[int] = None):
    """``handles``: the number of page handles (S * ppc), read as int32."""
    gb, c, h, d = q.shape
    kp = k_pages if k_pages.ndim == 6 else k_pages[None]
    _, _, b, pt, kvh, _ = kp.shape
    s = int(handles) // ppc
    kv_len = ppc * pt if kv_len is None else int(kv_len)
    n_valid, groups = _valid_pairs(valid, gb, s)
    nbytes = (_nb(q) + groups * s + 4.0 * handles + _state_bytes(gb, c, h, d)
              + 2.0 * n_valid * b * kv_len * kvh * d * kp.element_size())
    if k_scale is not None:             # one fp32 scale a (page, kv head)
        nbytes += 2.0 * n_valid * b * -(-kv_len // pt) * kvh * 4
    return 4.0 * d * n_valid * b * h * c * kv_len, nbytes, _rate_dtype(q)


def _ssd(x, dt, a_log, b, c, d_skip, init_state=None, *, chunk: int):
    """``chunk``: the chunk the scan runs at (``ops.ssd_chunk``)."""
    r, t, h, p = x.shape
    n = b.shape[3]
    tri = chunk * (chunk + 1) / 2
    per_chunk = 2.0 * tri * (n + p) + 4.0 * chunk * p * n
    nbytes = (sum(_nb(w) for w in (x, dt, a_log, b, c, d_skip, init_state))
              + _nb(x) + 4.0 * r * h * p * n)           # y, the fp32 final state
    return per_chunk * r * h * (t // chunk), nbytes, _rate_dtype(x)


def _decode_attention(q, k, v, kv_len):
    """``kv_len``: the rows' lengths as host values."""
    b, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    keys = float(np.clip(np.asarray(kv_len).reshape(-1), 0, s).sum())
    nbytes = 2 * _nb(q) + 4.0 * b + 2.0 * keys * kvh * d * k.element_size()
    return 4.0 * d * h * keys, nbytes, _rate_dtype(q)


_WORK = {"chunk_attention": _chunk_attention, "pool_attention": _pool_attention,
         "pool_attention_paged": _pool_attention_paged, "ssd": _ssd,
         "decode_attention": _decode_attention}


def kernel_work(tag: str, *args, **kw) -> Tuple[float, float, str]:
    """(flops, bytes, dtype of the products) of one call of kernel ``tag``
    (K1 ``chunk_attention``, K2 ``pool_attention``, K3
    ``pool_attention_paged``, K4 ``ssd``, K5 ``decode_attention``) on
    tensors of these shapes and dtypes (real or meta) and these host
    values, with the arguments of its wrapper in ``kernels.ops``."""
    return _WORK[tag](*args, **kw)


def kernel_bound(flops: float, nbytes: float, dtype: str) -> Tuple[float, str]:
    """(seconds, "bytes" | "operations"): the least time the card could take
    for ``kernel_work``'s work, the larger of bytes over the memory rate and
    operations over the peak rate of the products' type."""
    t_bytes = nbytes / HW_H100["hbm_bw"]
    t_ops = flops / HW_H100["peak_flops_fp32" if dtype == "float32" else "peak_flops"]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
