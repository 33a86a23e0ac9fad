"""Stage-axis transport and the CollectiveLedger (mirrors
``repro.core.transport``).

The reference runs the N stages on N chips and moves bytes with
``ppermute`` / ``psum``. The port keeps the stage axis as dim 0 of every
tensor on one GPU, so:

- ``ring_shift``  (perm i -> i+1) is ``torch.roll(x, 1, dims=0)``: stage j
  receives stage j-1's tensor;
- ``pair_shift``  (perm i -> i+N/2) is ``torch.roll(x, N//2, dims=0)``;
- ``stage_psum``  is a sum over dim 0, broadcast back;
- ``tp_psum``     (the manual TP lowering's psum over a stage's tp chips)
  is a sum over the tp axis, dim 1 of a [N, tp, ...] partial.

The ledger keeps the reference's per-chip byte model: each call charges the
bytes ONE stage's slice puts on the wire, once for every stage whose
``active`` flag is set (the reference charges each chip under its own
predicate and then sums over chips). The predicates depend only on the tick
and the stage index, so they are host-side numpy arrays and the ledger is a
dict of Python floats.

Under the manual TP lowering a stage is tp chips, each charging its own
bytes (the reference's ``ledger_collect`` sums over the stage and tp
axes). A stage's slice of a sharded tensor holds all tp shards (the pool,
the queries and the attention state fold them into the batch rows; a
partial carries them on dim 1), so its bytes are already the sum over the
shards. The residual stream and the final hidden state are replicated over
the shards and stored once: ``ring_shift`` and ``stage_psum`` charge them
``replicas`` (= tp) times.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kvstore.quant import as_bytes, torch_dtype

LEDGER_KEYS = ("ring", "collect", "spill", "fetch", "qship_q", "qship_state",
               "tp", "prefix_hit")

Ledger = Optional[Dict[str, float]]


def ledger_init() -> Dict[str, float]:
    return {k: 0.0 for k in LEDGER_KEYS}


def nbytes(x: torch.Tensor) -> float:
    """Wire bytes of one stage's slice of a stage-stacked tensor (dim 0 is
    the stage axis)."""
    return float(x[0].numel() * x.element_size())


def _roll(x: torch.Tensor, shift: int) -> torch.Tensor:
    return torch.roll(as_bytes(x), shift, dims=0).view(x.dtype)


def charge(led: Ledger, key: str, amount: float, active=None) -> Ledger:
    """Add ``amount`` bytes to ``led[key]`` once per stage whose ``active``
    flag is set (``active`` [N] bool, numpy). No-op on a None ledger."""
    if led is None or amount == 0.0:
        return led
    n = 1 if active is None else int(np.count_nonzero(active))
    out = dict(led)
    out[key] = led[key] + amount * n
    return out


def ledger_to_dict(led) -> Dict[str, float]:
    return {k: float(v) for k, v in led.items()}


class StageAxisTransport:
    """Stage-axis movement on one device; tensors carry the stage axis at
    dim 0. Every call takes and returns the ledger."""

    name = "stage_axis"

    def __init__(self, replicas: int = 1):
        self.replicas = replicas

    @staticmethod
    def _all(x: torch.Tensor) -> np.ndarray:
        return np.ones(x.shape[0], bool)

    def ring_shift(self, x: torch.Tensor, led: Ledger = None, *,
                   active=None) -> Tuple[torch.Tensor, Ledger]:
        """Activation advance to the next stage (ring +1)."""
        act = self._all(x) if active is None else active
        return _roll(x, 1), charge(led, "ring", self.replicas * nbytes(x), act)

    def pair_shift(self, x: torch.Tensor, led: Ledger = None, *, tag: str,
                   active=None) -> Tuple[torch.Tensor, Ledger]:
        """Cross-half MBKR pairing permute; ``tag`` picks the ledger
        category (spill | fetch | qship_q | qship_state)."""
        act = self._all(x) if active is None else active
        return (_roll(x, x.shape[0] // 2),
                charge(led, tag, nbytes(x), act))

    def stage_psum(self, x: torch.Tensor, led: Ledger = None, *,
                   active=None) -> Tuple[torch.Tensor, Ledger]:
        """All-reduce over the stage axis (ring model: 2(k-1)/k bytes per
        chip)."""
        k = x.shape[0]
        act = self._all(x) if active is None else active
        out = x.sum(dim=0, keepdim=True).expand_as(x)
        return out, charge(led, "collect",
                           self.replicas * 2.0 * (k - 1) / k * nbytes(x), act)

    def tp_psum(self, x: torch.Tensor, led: Ledger = None, *,
                active=None) -> Tuple[torch.Tensor, Ledger]:
        """All-reduce over the tp axis: the partial x [N, tp, ...] summed
        over dim 1 -> [N, ...] in x's dtype. Ring model, as the reference:
        2(k-1)/k of the local partial's bytes per chip, k = tp chips a
        stage, once per stage whose ``active`` flag is set."""
        k = x.shape[1]
        act = self._all(x) if active is None else active
        return x.sum(dim=1), charge(led, "tp", 2.0 * (k - 1) / k * nbytes(x), act)


def analytic_wire_bytes(plan, cfg, b: int) -> Dict[str, float]:
    """Closed-form §3.4 traffic totals for one ``prefill_pipeline`` call of a
    TRANSFORMER-family plan — the model the runtime ledger is validated
    against (held to it in the tests).

    Logical bytes, whole run, all stages, useful-gated exactly like the
    ledger: a transfer counts when its payload is consumed (fetch chunk j at
    phase p counts iff j < p; qship counts iff p > p2; spill counts iff the
    shipped chunk index is in [p2, M)). These are tp = 1 totals; the
    ``tp`` category (the manual TP lowering's psums) is not modeled, as in
    the reference. Every chunk is shipped whole: the runtime only ships
    uniform chunks."""
    n, m, c = plan.num_stages, plan.num_chunks, plan.chunk_len
    lps = plan.layers_per_stage
    kvh, hd, h = cfg.num_kv_heads, cfg.resolved_head_dim, cfg.num_heads
    dt = float(torch_dtype(cfg.dtype).itemsize)
    codec = plan.codec
    sto = float(codec.bytes_per_el)
    ppc = plan.pages_per_chunk
    out = {k: 0.0 for k in LEDGER_KEYS}

    # ring: stage s < N-1 forwards its chunk output once per active phase
    out["ring"] = (n - 1) * m * (b * c * cfg.d_model) * dt
    # collect: one [B, d] fp32 all-reduce over the stage axis
    out["collect"] = 2.0 * (n - 1) * (b * cfg.d_model) * 4.0

    if plan.mode != "mocap" or plan.p2 >= m or cfg.attn_free:
        return out

    # --- spill: every stage ships each chunk in [p2, M) once (all lps
    # layers in one end-of-tick permute). Quantized codec: the wire carries
    # the encoded pages + fp32 scales; passthrough + int8 spill_dtype: int8
    # payload + one fp32 scale per (tensor, layer, kv head).
    payload = 2 * lps * b * c * kvh * hd  # k and v elements of one chunk
    if codec.quantized:
        spill = payload * sto + 2 * ppc * lps * b * kvh * 4.0
    elif plan.spill_dtype == "int8":
        spill = payload * 1.0 + 2 * lps * b * kvh * 4.0
    else:
        spill = payload * dt
    out["spill"] = n * (m - plan.p2) * spill

    if plan.remote_attn == "fetch":
        # one chunk-layer permute per (stage, layer, phase, remote chunk
        # consumed): chunk j >= p2 is consumed at every phase p in (j, M)
        payload = 2 * b * c * kvh * hd
        fetch = payload * sto
        if codec.quantized:
            fetch += 2 * ppc * b * kvh * 4.0
        events = (m - 1 - plan.p2) * (m - plan.p2) // 2
        out["fetch"] = n * lps * events * fetch
    else:
        # qship: one q ship + one (m, l, acc) return per (stage, layer,
        # phase with p > p2)
        phases = max(0, m - 1 - plan.p2)
        ship = float(torch_dtype(plan.ship_dtype).itemsize)
        out["qship_q"] = n * lps * phases * (b * c * h * hd) * ship
        out["qship_state"] = n * lps * phases * (
            2 * (b * kvh * (h // kvh) * c) * 4.0        # (m, l) fp32 packed
            + (b * kvh * (h // kvh) * c * hd) * ship)   # acc in wire dtype
    return out
