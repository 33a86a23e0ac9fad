"""Stage telemetry: per-(stage, tick) counters of the pipeline tick loop
(mirrors ``repro.obs.telemetry``).

``prefill_pipeline(..., return_telemetry=True)`` returns one ``[N, T]``
profile per key (stage-major, ``T = M + N - 1`` ticks):

- ``own_chunks`` / ``hosted_chunks``  LIVE chunk-slot occupancy of the
  stage's KV pool: +1 when a chunk is written locally (phase < p2) or lands
  from the MBKR pair (pair phase in [p2, M)), freed in bulk the tick after
  the owning request's last chunk clears (phase == M) — the lifecycle
  ``sched.kvlease`` accounts host-side. Terapipe ramps every stage to M;
  MBKR's peak is the slot plan's ``num_slots`` < M (the paper's Fig. 1).
- ``kv_bytes``        the same profile priced in STORED bytes via the
  kvstore codec (quantized payload + per-page fp32 scales).
- ``spill_events`` / ``fetch_events`` / ``qship_events``  useful wire
  transfers, gated by the SAME consumption predicates the CollectiveLedger
  charges — so ``events x per_event_wire_bytes`` reproduces the ledger's
  per-category byte totals.
- ``attn_work``       attention FLOPs performed, per the LBCP cost model
  (``costmodel.attn_flops`` at each stage's prefix).
- ``launches``        the reference's LOGICAL count: attention-backend
  block invocations per stage (one stage = one chip there). On one card a
  launch serves all N stages of a (layer, tick), so with the kernel
  backends (``cuda`` / ``paged`` pools, the ``cuda`` SSD) the stages' sum
  is N times the kernels' launch count of the same call: ``sum over
  stages of launches[:, -1] == N x (the K1-K3, or K4, launches)``.
- ``prefix_hit``      chunk stores served from the prefix cache (one event
  per (stage, hit phase); closed form in ``prefix_saved_model``).

The stage predicates (``ctx.phase``, ``ctx.first_half``, ``ctx.active``)
are host numpy arrays ([N], known before a tick runs), so telemetry is
host arithmetic: per key a float64 ``[N]`` accumulator, snapshotted every
tick into the ``[N, T]`` profile. It adds no device op and no synchronize;
disabled (``tel=None``) every charge is a no-op.

Under the manual TP lowering the reference charges each of a stage's tp
chips 1/tp of every count and the bytes of its own shard, and its
``telemetry_collect`` psums the chips back into per-stage values. Here a
stage's counts are restored from the shards by construction: a count is
charged once a stage (the sum of its shards' 1/tp), and ``kv_bytes`` is
priced at the pool's folded geometry (``chunk_stored_bytes`` over tp * B
rows at the local kv heads: the sum of the shards' bytes), so no collect
step remains.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

TELEM_KEYS = ("own_chunks", "hosted_chunks", "kv_bytes", "spill_events",
              "fetch_events", "qship_events", "attn_work", "launches",
              "prefix_hit")

StageTelemetry = Optional[Dict[str, np.ndarray]]


def telemetry_init(num_stages: int) -> Dict[str, np.ndarray]:
    """Fresh telemetry: one float64 [N] accumulator per key."""
    return {k: np.zeros(num_stages) for k in TELEM_KEYS}


def charge(tel: StageTelemetry, key: str, amount, active=None) -> StageTelemetry:
    """Add ``amount`` (a number, or an [N] array: attention work depends on
    each stage's phase) to ``tel[key]`` of every stage whose ``active``
    flag is set (``active`` [N] bool; None = every stage). No-op on a None
    telemetry."""
    if tel is None:
        return tel
    add = np.asarray(amount, np.float64)
    if active is not None:
        add = np.where(active, add, 0.0)
    tel[key] = tel[key] + add
    return tel


class TelemetryRecorder:
    """The tick loop's telemetry: the accumulators and one snapshot of them
    a tick; ``profile`` stacks the snapshots into ``[N, T]`` arrays."""

    def __init__(self, num_stages: int):
        self.tel = telemetry_init(num_stages)
        self._ticks: List[Dict[str, np.ndarray]] = []

    def snapshot(self) -> None:
        self._ticks.append(dict(self.tel))

    def profile(self) -> Dict[str, np.ndarray]:
        return {k: np.stack([t[k] for t in self._ticks], axis=1) for k in TELEM_KEYS}


def chunk_stored_bytes(plan, lps: int, b: int, c: int, kvh: int,
                       hd: int) -> float:
    """STORED bytes of one chunk in the stage's paged pool (k + v payload at
    the codec's storage width + the per-page fp32 scale rows when
    quantized) — equals ``nbytes(encode(k)) + nbytes(encode(v))`` for the
    given geometry."""
    codec = plan.codec
    payload = 2.0 * lps * b * c * kvh * hd * codec.bytes_per_el
    scales = 2.0 * plan.pages_per_chunk * codec.scale_bytes_per_page(
        lps, b, kvh)
    return payload + scales


def charge_tick_residency(tel: StageTelemetry, ctx,
                          chunk_bytes: float) -> StageTelemetry:
    """Charge this tick's pool-occupancy deltas (once per tick, from the
    pipeline loop). The lifecycle mirrors the slot plan / lease manager:

    - an own chunk lands while ``phase < p2`` (spilled chunks live at the
      pair); ALL own chunks free the tick my last chunk clears (``phase ==
      M``).
    - a hosted chunk lands while the pair's phase is in ``[p2, M)``; all
      hosted chunks free the tick the PAIR's last chunk clears.

    Frees beyond the loop's horizon never fire (the run is over); the
    analytic twin ``analytic_occupancy`` applies the identical clipping.
    The lifecycle is the plan's: the prefix path's put-back of lent own
    chunks (``return_kv``) moves no residency."""
    if tel is None:
        return tel
    plan = ctx.plan
    m, p2 = plan.num_chunks, min(plan.p2, plan.num_chunks)
    phase = ctx.phase
    own_add = (phase >= 0) & (phase < p2)
    tel = charge(tel, "own_chunks", 1.0, own_add)
    tel = charge(tel, "kv_bytes", chunk_bytes, own_add)
    tel = charge(tel, "own_chunks", -float(p2), phase == m)
    tel = charge(tel, "kv_bytes", -float(p2) * chunk_bytes, phase == m)
    if p2 < m and plan.mode == "mocap":
        n2 = plan.pair_shift
        pp = np.where(ctx.first_half, phase - n2, phase + n2)
        host_add = (pp >= p2) & (pp < m)
        tel = charge(tel, "hosted_chunks", 1.0, host_add)
        tel = charge(tel, "kv_bytes", chunk_bytes, host_add)
        tel = charge(tel, "hosted_chunks", -float(m - p2), pp == m)
        tel = charge(tel, "kv_bytes", -float(m - p2) * chunk_bytes, pp == m)
    return tel


# ===================================================== host-side analytics

def safe_ratio(num: float, den: float) -> float:
    """``num / den`` with an all-empty guard: 0.0 when the denominator is 0
    (an empty profile is perfectly balanced / has zero drift, not NaN).
    Shared by ``TelemetryProfile.skew`` and the health drift sentinels."""
    return 0.0 if den == 0.0 else float(num) / float(den)


def analytic_occupancy(m: int, n: int, p2: int, *, mode: str = "mocap",
                       ticks: Optional[int] = None):
    """Closed-form LIVE occupancy twin of the telemetry: ``(own, hosted)``
    chunk counts, each ``[N, T]`` (stage-major, like the returned
    profiles). Terapipe (``p2 >= m`` or non-mocap) hosts nothing and every
    stage ramps to M — the Fig-1 imbalance the MBKR profile flattens."""
    t_all = ticks if ticks is not None else m + n - 1
    p2 = min(p2, m)
    n2 = n // 2
    own = np.zeros((n, t_all))
    hosted = np.zeros((n, t_all))
    for s in range(n):
        for t in range(t_all):
            ph = t - s
            if ph < m:
                own[s, t] = np.clip(ph + 1, 0, p2)
            if p2 < m and mode == "mocap":
                pp = ph - n2 if s < n2 else ph + n2
                if pp < m:
                    hosted[s, t] = np.clip(pp + 1 - p2, 0, m - p2)
    return own, hosted


def occupancy_model(plan) -> Dict[str, object]:
    """Tick x stage occupancy table for a ``PipelinePlan``: per-(stage,
    tick) live slot counts plus the peak — the slot-plan guarantee
    ``peak <= num_slots``."""
    own, hosted = analytic_occupancy(plan.num_chunks, plan.num_stages,
                                     plan.p2, mode=plan.mode)
    total = own + hosted
    return {
        "ticks": int(total.shape[1]),
        "stages": int(total.shape[0]),
        "p2": int(min(plan.p2, plan.num_chunks)),
        "peak_slots": int(total.max()),
        "num_slots": int(plan.num_slots),
        "per_stage_peak": [int(v) for v in total.max(axis=1)],
        "table": [[int(v) for v in row] for row in total],
    }


def per_event_wire_bytes(plan, cfg, b: int) -> Dict[str, float]:
    """Wire bytes of ONE telemetry event per category, derived from the
    §3.4 analytic totals divided by the event counts the telemetry charges
    — so ``sum(events) x per_event == CollectiveLedger category`` holds by
    construction."""
    from repro_torch.core import transport as tx
    w = tx.analytic_wire_bytes(plan, cfg, b)
    n, m, p2 = plan.num_stages, plan.num_chunks, min(plan.p2, plan.num_chunks)
    lps = plan.layers_per_stage
    out = {"spill": 0.0, "fetch": 0.0, "qship": 0.0}
    n_spill = n * (m - p2)
    if n_spill:
        out["spill"] = w["spill"] / n_spill
    consumed = sum(max(0, min(p, m) - p2) for p in range(m))
    if plan.remote_attn == "fetch":
        n_fetch = n * lps * consumed
        if n_fetch:
            out["fetch"] = w["fetch"] / n_fetch
    else:
        n_q = n * lps * max(0, m - 1 - p2)
        if n_q:
            out["qship"] = (w["qship_q"] + w["qship_state"]) / n_q
    return out


def prefix_saved_model(plan, lps: int, b: int, c: int, kvh: int, hd: int,
                       prefix_chunks: int) -> Dict[str, float]:
    """Closed-form twin of the ``prefix_hit`` ledger / telemetry category
    for one armed ``prefill_pipeline(..., prefix_chunks=k)`` call: every
    stage redirects exactly its ``k`` hit-phase chunk stores to scratch, so

        ledger_bytes = N_stages x k x chunk_stored_bytes   (saved KV stores)
        events       = N_stages x k                        (telemetry count)

    with the SAME clamp the pipeline applies (``k <= min(p2, M-1)``)."""
    k = min(max(int(prefix_chunks), 0),
            min(plan.p2, plan.num_chunks - 1))
    cb = chunk_stored_bytes(plan, lps, b, c, kvh, hd)
    return {"ledger_bytes": plan.num_stages * k * cb,
            "events": float(plan.num_stages * k)}


@dataclass
class TelemetryProfile:
    """Host-side view over the ``[N, T]`` profiles ``prefill_pipeline``
    returns; all arrays stage-major."""
    data: Dict[str, np.ndarray]

    @classmethod
    def from_run(cls, tel) -> "TelemetryProfile":
        return cls({k: np.asarray(v) for k, v in tel.items()})

    @property
    def stages(self) -> int:
        return self.data["own_chunks"].shape[0]

    @property
    def ticks(self) -> int:
        return self.data["own_chunks"].shape[1]

    def occupancy(self) -> np.ndarray:
        """Live slot occupancy [N, T] = own + hosted chunks."""
        return self.data["own_chunks"] + self.data["hosted_chunks"]

    def per_stage_peak(self, key: Optional[str] = None) -> np.ndarray:
        arr = self.occupancy() if key is None else self.data[key]
        return arr.max(axis=1)

    def peak(self, key: Optional[str] = None) -> float:
        return float(self.per_stage_peak(key).max())

    def skew(self, key: str = "kv_bytes") -> float:
        """Normalized cross-stage peak imbalance ``(max - min) / max`` — the
        spread MBKR narrows (0 = perfectly balanced peaks). An ALL-EMPTY key
        (every per-stage peak 0, e.g. kv_bytes on an attention-free run)
        returns 0.0 instead of dividing by zero."""
        pk = self.per_stage_peak(key)
        return safe_ratio(float(pk.max() - pk.min()), float(pk.max()))

    def totals(self) -> Dict[str, float]:
        """Final cumulative value per key, summed over stages (counters like
        events/work/launches; occupancy keys report their peak instead)."""
        out: Dict[str, float] = {}
        for k, v in self.data.items():
            if k in ("own_chunks", "hosted_chunks", "kv_bytes"):
                out[k] = float(v.max(axis=1).sum())
            else:
                out[k] = float(v[:, -1].sum())
        return out
