"""Analytic chunk/pipeline cost model shared by LBCP (Alg. 1), the event
simulator and the chunk-level scheduler — the port's own copy of
``repro.core.costmodel`` (numpy only; dense, moe, ssm and hybrid families).

Hardware profiles: the paper's WSC (GR24-class dies, §5.1), an equivalent
HGX-class GPU system (NVLink-limited; Fig. 1(c)), and the TPU v5e target.
They are the model's data, copied unchanged so that plans equal the
reference's; none of them describes the H100 the port runs on, and no time
this model gives is a time measured on a card.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, replace as dc_replace
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class HardwareProfile:
    name: str
    flops: float            # peak FLOP/s per die/chip (bf16)
    hbm_bw: float           # bytes/s per die/chip
    hbm_cap: float          # bytes per die/chip
    link_bw: float          # bytes/s per inter-die link (D2D / NVLink / ICI)
    mesh: Tuple[int, int]   # (rows, cols) of dies/chips
    gemm_eff: float = 0.65  # achievable fraction of peak on large GEMMs
    attn_eff: float = 0.45  # achievable fraction on attention
    link_eff: float = 0.85

    @property
    def num_dies(self) -> int:
        return self.mesh[0] * self.mesh[1]


# §5.1: die == Blackwell-class: 4.5 PFLOPS, 180 GB @ 7.7 TB/s; D2D 5 TB/s (SoW-X)
WSC_PAPER = HardwareProfile("wsc-gr24", 4.5e15, 7.7e12, 180e9, 5e12, (4, 4))
# Same dies, NVLink-class 900 GB/s interconnect (Fig. 1(c) comparison)
GPU_HGX = HardwareProfile("hgx-b200", 4.5e15, 7.7e12, 180e9, 0.9e12, (4, 4))
# TPU v5e pod: 197 TFLOP/s bf16, 16 GB @ 819 GB/s, ICI ~50 GB/s/link
TPU_V5E = HardwareProfile("tpu-v5e", 197e12, 819e9, 16e9, 50e9, (16, 16))

PROFILES = {p.name: p for p in (WSC_PAPER, GPU_HGX, TPU_V5E)}

ProfileSpec = Union[HardwareProfile, str]


def profile_to_dict(hw: HardwareProfile) -> Dict:
    """JSON-serializable profile dict. Floats survive a json round-trip
    BIT-IDENTICALLY (json uses repr = shortest round-trip), so a calibrated
    profile written to disk reproduces the exact dp_partition output of the
    in-memory one."""
    d = asdict(hw)
    d["mesh"] = list(hw.mesh)
    return d


def profile_from_dict(d: Dict) -> HardwareProfile:
    d = dict(d)
    d["mesh"] = tuple(int(v) for v in d["mesh"])
    return HardwareProfile(**d)


def resolve_profile(spec: ProfileSpec) -> HardwareProfile:
    """Accept a profile everywhere one is taken: a ``HardwareProfile``
    instance, a registered name (``PROFILES``), or a path to a profile JSON
    (``profile_to_dict``'s fields, alone or under a ``"profile"`` key) — so
    LBCP, ``chunk_cost_arrays`` and the scheduler's admission costs all run
    off another profile with no call-site changes."""
    if isinstance(spec, HardwareProfile):
        return spec
    if spec in PROFILES:
        return PROFILES[spec]
    with open(spec) as f:
        blob = json.load(f)
    return profile_from_dict(blob.get("profile", blob))


# ----------------------------------------------------------- model analytics

def layer_linear_flops_per_token(cfg: ModelConfig) -> float:
    """FLOPs/token of the non-attention (GEMM) path of ONE layer (fwd)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    qkvo = 2 * d * (cfg.num_heads * hd + 2 * cfg.num_kv_heads * hd + cfg.num_heads * hd)
    if cfg.family == "ssm":
        from repro_torch.models.ssm import dims as ssm_dims
        d_in, nheads, conv_ch = ssm_dims(cfg)
        s = cfg.ssm
        return 2 * d * (2 * d_in + 2 * s.n_groups * s.d_state + nheads) + 2 * d_in * d
    if cfg.moe is not None:
        m = cfg.moe
        fe = m.d_expert or cfg.d_ff
        ffn = 2 * 3 * d * fe * (m.top_k + m.num_shared_experts)
        return qkvo + ffn + 2 * d * m.num_experts
    return qkvo + 2 * 3 * d * cfg.d_ff


def attn_flops(cfg: ModelConfig, c: int, p: int) -> float:
    """Attention score+value FLOPs for a chunk of c tokens with prefix p, ONE
    layer (causal within the chunk)."""
    if cfg.attn_free:
        # SSD intra+inter-chunk cost is linear in c
        s = cfg.ssm
        d_in = s.expand * cfg.d_model
        return 2 * c * d_in * s.d_state * 3
    hd = cfg.resolved_head_dim
    eff_len = p + (c + 1) / 2.0
    return 4 * c * eff_len * cfg.num_heads * hd


def kv_bytes_per_token_layer(cfg: ModelConfig, bytes_per_el: int = 2) -> float:
    """KV bytes/token for ONE attention layer (0 for SSM)."""
    if cfg.attn_free:
        return 0.0
    return 2 * cfg.num_kv_heads * cfg.resolved_head_dim * bytes_per_el


def attn_layers(cfg: ModelConfig) -> int:
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.hybrid.num_groups
    return cfg.num_layers


# ------------------------------------------------------------- chunk timing

@dataclass(frozen=True)
class StageModel:
    """One pipeline stage: a slice of the model on ``tp`` dies/chips."""
    cfg: ModelConfig
    layers: int            # layers hosted by this stage
    attn_layers: int       # of which attention layers (hybrid: shared-block apps)
    tp: int = 1            # dies/chips ganged within the stage

    @staticmethod
    def build(cfg: ModelConfig, num_stages: int, tp: int = 1) -> "StageModel":
        nl = cfg.hybrid.num_groups if cfg.family == "hybrid" else cfg.num_layers
        ls = -(-nl // num_stages)
        al = ls if not cfg.attn_free else 0
        if cfg.family == "hybrid":
            al = ls  # one shared-attn application per group
        return StageModel(cfg, ls, al, tp)


def chunk_compute_time(sm: StageModel, c: int, p: int, hw: HardwareProfile) -> float:
    """Seconds for one chunk (c tokens, prefix p) through one stage."""
    cfg = sm.cfg
    peak = sm.tp * hw.flops
    bw = sm.tp * hw.hbm_bw
    gemm = sm.layers * c * layer_linear_flops_per_token(cfg) / (peak * hw.gemm_eff)
    afl = sm.attn_layers * attn_flops(cfg, c, p)
    abytes = sm.attn_layers * (p + c) * kv_bytes_per_token_layer(cfg)
    attn = max(afl / (peak * hw.attn_eff), abytes / bw)
    return gemm + attn


def boundary_comm_time(cfg: ModelConfig, c: int, hw: HardwareProfile) -> float:
    """Stage-boundary activation transfer (1 hop)."""
    return c * cfg.d_model * 2 / (hw.link_bw * hw.link_eff)


def kv_chunk_bytes(sm: StageModel, c: int) -> float:
    return sm.attn_layers * c * kv_bytes_per_token_layer(sm.cfg)


def spill_time(sm: StageModel, c: int, hw: HardwareProfile, hops: int = 1,
               compress: float = 1.0) -> float:
    """Transfer one chunk's stage-KV to the paired stage. ``compress`` < 1
    models int8 KV-spill compression (beyond-paper)."""
    return kv_chunk_bytes(sm, c) * compress * hops / (hw.link_bw * hw.link_eff)


def chunk_cost_arrays(
    sm: StageModel,
    chunks: Sequence[int],
    hw: ProfileSpec,
    *,
    mbkr_plan: Optional["object"] = None,  # core.mbkr.MBKRPlan
    compress: float = 1.0,
    prefix_hit_chunks: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per-chunk cost vectors shared by the analytic evaluator, the event
    simulator, and the chunk-level scheduler.

    Returns ``(dur, comm, kvb, spill_t, fetch_t)``, each ``[M]``:
      dur     compute seconds of chunk i on one stage (prefix-aware)
      comm    stage-boundary activation transfer seconds
      kvb     stage-KV bytes written by chunk i
      spill_t MBKR debtor spill seconds (chunks with index >= p2)
      fetch_t MBKR remote-KV re-read seconds (prefix chunks hosted at the pair)

    ``prefix_hit_chunks=k`` prices a request whose first ``k`` chunks are
    served by a prefix index (the reference's ``kvstore.prefix``; none is
    ported yet): their self-block
    compute, boundary hop, spill and fetch wire all vanish — the EFFECTIVE
    sequence is the novel suffix — while later chunks still attend over the
    full (cached) prefix and ``kvb`` still reports the stored bytes the
    pages occupy (lease accounting subtracts sharing separately via
    ``kvlease.chunk_page_bytes(shared_pages=...)``).
    """
    hw = resolve_profile(hw)
    m = len(chunks)
    dur = np.zeros(m)
    comm = np.zeros(m)
    kvb = np.zeros(m)
    spill_t = np.zeros(m)
    fetch_t = np.zeros(m)
    p2 = m if mbkr_plan is None else mbkr_plan.p2
    k = min(max(int(prefix_hit_chunks), 0), m - 1 if m else 0)
    link = hw.link_bw * hw.link_eff
    prefix = 0
    for i, c in enumerate(chunks):
        if i >= k:
            dur[i] = chunk_compute_time(sm, c, prefix, hw)
            comm[i] = boundary_comm_time(sm.cfg, c, hw)
        kvb[i] = kv_chunk_bytes(sm, c)
        prefix += c
    for i, c in enumerate(chunks):
        if i < k:
            continue
        if i >= p2:
            spill_t[i] = spill_time(sm, c, hw, compress=compress)
        if i > p2:
            fetch_t[i] = kvb[p2:i].sum() * compress / link
    return dur, comm, kvb, spill_t, fetch_t


# ------------------------------------------------------- effective rates
#
# Every term above is LINEAR in four effective hardware rates (the attention
# max() picks a regime, but WITHIN a regime the time is linear):
#
#   t_chunk = G / (peak*gemm_eff) + A / (peak*attn_eff)   [compute-bound]
#                                 | B / bw                [bandwidth-bound]
#           + W / (link_bw*link_eff)
#
# so the time is a per-chunk vector of pure WORK quantities (flops, bytes)
# times the rate vector theta = profile_theta(hw); ``profile_from_theta``
# folds a fitted theta back into a profile (the reference's calibration
# fit, which is not ported yet, produces one).


def profile_theta(hw: HardwareProfile, tp: int = 1) -> np.ndarray:
    """The 4 effective inverse rates the cost model is linear in: seconds
    per GEMM flop, attention flop, attention byte and link byte at stage
    width ``tp``."""
    peak = tp * hw.flops
    bw = tp * hw.hbm_bw
    return np.array([1.0 / (peak * hw.gemm_eff), 1.0 / (peak * hw.attn_eff),
                     1.0 / bw, 1.0 / (hw.link_bw * hw.link_eff)])


def profile_from_theta(hw: HardwareProfile, theta: np.ndarray,
                       tp: int = 1, name: Optional[str] = None
                       ) -> HardwareProfile:
    """Fold fitted inverse rates back into a ``HardwareProfile``: peak
    flops/mesh stay nominal, the EFFECTIVE terms (gemm_eff / attn_eff /
    hbm_bw / link_bw) absorb the fit — so the profile drops into every
    existing cost-model call site unchanged."""
    peak = tp * hw.flops
    return dc_replace(
        hw,
        name=name if name is not None else hw.name + "+cal",
        gemm_eff=1.0 / (float(theta[0]) * peak),
        attn_eff=1.0 / (float(theta[1]) * peak),
        hbm_bw=1.0 / (float(theta[2]) * tp),
        link_bw=1.0 / (float(theta[3]) * hw.link_eff),
    )


# ------------------------------------------------- analytic pipeline schedule

@dataclass
class ScheduleResult:
    latency: float                 # single-request prefill makespan (s)
    stage_finish: List[float]
    chunk_times: List[List[float]]  # [stage][chunk]
    realloc_overhead: float        # total MBKR serve+fetch seconds on critical path


def evaluate_prefill(
    chunks: Sequence[int],
    sm: StageModel,
    num_stages: int,
    hw: HardwareProfile,
    *,
    mbkr_plan: Optional["object"] = None,  # core.mbkr.MBKRPlan
    compress: float = 1.0,
) -> ScheduleResult:
    """Analytic pipeline schedule for ONE request partitioned into ``chunks``.

    Chunk i: compute at stage s can start when (a) stage s finished chunk i-1
    plus any MBKR serve time, (b) stage s-1 finished chunk i plus the boundary
    transfer. MBKR adds: spill time for chunks with index >= p2 (overlapped up
    to the link, modeled as serialized on the boundary link of the debtor),
    fetch time for remote chunks re-read each subsequent chunk, and serve time
    on the creditor (paper Fig. 4(b) blue blocks).
    """
    m = len(chunks)
    cfg = sm.cfg
    p2 = m if mbkr_plan is None else mbkr_plan.p2
    n2 = num_stages // 2

    # per (stage, chunk) compute times + mbkr extras (same across stages for a
    # uniform stage slice; serve time appears at the paired stage's schedule)
    dur, _, _, spill_t, fetch_t = chunk_cost_arrays(
        chunks=chunks, sm=sm, hw=hw, mbkr_plan=mbkr_plan, compress=compress)
    t = [[float(dur[i]) for i in range(m)] for _ in range(num_stages)]
    realloc = 0.0

    finish = [[0.0] * m for _ in range(num_stages)]
    for s in range(num_stages):
        for i in range(m):
            ready_prev_chunk = finish[s][i - 1] if i else 0.0
            ready_prev_stage = (finish[s - 1][i] + boundary_comm_time(cfg, chunks[i], hw)
                                if s else 0.0)
            # creditor serve time: when my pair spills/fetches, my HBM+link is
            # busy serving; approximate as added occupancy on this stage for
            # the same chunk index shifted by N/2
            serve = 0.0
            if p2 < m:
                pair_chunk = i - n2
                if 0 <= pair_chunk < m:
                    serve = spill_t[pair_chunk] * 0.5 + fetch_t[pair_chunk] * 0.5
            start = max(ready_prev_chunk, ready_prev_stage)
            dur = t[s][i] + spill_t[i] + fetch_t[i] + serve
            realloc += (spill_t[i] + fetch_t[i] + serve) / num_stages
            finish[s][i] = start + dur
    return ScheduleResult(
        latency=finish[num_stages - 1][m - 1],
        stage_finish=[finish[s][m - 1] for s in range(num_stages)],
        chunk_times=t,
        realloc_overhead=realloc,
    )


def evaluate_e2e(batch: int, t_prefill: float, chunks: Sequence[int],
                 sm: StageModel, num_stages: int, hw: HardwareProfile,
                 *, mbkr_plan=None, compress: float = 1.0) -> Tuple[float, float]:
    """(avg E2E latency, throughput req/s) for ``batch`` back-to-back requests.

    Steady-state: each additional request adds sum_i(t_i + extras) (the
    bottleneck stage is fully busy); E2E of request r = fill + (r+1) * T_req.
    """
    m = len(chunks)
    prefix = [0] * m
    for i in range(1, m):
        prefix[i] = prefix[i - 1] + chunks[i - 1]
    p2 = m if mbkr_plan is None else mbkr_plan.p2
    t_req = 0.0
    for i, c in enumerate(chunks):
        extra = 0.0
        if i >= p2:
            extra += spill_time(sm, c, hw, compress=compress)
        if p2 < i:
            remote_bytes = sum(kv_chunk_bytes(sm, chunks[j]) for j in range(p2, i))
            extra += remote_bytes * compress / (hw.link_bw * hw.link_eff)
        t_req += chunk_compute_time(sm, c, prefix[i], hw) + extra
    fill = t_prefill - t_req if t_prefill > t_req else 0.0
    lat = fill + (batch + 1) / 2.0 * t_req
    thr = batch / (fill + batch * t_req)
    return lat, thr
