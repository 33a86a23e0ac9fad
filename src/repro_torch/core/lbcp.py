"""Latency-Balanced Chunk Partitioning (LBCP), §4.2 / Alg. 1.

Stage 1: dynamic programming over quantized chunk boundaries minimizing the
pipeline-makespan proxy  t_sum + (N-1) * t_max  using the deterministic
compute cost only (EVALUATECHUNK).

Stage 2: simulated annealing refinement under the FULL MBKR-enabled execution
model (EVALUATEPREFILL -> feasible batch + prefill latency; EVALUATEE2E), one
boundary perturbed per iteration, temperature-controlled acceptance.

The port's own copy of ``repro.core.lbcp``: the same seed gives the same
chunk list. The port's ``TorchExecutor`` runs uniform chunks only, so LBCP
plans price admission and the analytic executor, as in the reference.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core import costmodel as cm
from repro_torch.core import mbkr as mb


@dataclass
class PartitionPlan:
    chunks: List[int]            # token counts, sum == S
    quantum: int
    t_prefill: float             # seconds (analytic, MBKR-enabled model)
    t_e2e: float
    throughput: float
    batch: int
    dp_objective: float          # stage-1 proxy value
    sa_iters: int = 0
    sa_accepted: int = 0
    mbkr_plan: Optional[mb.MBKRPlan] = None

    @property
    def num_chunks(self) -> int:
        return len(self.chunks)


def uniform_partition(seq_len: int, num_chunks: int) -> List[int]:
    base = seq_len // num_chunks
    rem = seq_len % num_chunks
    return [base + (1 if i < rem else 0) for i in range(num_chunks)]


# ------------------------------------------------------------------ stage 1

def dp_partition(
    s_quanta: int,
    num_chunks: int,
    num_stages: int,
    eval_chunk_vec: Callable[[np.ndarray, int], np.ndarray],
    *,
    objective_only: bool = False,
) -> Tuple[List[int], float]:
    """Alg. 1 lines 1-7 over quantized positions.

    ``eval_chunk_vec(k_array, s)`` -> compute seconds for chunks of k quanta
    starting at quantum position s (prefix = s quanta).

    Returns (chunk sizes in quanta, proxy objective).
    """
    m_tot, sq, n = num_chunks, s_quanta, num_stages
    inf = float("inf")
    # suffix DP: t_max[m][s], t_sum[m][s] = best over partitions of [s..S) into
    # chunks m..M. m+1 row is the previously computed row.
    t_max = np.full((m_tot + 2, sq + 1), inf)
    t_sum = np.full((m_tot + 2, sq + 1), inf)
    t_max[m_tot + 1][sq] = 0.0
    t_sum[m_tot + 1][sq] = 0.0
    ss = np.zeros((m_tot + 1, sq + 1), np.int32)
    for m in range(m_tot, 0, -1):
        chunks_left = m_tot - m  # chunks after this one
        for s in range(sq - 1, -1, -1):
            kmax = sq - s - chunks_left
            if kmax < 1:
                continue
            ks = np.arange(1, kmax + 1)
            t = eval_chunk_vec(ks, s)
            nxt_max = t_max[m + 1][s + ks]
            nxt_sum = t_sum[m + 1][s + ks]
            cand_max = np.maximum(nxt_max, t)
            cand_sum = nxt_sum + t
            obj = cand_sum + (n - 1) * cand_max
            feasible = np.isfinite(obj)
            if not feasible.any():
                continue
            best = int(np.nanargmin(np.where(feasible, obj, inf)))
            t_max[m][s] = cand_max[best]
            t_sum[m][s] = cand_sum[best]
            ss[m][s] = int(ks[best])
    obj0 = t_sum[1][0] + (n - 1) * t_max[1][0]
    if not math.isfinite(obj0):
        raise ValueError(f"infeasible DP: S={s_quanta} quanta, M={num_chunks}")
    # reconstruct
    chunks, s = [], 0
    for m in range(1, m_tot + 1):
        k = int(ss[m][s])
        chunks.append(k)
        s += k
    assert s == sq, (chunks, sq)
    return chunks, float(obj0)


# ------------------------------------------------------------------ stage 2

def _evaluate_full(chunks_tokens: Sequence[int], sm: cm.StageModel,
                   num_stages: int, hw: cm.HardwareProfile,
                   mbkr_plan: Optional[mb.MBKRPlan], batch_cap: int,
                   compress: float = 1.0) -> Tuple[int, float, float, float]:
    """EVALUATEPREFILL + EVALUATEE2E: (B, T_prefill, T_e2e, throughput)."""
    res = cm.evaluate_prefill(chunks_tokens, sm, num_stages, hw,
                              mbkr_plan=mbkr_plan, compress=compress)
    # feasible batch: weights + KV slot pool must fit per-die HBM
    cfg = sm.cfg
    weights = cfg.param_count() * 2 / (num_stages * max(sm.tp, 1))
    cmax = max(chunks_tokens)
    slots = mbkr_plan.num_slots if mbkr_plan else len(chunks_tokens)
    pool = slots * cm.kv_chunk_bytes(sm, cmax) / max(sm.tp, 1)
    spare = hw.hbm_cap - weights - pool
    if spare < 0:
        return 0, math.inf, math.inf, 0.0
    batch = batch_cap
    lat, thr = cm.evaluate_e2e(batch, res.latency, chunks_tokens, sm, num_stages,
                               hw, mbkr_plan=mbkr_plan, compress=compress)
    return batch, res.latency, lat, thr


def plan_partition(
    cfg: ModelConfig,
    seq_len: int,
    num_chunks: int,
    num_stages: int,
    hw: cm.ProfileSpec = cm.WSC_PAPER,
    *,
    tp: int = 1,
    quantum: Optional[int] = None,
    mbkr: bool = True,
    compress: float = 1.0,
    sa_iters: int = 400,
    sa_rounds: int = 8,
    temp0: float = 0.1,
    alpha: float = 0.7,
    batch_cap: int = 8,
    seed: int = 0,
) -> PartitionPlan:
    """Full LBCP: DP init + SA refinement. Returns token-level chunk sizes.

    ``hw`` takes a ``HardwareProfile``, a registered profile name, or a path
    to a profile JSON (``costmodel.resolve_profile``)."""
    hw = cm.resolve_profile(hw)
    if quantum is None:
        quantum = max(seq_len // max(num_chunks * 16, 1), 1)
        quantum = min(quantum, max(seq_len // num_chunks, 1))
    sq = seq_len // quantum
    assert sq >= num_chunks, (seq_len, quantum, num_chunks)
    rem_tokens = seq_len - sq * quantum  # folded into the last chunk

    sm = cm.StageModel.build(cfg, num_stages, tp)
    mplan = mb.plan(num_chunks, num_stages) if mbkr else None

    def eval_chunk_vec(ks: np.ndarray, s: int) -> np.ndarray:
        c = ks.astype(np.float64) * quantum
        p = float(s * quantum)
        peak = sm.tp * hw.flops
        bw = sm.tp * hw.hbm_bw
        gemm = sm.layers * c * cm.layer_linear_flops_per_token(cfg) / (peak * hw.gemm_eff)
        if cfg.attn_free:
            afl = np.array([cm.attn_flops(cfg, int(ci), 0) for ci in c]) * sm.layers
            return gemm + afl / (peak * hw.attn_eff)
        hd = cfg.resolved_head_dim
        afl = sm.attn_layers * 4 * c * (p + (c + 1) / 2.0) * cfg.num_heads * hd
        abytes = sm.attn_layers * (p + c) * cm.kv_bytes_per_token_layer(cfg)
        attn = np.maximum(afl / (peak * hw.attn_eff), abytes / bw)
        return gemm + attn

    dp_chunks_q, dp_obj = dp_partition(sq, num_chunks, num_stages, eval_chunk_vec)

    def to_tokens(chunks_q: Sequence[int]) -> List[int]:
        out = [int(k) * quantum for k in chunks_q]
        out[-1] += rem_tokens
        return out

    rng = np.random.default_rng(seed)
    cur = list(dp_chunks_q)
    _, tpre, te2e, thr = _evaluate_full(to_tokens(cur), sm, num_stages, hw,
                                        mplan, batch_cap, compress)
    cur_score = te2e
    best, best_score, best_stats = list(cur), cur_score, (tpre, te2e, thr)
    temp = temp0 * max(cur_score, 1e-9)
    accepted = total = 0
    temp_min = temp0 * max(cur_score, 1e-9) * (alpha ** sa_rounds)
    while temp > temp_min:
        for _ in range(sa_iters // max(sa_rounds, 1)):
            total += 1
            nxt = list(cur)
            # perturb one boundary, preserving S and M (Alg. 1 line 10)
            i = int(rng.integers(0, num_chunks - 1)) if num_chunks > 1 else 0
            delta = int(rng.integers(1, 3)) * (1 if rng.random() < 0.5 else -1)
            if num_chunks == 1:
                continue
            if nxt[i] + delta < 1 or nxt[i + 1] - delta < 1:
                continue
            nxt[i] += delta
            nxt[i + 1] -= delta
            _, tpre_n, te2e_n, thr_n = _evaluate_full(
                to_tokens(nxt), sm, num_stages, hw, mplan, batch_cap, compress)
            if te2e_n < cur_score or rng.random() < math.exp(
                    -(te2e_n - cur_score) / max(temp, 1e-12)):
                cur, cur_score = nxt, te2e_n
                accepted += 1
                if te2e_n < best_score:
                    best, best_score = list(nxt), te2e_n
                    best_stats = (tpre_n, te2e_n, thr_n)
        temp *= alpha

    tpre, te2e, thr = best_stats
    return PartitionPlan(
        chunks=to_tokens(best), quantum=quantum, t_prefill=tpre, t_e2e=te2e,
        throughput=thr, batch=batch_cap, dp_objective=dp_obj,
        sa_iters=total, sa_accepted=accepted, mbkr_plan=mplan)
