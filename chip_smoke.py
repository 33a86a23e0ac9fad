#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA card.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases, each of which raises on failure (the script then exits non-zero and
prints no result line):

1. card: prints the card's name and power limit (nvidia-smi), turns TF32 off;
2. build: compiles every ``src/repro_torch/csrc/*.cu`` with nvcc, timed;
3. kernels: holds each CUDA kernel (K1 chunk attention, K2 pool attention,
   K3 paged pool attention) against its plain PyTorch version on the card,
   at the shapes of the serve phase, in bf16 and fp32 with bf16/fp32, int8
   and fp8 pages, each output tensor at its own scale (see ``compare``);
   times kernel, plain version and, for K1, one
   ``scaled_dot_product_attention`` call as a yardstick (never used by the
   port);
4. smoke parity: the small qwen3-8b config in fp32 through the kernel
   backends on the card against the same pipeline on the CPU (plain
   versions);
5. serve: qwen3-8b at full width and depth (36 layers, random weights from
   a seeded generator) through ``PrefillEngine`` + ``TorchExecutor``: N=8
   stages, M=8 chunks of 512 tokens, 2 requests a wave, 4 requests, under
   qship/fetch x cuda/paged pools plus one int8-page run. In bf16 (the main
   path; the kernels' launch counters are set to 0 just before these runs
   and read just after) the logits are held against a witness that keeps
   p in fp32 as the kernels do, at a limit that two planted kernel faults
   must break; in fp32 every request's argmax must equal the ``torch``
   backend's (see ``serve_phase``).

Then one JSON line of per-kernel numbers and, last, the result line.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
CU_SOURCE = "src/repro_torch/csrc/chunk_attn.cu"
TPU_KERNELS = {
    "chunk_attention": "src/repro/kernels/chunk_attn.py:434",
    "pool_attention": "src/repro/kernels/chunk_attn.py:167",
    "pool_attention_paged": "src/repro/kernels/chunk_attn.py:345",
}
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}

# serve-phase geometry; the kernel phases use the same shapes
N_STAGES, N_CHUNKS, CHUNK, BATCH, REQUESTS = 8, 8, 512, 2, 4


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------ timing

def time_ms(fn, iters: int = 12, warmup: int = 2) -> float:
    """Median device time of one call, CUDA events around each call."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float, dtype: str):
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the peak rate of the input type."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> float:
    return float(sum(t.numel() * t.element_size() for t in ts if t is not None))


# ----------------------------------------------------------------- kernels

def compare(name: str, got, ref, in_dtype: str) -> float:
    """Holds each output tensor against the plain version's, at its own
    scale max|ref|: a bf16 output (K1's ``out``) within 2e-2 of it, an fp32
    state tensor (m, l, acc) within 1e-3 for bf16 or quantized inputs and
    1e-4 for fp32 inputs. Entries where the reference holds the empty-row
    sentinel m = -1e30 must match it exactly and stay out of the numbers.
    Returns the largest absolute error."""
    import torch
    worst = 0.0
    for label, g, r in zip(("out", "m", "l", "acc")[-len(got):], got, ref):
        rel = (2e-2 if r.dtype == torch.bfloat16
               else 1e-4 if in_dtype == "float32" else 1e-3)
        g, r = g.float(), r.float()
        empty = r <= -1e29
        check(bool((g[empty] == r[empty]).all()), f"{name}: sentinel m = -1e30 not kept")
        g, r = g[~empty], r[~empty]
        if not r.numel():
            continue
        err, scale = (g - r).abs().max().item(), r.abs().max().item()
        tol = rel * max(scale, 1e-30)
        log(f"  {name} {label}: max abs err {err:.3e} (max|ref| {scale:.3e}, "
            f"tol {tol:.3e})")
        check(err <= tol, f"{name} {label}: max abs err {err} > {tol}")
        worst = max(worst, err)
    return worst


def quantize(x, kind: str, dims):
    """A payload and fp32 scales (amax over ``dims``) of ``x``."""
    import torch
    from repro_torch.kvstore import quant
    target = quant.INT8_MAX if kind == "int8" else quant.FP8_MAX
    sc = torch.clamp(x.float().abs().amax(dim=dims, keepdim=True), min=1e-6) / target
    if kind == "int8":
        q = torch.clamp(torch.round(x.float() / sc), -127, 127).to(torch.int8)
    else:
        q = (x.float() / sc).to(torch.float8_e4m3fn)
    return q, sc


def kernel_phase(results: dict) -> None:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    gb, c, h, kvh, d = N_STAGES * BATCH, CHUNK, 32, 8, 128

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # ---------------- K1: the causal self block of every (stage, batch) row
    log(f"[kernels] K1 chunk_attention  q [{gb},{c},{h},{d}]")
    k1_err = 0.0
    for name, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        q, k, v = randn(gb, c, h, d, dtype=dt), randn(gb, c, kvh, d, dtype=dt), \
            randn(gb, c, kvh, d, dtype=dt)
        got = ops.chunk_attention(q, k, v, return_state=True)
        want = ref.chunk_attention_plain(q, k, v)
        torch.cuda.synchronize()
        k1_err = max(k1_err, compare(f"self block {name}", got, want, name))
        if name == "bfloat16":
            ms = time_ms(lambda: ops.chunk_attention(q, k, v, return_state=True))
            plain = time_ms(lambda: ref.chunk_attention_plain(q, k, v))
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True))
            pairs = gb * h * c * (c + 1) / 2
            b_ms, by = bound_ms(nbytes(q, k, v, *got), 4.0 * d * pairs, name)
            results["chunk_attention"] = {"ms": ms, "plain_ms": plain,
                                          "library_ms": lib, "bound_ms": b_ms,
                                          "bound_by": by}
            log(f"  time: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                f"sdpa {lib:.4f} ms, bound {b_ms:.4f} ms ({by})")
    # stored-chunk blocks with quantized pages (full visibility: offset T)
    q = randn(gb, c, h, d, dtype=torch.bfloat16)
    for kind in ("int8", "fp8"):
        kq, ks = quantize(randn(gb, c, kvh, d), kind, (1, 3))
        vq, vs = quantize(randn(gb, c, kvh, d), kind, (1, 3))
        ks = ks.expand(gb, c, kvh, 1)[..., 0].contiguous()
        vs = vs.expand(gb, c, kvh, 1)[..., 0].contiguous()
        got = ops.chunk_attention(q, kq, vq, causal_offset=c, return_state=True,
                                  k_scale=ks, v_scale=vs)
        want = ref.chunk_attention_plain(q, kq, vq, causal_offset=c,
                                         k_scale=ks, v_scale=vs)
        k1_err = max(k1_err, compare(f"chunk block {kind} pages", got, want, kind))
    # a prefix offset with padded keys: kv_len < T
    q, k, v = randn(gb, c, h, d), randn(gb, 2 * c, kvh, d), randn(gb, 2 * c, kvh, d)
    kv_len = 2 * c - c // 3
    got = ops.chunk_attention(q, k, v, causal_offset=c, kv_len=kv_len,
                              return_state=True)
    want = ref.chunk_attention_plain(q, k, v, causal_offset=c, kv_len=kv_len)
    k1_err = max(k1_err, compare(f"offset {c}, kv_len {kv_len} < T fp32", got,
                                 want, "float32"))
    results["chunk_attention"]["max_abs_err"] = k1_err

    # ---------------- K2: one launch over the stacked own-pool slots
    slots = 6
    log(f"[kernels] K2 pool_attention  q [{gb},{c},{h},{d}], k/v [{slots},{gb},{c},{kvh},{d}]")
    valid = torch.zeros((N_STAGES, slots), dtype=torch.bool, device=dev)
    for s in range(N_STAGES):           # stage s at phase s: min(s, 6) slots
        valid[s, :min(s, slots)] = True
    k2_err = 0.0
    for name, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        q = randn(gb, c, h, d, dtype=dt)
        k, v = randn(slots, gb, c, kvh, d, dtype=dt), randn(slots, gb, c, kvh, d, dtype=dt)
        got = ops.pool_attention(q, k, v, valid)
        want = ref.pool_attention_plain(q, k, v, valid)
        k2_err = max(k2_err, compare(f"pool {name}", got, want, name))
        m, l, acc = got
        check(bool((m[:BATCH] == -1e30).all() and (l[:BATCH] == 0).all()
                   and (acc[:BATCH] == 0).all()),
              "K2: an all-invalid group is not exactly (-1e30, 0, 0)")
        if name == "bfloat16":
            ms = time_ms(lambda: ops.pool_attention(q, k, v, valid))
            plain = time_ms(lambda: ref.pool_attention_plain(q, k, v, valid))
            n_valid = int(valid.sum().item())
            kv_read = 2.0 * n_valid * BATCH * c * kvh * d * k.element_size()
            ops_n = 4.0 * d * n_valid * BATCH * h * c * c
            b_ms, by = bound_ms(nbytes(q, valid, *got) + kv_read, ops_n, name)
            results["pool_attention"] = {"ms": ms, "plain_ms": plain,
                                         "library_ms": None, "bound_ms": b_ms,
                                         "bound_by": by}
            log(f"  time: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                f"bound {b_ms:.4f} ms ({by}), {n_valid} valid (stage, slot)")
    q = randn(gb, c, h, d, dtype=torch.bfloat16)
    for kind in ("int8", "fp8"):
        kq, ks = quantize(randn(slots, gb, c, kvh, d), kind, (2, 4))
        vq, vs = quantize(randn(slots, gb, c, kvh, d), kind, (2, 4))
        ks = ks.expand(slots, gb, c, kvh, 1)[..., 0].contiguous()
        vs = vs.expand(slots, gb, c, kvh, 1)[..., 0].contiguous()
        got = ops.pool_attention(q, kq, vq, valid, k_scale=ks, v_scale=vs)
        want = ref.pool_attention_plain(q, kq, vq, valid, k_scale=ks, v_scale=vs)
        k2_err = max(k2_err, compare(f"pool {kind} pages", got, want, kind))
    results["pool_attention"]["max_abs_err"] = k2_err

    # ---------------- K3: pages read in place from a strided stage-stacked pool
    log(f"[kernels] K3 pool_attention_paged  layer view of a "
        f"[{N_STAGES},{slots + 1},2,{BATCH},{c},{kvh},{d}] pool")
    k3_err = 0.0
    npages, lps = slots + 1, 2
    handles = torch.arange(slots, dtype=torch.int32, device=dev)
    for name, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        q = randn(gb, c, h, d, dtype=dt)
        kp = randn(N_STAGES, npages, lps, BATCH, c, kvh, d, dtype=dt)
        vp = randn(N_STAGES, npages, lps, BATCH, c, kvh, d, dtype=dt)
        k_l, v_l = kp[:, :, 1], vp[:, :, 1]           # strided views
        got = ops.pool_attention_paged(q, k_l, v_l, handles, valid, ppc=1)
        want = ref.pool_attention_paged_plain(q, k_l, v_l, handles, valid, ppc=1)
        k3_err = max(k3_err, compare(f"paged {name}", got, want, name))
        m, l, acc = got
        check(bool((m[:BATCH] == -1e30).all() and (l[:BATCH] == 0).all()
                   and (acc[:BATCH] == 0).all()),
              "K3: an all-invalid group is not exactly (-1e30, 0, 0)")
        if name == "bfloat16":
            ms = time_ms(lambda: ops.pool_attention_paged(q, k_l, v_l, handles,
                                                          valid, ppc=1))
            plain = time_ms(lambda: ref.pool_attention_paged_plain(
                q, k_l, v_l, handles, valid, ppc=1))
            n_valid = int(valid.sum().item())
            kv_read = 2.0 * n_valid * BATCH * c * kvh * d * kp.element_size()
            ops_n = 4.0 * d * n_valid * BATCH * h * c * c
            b_ms, by = bound_ms(nbytes(q, valid, handles, *got) + kv_read, ops_n, name)
            results["pool_attention_paged"] = {"ms": ms, "plain_ms": plain,
                                               "library_ms": None,
                                               "bound_ms": b_ms, "bound_by": by}
            log(f"  time: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                f"bound {b_ms:.4f} ms ({by})")
        del kp, vp
    # quantized pages with per-page scales read through the same handles
    q = randn(gb, c, h, d, dtype=torch.bfloat16)
    for kind in ("int8", "fp8"):
        kp, ksp = quantize(randn(N_STAGES, npages, lps, BATCH, c, kvh, d), kind, (4, 6))
        vp, vsp = quantize(randn(N_STAGES, npages, lps, BATCH, c, kvh, d), kind, (4, 6))
        args = (q, kp[:, :, 0], vp[:, :, 0], handles, valid)
        kw = dict(ppc=1, k_scale=ksp[:, :, 0], v_scale=vsp[:, :, 0])
        got = ops.pool_attention_paged(*args, **kw)
        want = ref.pool_attention_paged_plain(*args, **kw)
        k3_err = max(k3_err, compare(f"paged {kind} pages", got, want, kind))
    # four pages a chunk, shuffled handles, a partial last page
    ppc, pt = 4, c // 4
    perm = torch.randperm(npages * ppc, generator=gen, device=dev)
    handles = perm[: slots * ppc].to(torch.int32)
    q = randn(gb, c, h, d)
    kp = randn(N_STAGES, npages * ppc, lps, BATCH, pt, kvh, d)
    vp = randn(N_STAGES, npages * ppc, lps, BATCH, pt, kvh, d)
    args = (q, kp[:, :, 1], vp[:, :, 1], handles, valid)
    kv_len = 3 * pt - pt // 5                   # the third page is partial
    got = ops.pool_attention_paged(*args, ppc=ppc, kv_len=kv_len)
    want = ref.pool_attention_paged_plain(*args, ppc=ppc, kv_len=kv_len)
    k3_err = max(k3_err, compare(f"paged ppc 4, shuffled handles, kv_len "
                                 f"{kv_len} fp32", got, want, "float32"))
    results["pool_attention_paged"]["max_abs_err"] = k3_err


# ------------------------------------------------------------ smoke parity

def smoke_parity_phase() -> None:
    """The small config in fp32: kernel backends on the card against the
    same pipeline on the CPU (whose wrappers take the plain versions)."""
    import numpy as np
    import torch
    from repro_torch.configs import RunConfig, get_smoke_config, replace
    from repro_torch.core import pipeline as pp
    from repro_torch.core.staging import init_staged

    cfg = replace(get_smoke_config("qwen3-8b"), dtype="float32")
    seq = 8 * 16
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, seq))
    log("[smoke parity] qwen3-8b smoke config, fp32, N=8 M=8 C=16 B=2")
    for remote, pool_be, kv in (("qship", "cuda", "auto"), ("fetch", "paged", "auto"),
                                ("fetch", "cuda", "int8"), ("qship", "paged", "fp8")):
        run = RunConfig(num_chunks=8, num_stages=8, remote_attn=remote,
                        attn_backend="cuda", pool_backend=pool_be, kv_dtype=kv)
        plan = pp.build_plan(cfg, 8, seq, run)
        staged = init_staged(cfg, plan, torch.Generator().manual_seed(0), device="cpu")
        cpu, led_cpu = pp.prefill_pipeline(cfg, staged, tokens, plan, device="cpu",
                                           return_ledger=True)
        card = {k: (v.cuda() if torch.is_tensor(v) else
                    {kk: vv.cuda() for kk, vv in v.items()})
                for k, v in staged.items()}
        got, led = pp.prefill_pipeline(cfg, card, tokens, plan, device="cuda",
                                       return_ledger=True)
        got = got.cpu()
        rel = ((got - cpu).abs() / (cpu.abs() + 1e-3)).flatten()
        p99 = torch.quantile(rel, 0.99).item()
        log(f"  {remote}/{pool_be}/{kv}: rel err card vs cpu max {rel.max().item():.3e}, "
            f"p99 {p99:.3e}")
        check(bool(torch.isfinite(got).all()), "smoke parity: non-finite logits")
        if kv == "auto":
            check(rel.max().item() < 1e-3, f"smoke parity {remote}/{pool_be}: "
                  f"max rel err {rel.max().item()}")
        else:
            # 1-byte pages: a last-bit difference in the fp32 activations
            # can move a stored value by one code (1/8 of it for fp8), so
            # hold the tail and the argmax, as the CPU tests do for int8
            check(p99 < 1e-2 and bool((got.argmax(-1) == cpu.argmax(-1)).all()),
                  f"smoke parity {remote}/{pool_be}/{kv}: p99 rel err {p99}")
        check(led == led_cpu, "smoke parity: ledgers differ between card and cpu")


# ------------------------------------------------------------------- serve

COMBOS = [("qship", "cuda", "cuda", "auto"), ("qship", "cuda", "paged", "auto"),
          ("fetch", "cuda", "cuda", "auto"), ("fetch", "cuda", "paged", "auto"),
          ("qship", "cuda", "cuda", "int8")]
# serve checks, as fractions of the reference's max|logit|: a bf16 kernel
# combination against the witness, the cuda pool (K2) against the paged
# pool (K3) under the same remote mode in bf16, and an fp32 combination
# against the torch backend
BF16_LOGIT_TOL = 0.1
BF16_POOL_PAIR_TOL = 1e-3
FP32_LOGIT_TOL = 1e-3


@contextlib.contextmanager
def swapped(owner, name: str, value):
    """``owner.name`` is ``value`` inside the block."""
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def p32_witness():
    """The ``torch`` backend with p kept in fp32 before PV and stored pages
    dequantized to fp32, as the kernels do: only the fp32 summation order
    differs from them."""
    import torch
    from repro_torch.core.attention import TorchBackend
    from repro_torch.kvstore import quant

    class P32Witness(TorchBackend):
        def self_block(self, qg, k, v, scale, st):
            return super().self_block(qg, k, v.float(), scale, st)

        def chunk_block(self, qg, k, v, valid, scale, st):
            return super().chunk_block(qg, k, v.float(), valid, scale, st)

        def chunk_block_q(self, qg, kq, vq, k_scale, v_scale, valid, scale, st):
            if k_scale is not None:
                pt = kq.shape[1] // k_scale.shape[0]
                k_scale = quant.expand_page_scale(k_scale, pt)
                v_scale = quant.expand_page_scale(v_scale, pt)
            return self.chunk_block(qg, quant.decode(kq, k_scale, torch.float32),
                                    quant.decode(vq, v_scale, torch.float32),
                                    valid, scale, st)

    return P32Witness


def planted_faults(real):
    """Wrong versions of the K2 wrapper ``real``, for showing that the serve
    checks (bf16 and fp32) fail a wrong kernel."""
    import torch

    def acc_zero(*args, **kw):
        m, l, acc = real(*args, **kw)
        return m, l, torch.zeros_like(acc)

    def last_slot_dropped(q, k, v, valid, **kw):
        last = valid & (valid.cumsum(1) == valid.sum(1, keepdim=True))
        return real(q, k, v, valid & ~last, **kw)

    return {"K2 returns acc = 0": acc_zero,
            "K2 skips the last valid slot": last_slot_dropped}


def serve_phase(results: dict) -> None:
    """qwen3-8b at full width and depth through PrefillEngine + TorchExecutor.

    bf16, the main path: the launch counters are set to 0 just before the
    five kernel combinations and read just after. Each combination is held
    against ``p32_witness`` on the same pages (auto / int8) by the logits'
    max abs error, at most BF16_LOGIT_TOL of max|logit|. Argmax is reported,
    not held: in bf16 a last-bit difference in fp32 flips the rounding of a
    few activations, 36 residual updates carry it to the logits, and a
    request whose top two logits lie closer than that may take either. The
    K2 and K3 pools must agree to BF16_POOL_PAIR_TOL. Each planted K2 fault
    must break BF16_LOGIT_TOL, which shows that the limit separates a wrong
    kernel. The ``torch`` backend itself (p rounded to bf16 before PV, as
    the reference's JnpBackend) is reported beside.
    fp32 (same geometry, weights drawn in fp32): summation order is the
    only difference left, so every combination's argmax must equal the
    ``torch`` backend's on the same pages (auto / int8)."""
    import numpy as np
    import torch
    from repro_torch.configs import RunConfig, get_config, replace
    from repro_torch.core import attention
    from repro_torch.core import pipeline as pp
    from repro_torch.core.staging import init_staged
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import make_requests
    from repro_torch.models.layers import pad_vocab
    from repro_torch.runtime.engine import (EngineConfig, PrefillEngine,
                                            TorchExecutor)

    cfg = get_config("qwen3-8b")
    seq = N_CHUNKS * CHUNK
    base = RunConfig(num_chunks=N_CHUNKS, num_stages=N_STAGES)
    plan = pp.build_plan(cfg, N_STAGES, seq, base)
    log(f"[serve] qwen3-8b d={cfg.d_model} layers={cfg.num_layers} "
        f"lps={plan.layers_per_stage} N={N_STAGES} M={N_CHUNKS} C={CHUNK} "
        f"slots={plan.num_slots} p2={plan.p2} host_slots_used="
        f"{plan.host_slots_used.tolist()} ticks={plan.num_ticks}")
    check(plan.p2 < N_CHUNKS - 1, "the plan has no remote chunk to attend to")

    def weights(model_cfg):
        t0 = time.perf_counter()
        gen = torch.Generator(device="cuda").manual_seed(0)
        staged = init_staged(model_cfg, plan, gen, device="cuda")
        torch.cuda.synchronize()
        log(f"  {model_cfg.dtype} weights: {time.perf_counter() - t0:.2f} s, "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
        return staged

    def serve(model_cfg, staged, remote: str, attn: str, pool: str, kv: str):
        run = RunConfig(num_chunks=N_CHUNKS, num_stages=N_STAGES,
                        remote_attn=remote, attn_backend=attn,
                        pool_backend=pool, kv_dtype=kv)
        ex = TorchExecutor(model_cfg, staged, run, device="cuda")
        eng = PrefillEngine(EngineConfig(model=model_cfg, num_stages=N_STAGES,
                                         num_chunks=N_CHUNKS, max_batch=BATCH,
                                         buckets=(seq,)), ex)
        for r in make_requests(REQUESTS, seq, model_cfg.vocab_size, seed=0):
            eng.submit(r)
        eng.run_until_drained()
        done = sorted(eng.done, key=lambda r: r.rid)
        name = f"{model_cfg.dtype} {remote}/{attn}/{pool}/{kv}"
        check(len(done) == REQUESTS, f"{name}: {len(done)} of {REQUESTS} answered")
        logits = np.stack([r.result for r in done])
        check(logits.shape == (REQUESTS, pad_vocab(model_cfg.vocab_size)),
              f"{name}: logits shape {logits.shape}")
        check(bool(np.isfinite(logits).all()), f"{name}: non-finite logits")
        walls = [w["dur"] for w in ex.waves]
        log(f"  {name}: argmax {logits.argmax(-1).tolist()}, wave wall s "
            f"{[round(w, 4) for w in walls]}")
        return logits, walls

    def against(logits, want, what: str) -> tuple:
        cos = (logits * want).sum(-1) / (np.linalg.norm(logits, axis=-1)
                                         * np.linalg.norm(want, axis=-1))
        err = np.abs(logits - want).max() / np.abs(want).max()
        same = int((logits.argmax(-1) == want.argmax(-1)).sum())
        log(f"    vs {what}: cosine min {cos.min():.6f}, max abs err "
            f"{err:.3e} of max|logit|, argmax equal {same}/{len(want)}")
        return cos.min(), err, same

    def margins(logits) -> list:
        top2 = np.sort(logits, axis=-1)[:, -2:]
        return [round(float(x), 5) for x in (top2[:, 1] - top2[:, 0])
                / np.abs(logits).max()]

    # ---- bf16, the main path: the launch counts are read around it
    staged = weights(cfg)
    with swapped(attention, "_BACKENDS",
                 dict(attention._BACKENDS, torch=p32_witness())):
        witness = {kv: serve(cfg, staged, "qship", "torch", "torch", kv)[0]
                   for kv in ("auto", "int8")}
    log(f"  (the two runs above: p32 witness) top-2 margin of max|logit| per "
        f"request: {margins(witness['auto'])}")
    torch_be, _ = serve(cfg, staged, "qship", "torch", "torch", "auto")
    ops.reset_launches()
    bf16 = {combo: serve(cfg, staged, *combo)[0] for combo in COMBOS}
    launches = dict(ops.LAUNCHES)
    log(f"  launches on the main path: {launches}")
    def passes(model_cfg, err: float, same: int) -> bool:
        if model_cfg.dtype == "float32":
            return same == REQUESTS and err < FP32_LOGIT_TOL
        return err <= BF16_LOGIT_TOL

    failures = []

    def hold(model_cfg, logits, want, what: str, name: str) -> None:
        _, err, same = against(logits, want, what)
        if not passes(model_cfg, err, same):
            failures.append(f"{model_cfg.dtype} {name}: argmax equal {same}, "
                            f"logits err {err} vs the {what}")

    def planted(model_cfg, staged, want, what: str) -> None:
        for fault, fn in planted_faults(ops.pool_attention).items():
            with swapped(ops, "pool_attention", fn):
                logits, _ = serve(model_cfg, staged, "qship", "cuda", "cuda", "auto")
            log(f"  planted fault: {fault}")
            _, err, same = against(logits, want, what)
            if passes(model_cfg, err, same):
                failures.append(f"{model_cfg.dtype}: planted fault '{fault}' "
                                f"passes the check ({err})")

    for combo, logits in bf16.items():
        log(f"  bf16 {'/'.join(combo)}")
        hold(cfg, logits, witness[combo[3]], "p32 witness", "/".join(combo))
        if combo[3] == "auto":
            against(logits, torch_be, "torch backend")
    for remote in ("qship", "fetch"):
        log(f"  bf16 {remote}: cuda pool (K2) against paged pool (K3)")
        _, err, _ = against(bf16[(remote, "cuda", "cuda", "auto")],
                            bf16[(remote, "cuda", "paged", "auto")], "paged pool")
        if err > BF16_POOL_PAIR_TOL:
            failures.append(f"bf16 {remote}: K2 and K3 pools differ by {err}")
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched on the main path")
        results[name]["launches"] = count
    planted(cfg, staged, witness["auto"], "p32 witness")
    del staged, witness, torch_be, bf16
    torch.cuda.empty_cache()

    # ---- fp32: the argmax of every request, every combination
    cfg32 = replace(cfg, dtype="float32")
    staged = weights(cfg32)
    refs = {kv: serve(cfg32, staged, "qship", "torch", "torch", kv)[0]
            for kv in ("auto", "int8")}
    for combo in COMBOS:
        logits, _ = serve(cfg32, staged, *combo)
        hold(cfg32, logits, refs[combo[3]], "torch backend", "/".join(combo))
    planted(cfg32, staged, refs["auto"], "torch backend")
    del staged
    torch.cuda.empty_cache()
    check(not failures, "; ".join(failures))


# -------------------------------------------------------------------- main

def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args()
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    t_start = time.perf_counter()
    try:
        log(card_line())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        log(f"torch {torch.__version__} cuda {torch.version.cuda} "
            f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

        from repro_torch.kernels import build
        t0 = time.perf_counter()
        build.build_all(verbose=True)
        log(f"[build] nvcc {time.perf_counter() - t0:.1f} s -> {build.build_dir()}")
        for name, text in sorted(build.LOGS.items()):
            regs = [int(x) for x in re.findall(r"Used (\d+) registers", text)]
            spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", text)]
            log(f"  lib{name}.so: {len(regs)} kernels, registers max {max(regs, default=0)}, "
                f"spill stores max {max(spills, default=0)} bytes")

        results: dict = {}
        t0 = time.perf_counter()
        kernel_phase(results)
        log(f"[kernels] {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        smoke_parity_phase()
        log(f"[smoke parity] {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        serve_phase(results)
        log(f"[serve] {time.perf_counter() - t0:.1f} s")
        torch.cuda.synchronize()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    kernels = []
    for name, r in results.items():
        kernels.append({
            "name": name, "route": "cuda", "source": CU_SOURCE,
            "replaces": TPU_KERNELS[name], "tpu_kernel": TPU_KERNELS[name],
            "launches": r["launches"], "max_abs_err": r["max_abs_err"],
            "max_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
