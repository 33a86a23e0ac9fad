#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA card.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases, each of which raises on failure (the script then exits non-zero and
prints no result line):

1. card: prints the card's name and power limit (nvidia-smi), turns TF32 off;
2. build: compiles every ``src/repro_torch/csrc/*.cu`` with nvcc (one
   process per library, all at once), timed;
3. kernels: holds each CUDA kernel against its plain PyTorch version on the
   card, each output tensor at its own scale (see ``compare``), and times
   kernel, plain version and, where one exists, a PyTorch call computing
   the same function (never used by the port):
   - K1 chunk attention, K2 pool attention, K3 paged pool attention at
     qwen3-8b's shapes (head dim 128, GQA) in bf16 and fp32 with bf16/fp32,
     int8 and fp8 pages, and at zamba2-7b's shared-block shape (head dim
     112, MHA) in bf16 with bf16 and int8 pages;
   - K4 the Mamba2 SSD scan at zamba2-7b's and mamba2-130m's shapes in
     bf16 and fp32, with a non-zero init_state, one a_log / d_skip row per
     stage (Gs = 8) and a case with G < H SSM groups;
4. smoke parity: the small qwen3-8b, zamba2-7b and mamba2-130m configs in
   fp32 through the kernel backends on the card against the same pipeline
   on the CPU (plain versions);
5. serve: each model at full width and depth (random weights from a seeded
   generator) through ``PrefillEngine`` + ``TorchExecutor``: N=8 stages,
   M=8 chunks of 512 tokens, 2 requests a wave, 4 requests. qwen3-8b
   (36 layers) under qship/fetch x cuda/paged pools plus one int8-page run;
   zamba2-7b (81 layers) under qship/cuda, fetch/paged and one int8-page
   run; mamba2-130m (24 layers) under terapipe. Each model's bf16 runs are
   its main path: the kernels' launch counters are set to 0 just before
   them and read just after, and every kernel of the path must have
   launched. In bf16 the logits are held against a witness that keeps p in
   fp32 as the kernels do (and the ``torch`` SSD), at a limit that two
   planted kernel faults must break (K2 faults for qwen3-8b, K4 faults for
   the others); in fp32 every request's argmax must equal the ``torch``
   backends' (see ``serve_phase``).

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
KERNELS = {   # tag: (CUDA source, the TPU kernel it replaces)
    "chunk_attention": ("src/repro_torch/csrc/chunk_attn.cu",
                        "src/repro/kernels/chunk_attn.py:434"),
    "pool_attention": ("src/repro_torch/csrc/chunk_attn.cu",
                       "src/repro/kernels/chunk_attn.py:167"),
    "pool_attention_paged": ("src/repro_torch/csrc/chunk_attn.cu",
                             "src/repro/kernels/chunk_attn.py:345"),
    "ssd": ("src/repro_torch/csrc/ssd.cu", "src/repro/kernels/ssd.py:77"),
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

def tolerance(out_dtype, in_dtype: str) -> float:
    """An output's tolerance relative to max|ref| (see ``compare``)."""
    import torch
    return (2e-2 if out_dtype == torch.bfloat16
            else 1e-4 if in_dtype == "float32" else 1e-3)


def compare(name: str, got, ref, in_dtype: str,
            labels=("out", "m", "l", "acc")) -> float:
    """Holds each output tensor against the plain version's, at its own
    scale max|ref|: a bf16 output (K1's ``out``, K4's ``y``) within 2e-2 of
    it, an fp32 output (m, l, acc; K4's state) within 1e-3 for bf16 or
    quantized inputs and 1e-4 for fp32 inputs.
    Entries where the reference holds the empty-row sentinel m = -1e30 must
    match it exactly and stay out of the numbers. Returns the largest
    absolute error."""
    import torch
    worst = 0.0
    for label, g, r in zip(labels[-len(got):], got, ref):
        rel = tolerance(r.dtype, in_dtype)
        g, r = g.float(), r.float()
        empty = r <= -1e29
        check(bool((g[empty] == r[empty]).all()), f"{name}: sentinel m = -1e30 not kept")
        g, r = g[~empty], r[~empty]
        if not r.numel():
            continue
        check(bool(torch.isfinite(g).all()), f"{name} {label}: non-finite values")
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


def attention_phase(results: dict, h: int, kvh: int, d: int, full: bool) -> None:
    """K1-K3 at one model's attention shape: q [16, 512, h, d] (8 stages x
    batch 2 folded into the rows), k/v with kvh heads. ``full`` (qwen3-8b,
    d 128) runs bf16 and fp32 with bf16/fp32, int8 and fp8 pages, the
    kv_len and shuffled-page cases, and records the kernels' times;
    otherwise (zamba2-7b, d 112) bf16 with bf16 and int8 pages, times
    recorded under ``results[kernel]["d<d>"]``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    gb, c = N_STAGES * BATCH, CHUNK
    floats = (("bfloat16", torch.bfloat16), ("float32", torch.float32)) if full \
        else (("bfloat16", torch.bfloat16),)
    kinds = ("int8", "fp8") if full else ("int8",)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def record(name: str, **times) -> None:
        if full:
            results.setdefault(name, {}).update(times)
        else:
            results.setdefault(name, {})[f"d{d}"] = times

    # ---------------- K1: the causal self block of every (stage, batch) row
    log(f"[kernels] K1 chunk_attention  q [{gb},{c},{h},{d}], k/v [{gb},{c},{kvh},{d}]")
    k1_err = 0.0
    for name, dt in floats:
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
            record("chunk_attention", ms=ms, plain_ms=plain, library_ms=lib,
                   bound_ms=b_ms, bound_by=by)
            log(f"  time: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                f"sdpa {lib:.4f} ms, bound {b_ms:.4f} ms ({by})")
    # stored-chunk blocks with quantized pages (full visibility: offset T)
    q = randn(gb, c, h, d, dtype=torch.bfloat16)
    for kind in kinds:
        kq, ks = quantize(randn(gb, c, kvh, d), kind, (1, 3))
        vq, vs = quantize(randn(gb, c, kvh, d), kind, (1, 3))
        ks = ks.expand(gb, c, kvh, 1)[..., 0].contiguous()
        vs = vs.expand(gb, c, kvh, 1)[..., 0].contiguous()
        got = ops.chunk_attention(q, kq, vq, causal_offset=c, return_state=True,
                                  k_scale=ks, v_scale=vs)
        want = ref.chunk_attention_plain(q, kq, vq, causal_offset=c,
                                         k_scale=ks, v_scale=vs)
        k1_err = max(k1_err, compare(f"chunk block {kind} pages", got, want, kind))
    if full:
        # a prefix offset with padded keys: kv_len < T
        q, k, v = randn(gb, c, h, d), randn(gb, 2 * c, kvh, d), randn(gb, 2 * c, kvh, d)
        kv_len = 2 * c - c // 3
        got = ops.chunk_attention(q, k, v, causal_offset=c, kv_len=kv_len,
                                  return_state=True)
        want = ref.chunk_attention_plain(q, k, v, causal_offset=c, kv_len=kv_len)
        k1_err = max(k1_err, compare(f"offset {c}, kv_len {kv_len} < T fp32", got,
                                     want, "float32"))
    k1 = results["chunk_attention"]
    k1["max_abs_err"] = max(k1.get("max_abs_err", 0.0), k1_err)

    # ---------------- K2: one launch over the stacked own-pool slots
    slots = 6
    log(f"[kernels] K2 pool_attention  q [{gb},{c},{h},{d}], k/v [{slots},{gb},{c},{kvh},{d}]")
    valid = torch.zeros((N_STAGES, slots), dtype=torch.bool, device=dev)
    for s in range(N_STAGES):           # stage s at phase s: min(s, 6) slots
        valid[s, :min(s, slots)] = True
    n_valid = int(valid.sum().item())
    k2_err = 0.0
    for name, dt in floats:
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
            kv_read = 2.0 * n_valid * BATCH * c * kvh * d * k.element_size()
            ops_n = 4.0 * d * n_valid * BATCH * h * c * c
            b_ms, by = bound_ms(nbytes(q, valid, *got) + kv_read, ops_n, name)
            record("pool_attention", ms=ms, plain_ms=plain, library_ms=None,
                   bound_ms=b_ms, bound_by=by)
            log(f"  time: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                f"bound {b_ms:.4f} ms ({by}), {n_valid} valid (stage, slot)")
        del k, v
    q = randn(gb, c, h, d, dtype=torch.bfloat16)
    for kind in kinds:
        kq, ks = quantize(randn(slots, gb, c, kvh, d), kind, (2, 4))
        vq, vs = quantize(randn(slots, gb, c, kvh, d), kind, (2, 4))
        ks = ks.expand(slots, gb, c, kvh, 1)[..., 0].contiguous()
        vs = vs.expand(slots, gb, c, kvh, 1)[..., 0].contiguous()
        got = ops.pool_attention(q, kq, vq, valid, k_scale=ks, v_scale=vs)
        want = ref.pool_attention_plain(q, kq, vq, valid, k_scale=ks, v_scale=vs)
        k2_err = max(k2_err, compare(f"pool {kind} pages", got, want, kind))
    k2 = results["pool_attention"]
    k2["max_abs_err"] = max(k2.get("max_abs_err", 0.0), k2_err)

    # ---------------- K3: pages read in place from a strided stage-stacked pool
    npages, lps = slots + 1, 2
    log(f"[kernels] K3 pool_attention_paged  layer view of a "
        f"[{N_STAGES},{npages},{lps},{BATCH},{c},{kvh},{d}] pool")
    k3_err = 0.0
    handles = torch.arange(slots, dtype=torch.int32, device=dev)
    for name, dt in floats:
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
            kv_read = 2.0 * n_valid * BATCH * c * kvh * d * kp.element_size()
            ops_n = 4.0 * d * n_valid * BATCH * h * c * c
            b_ms, by = bound_ms(nbytes(q, valid, handles, *got) + kv_read, ops_n, name)
            record("pool_attention_paged", ms=ms, plain_ms=plain, library_ms=None,
                   bound_ms=b_ms, bound_by=by)
            log(f"  time: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                f"bound {b_ms:.4f} ms ({by})")
        del kp, vp
    # quantized pages with per-page scales read through the same handles
    q = randn(gb, c, h, d, dtype=torch.bfloat16)
    for kind in kinds:
        kp, ksp = quantize(randn(N_STAGES, npages, lps, BATCH, c, kvh, d), kind, (4, 6))
        vp, vsp = quantize(randn(N_STAGES, npages, lps, BATCH, c, kvh, d), kind, (4, 6))
        args = (q, kp[:, :, 0], vp[:, :, 0], handles, valid)
        kw = dict(ppc=1, k_scale=ksp[:, :, 0], v_scale=vsp[:, :, 0])
        got = ops.pool_attention_paged(*args, **kw)
        want = ref.pool_attention_paged_plain(*args, **kw)
        k3_err = max(k3_err, compare(f"paged {kind} pages", got, want, kind))
    if full:
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
    k3 = results["pool_attention_paged"]
    k3["max_abs_err"] = max(k3.get("max_abs_err", 0.0), k3_err)


# (heads H, head dim P, state N) of the SSD scan at each model's serve shape
SSD_SHAPES = {"zamba2-7b": (112, 64, 64), "mamba2-130m": (24, 64, 128)}
SSD_CHUNK = 256                    # both models' ssm.chunk_size


def ssd_inputs(gen, rows: int, t: int, h: int, p: int, g: int, n: int, dtype):
    """Random SSD inputs with the model's distributions: dt log-uniform in
    [1e-3, 1e-1] per head (``init_block``'s dt_bias) times a log-normal
    factor, A = -(1..H) with one a_log row per stage (Gs = 8), d_skip near
    1, B and C unit-variance, a non-zero fp32 init_state."""
    import math
    import torch
    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    u = torch.rand((h,), generator=gen, device=dev)
    dt_head = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt = (dt_head * torch.exp(0.5 * randn(rows, t, h))).contiguous()
    a_log = torch.log(torch.arange(1, h + 1, device=dev, dtype=torch.float32))[None] \
        + 0.1 * randn(N_STAGES, h)
    d_skip = 1.0 + 0.1 * randn(N_STAGES, h)
    return (randn(rows, t, h, p).to(dtype), dt, a_log, randn(rows, t, g, n).to(dtype),
            randn(rows, t, g, n).to(dtype), d_skip, 0.1 * randn(rows, h, p, n))


def ssd_phase(results: dict) -> None:
    """K4 against ``ssd_plain`` at both models' serve shapes (16 rows =
    8 stages x batch 2, T = 512, chunk 256), bf16 and fp32, non-zero
    init_state, Gs = 8; then G = 2 < H without an init_state. Times kernel
    and plain version at zamba2-7b's shape (the main path of the two) and
    mamba2-130m's, in bf16."""
    import torch
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(2)
    rows, t = N_STAGES * BATCH, CHUNK
    err = 0.0
    labels = ("y", "state")
    for arch, (h, p, n) in SSD_SHAPES.items():
        for name, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            log(f"[kernels] K4 ssd {arch} {name}  x [{rows},{t},{h},{p}], "
                f"b/c [{rows},{t},1,{n}], Gs {N_STAGES}, init_state")
            args = ssd_inputs(gen, rows, t, h, p, 1, n, dt)
            *xs, init = args
            got = ops.ssd(*xs, chunk=SSD_CHUNK, init_state=init)
            want = ref.ssd_plain(*xs, chunk=SSD_CHUNK, init_state=init)
            torch.cuda.synchronize()
            err = max(err, compare(f"ssd {arch} {name}", got, want, name, labels))
            if name != "bfloat16":
                continue
            ms = time_ms(lambda: ops.ssd(*xs, chunk=SSD_CHUNK, init_state=init))
            plain = time_ms(lambda: ref.ssd_plain(*xs, chunk=SSD_CHUNK, init_state=init))
            tri = SSD_CHUNK * (SSD_CHUNK + 1) / 2
            per_chunk = 2.0 * tri * (n + p) + 4.0 * SSD_CHUNK * p * n
            ops_n = per_chunk * rows * h * (t // SSD_CHUNK)
            b_ms, by = bound_ms(nbytes(*args, *got), ops_n, name)
            times = dict(ms=ms, plain_ms=plain, library_ms=None, bound_ms=b_ms,
                         bound_by=by)
            if arch == "zamba2-7b":
                results.setdefault("ssd", {}).update(times)
            else:
                results.setdefault("ssd", {})[arch] = times
            log(f"  time: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                f"bound {b_ms:.4f} ms ({by}), {ops_n / 1e9:.1f} GFLOP")
    h, p, n = SSD_SHAPES["zamba2-7b"]
    log(f"[kernels] K4 ssd G = 2 < H = {h}, no init_state, fp32")
    *xs, _ = ssd_inputs(gen, rows, t, h, p, 2, n, torch.float32)
    got = ops.ssd(*xs, chunk=SSD_CHUNK)
    want = ref.ssd_plain(*xs, chunk=SSD_CHUNK)
    err = max(err, compare("ssd G=2", got, want, "float32", labels))
    results["ssd"]["max_abs_err"] = err


def kernel_phase(results: dict) -> None:
    attention_phase(results, h=32, kvh=8, d=128, full=True)     # qwen3-8b
    attention_phase(results, h=32, kvh=32, d=112, full=False)   # zamba2-7b
    ssd_phase(results)


# ------------------------------------------------------------ smoke parity

SMOKE_CASES = [   # (arch, remote_attn, pool_backend, kv_dtype)
    ("qwen3-8b", "qship", "cuda", "auto"), ("qwen3-8b", "fetch", "paged", "auto"),
    ("qwen3-8b", "fetch", "cuda", "int8"), ("qwen3-8b", "qship", "paged", "fp8"),
    ("zamba2-7b", "qship", "cuda", "auto"), ("zamba2-7b", "fetch", "paged", "auto"),
    ("zamba2-7b", "qship", "cuda", "int8"), ("mamba2-130m", "qship", "cuda", "auto"),
]


def smoke_parity_phase() -> None:
    """The small configs in fp32: kernel backends (K4 for the SSD) on the
    card against the same pipeline on the CPU (whose wrappers take the
    plain versions); mamba2-130m runs terapipe (no MBKR: attention-free)."""
    import numpy as np
    import torch
    from repro_torch.configs import RunConfig, get_smoke_config, replace
    from repro_torch.core import pipeline as pp
    from repro_torch.core.staging import init_staged

    seq = 8 * 16
    log("[smoke parity] smoke configs, fp32, N=8 M=8 C=16 B=2")
    for arch, remote, pool_be, kv in SMOKE_CASES:
        cfg = replace(get_smoke_config(arch), dtype="float32")
        tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, seq))
        run = RunConfig(num_chunks=8, num_stages=8, mbkr=not cfg.attn_free,
                        remote_attn=remote, attn_backend="cuda",
                        pool_backend=pool_be, kv_dtype=kv, ssm_backend="cuda")
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
        name = f"{arch} {plan.mode} {remote}/{pool_be}/{kv}"
        log(f"  {name}: rel err card vs cpu max {rel.max().item():.3e}, p99 {p99:.3e}")
        check(bool(torch.isfinite(got).all()), f"smoke parity {name}: non-finite logits")
        if kv == "auto":
            check(rel.max().item() < 1e-3, f"smoke parity {name}: "
                  f"max rel err {rel.max().item()}")
        else:
            # 1-byte pages: a last-bit difference in the fp32 activations
            # can move a stored value by one code (1/8 of it for fp8), so
            # hold the tail and the argmax, as the CPU tests do for int8
            check(p99 < 1e-2 and bool((got.argmax(-1) == cpu.argmax(-1)).all()),
                  f"smoke parity {name}: p99 rel err {p99}")
        check(led == led_cpu, f"smoke parity {name}: ledgers differ between card and cpu")


# ------------------------------------------------------------------- serve

# one entry per model served at full width and depth: its kernel
# combinations (remote_attn, attn_backend, pool_backend, kv_dtype; the SSD
# runs K4), the kernels its main path must launch, and which wrapper the
# planted faults replace
SERVE_MODELS = {
    "qwen3-8b": dict(
        combos=[("qship", "cuda", "cuda", "auto"), ("qship", "cuda", "paged", "auto"),
                ("fetch", "cuda", "cuda", "auto"), ("fetch", "cuda", "paged", "auto"),
                ("qship", "cuda", "cuda", "int8")],
        kernels=("chunk_attention", "pool_attention", "pool_attention_paged"),
        faults="pool_attention"),
    "zamba2-7b": dict(
        combos=[("qship", "cuda", "cuda", "auto"), ("fetch", "cuda", "paged", "auto"),
                ("qship", "cuda", "cuda", "int8")],
        kernels=("chunk_attention", "pool_attention", "pool_attention_paged", "ssd"),
        faults="ssd"),
    "mamba2-130m": dict(
        combos=[("qship", "cuda", "cuda", "auto")],
        kernels=("ssd",), faults="ssd"),
}
# serve checks, as fractions of the reference's max|logit|: a bf16 kernel
# combination against the witness, the cuda pool (K2) against the paged
# pool (K3) under the same remote mode in bf16, and an fp32 combination
# against the torch backends (per model: mamba2-130m's fp32 logits depend on
# the carried SSD state by ~1e-3 of max|logit|, so its limit sits lower)
BF16_LOGIT_TOL = {"qwen3-8b": 0.1, "zamba2-7b": 0.1, "mamba2-130m": 0.1}
BF16_POOL_PAIR_TOL = 1e-3
FP32_LOGIT_TOL = {"qwen3-8b": 1e-3, "zamba2-7b": 1e-3, "mamba2-130m": 1e-4}


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


def planted_faults(kind: str, real):
    """Wrong versions of the wrapper ``real`` (``ops.pool_attention``, K2,
    or ``ops.ssd``, K4), for showing that the serve checks (bf16 and fp32)
    fail a wrong kernel."""
    import torch
    from repro_torch.kernels import ops

    if kind == "pool_attention":
        def acc_zero(*args, **kw):
            m, l, acc = real(*args, **kw)
            return m, l, torch.zeros_like(acc)

        def last_slot_dropped(q, k, v, valid, **kw):
            last = valid & (valid.cumsum(1) == valid.sum(1, keepdim=True))
            return real(q, k, v, valid & ~last, **kw)

        return {"K2 returns acc = 0": acc_zero,
                "K2 skips the last valid slot": last_slot_dropped}

    def state_not_carried(x, dt, a_log, b, c, d_skip, *, chunk, init_state=None):
        # every chunk of the scan starts from the call's init_state
        ck = ops.ssd_chunk(x.shape[1], chunk)
        ys, st = [], None
        for c0 in range(0, x.shape[1], ck):
            sl = slice(c0, c0 + ck)
            y, st = real(x[:, sl].contiguous(), dt[:, sl].contiguous(), a_log,
                         b[:, sl].contiguous(), c[:, sl].contiguous(), d_skip,
                         chunk=ck, init_state=init_state)
            ys.append(y)
        return torch.cat(ys, dim=1), st

    def init_ignored(*args, init_state=None, **kw):
        return real(*args, **kw)

    return {"K4 does not carry the state across chunks": state_not_carried,
            "K4 ignores init_state": init_ignored}


def shadowed(fn, worst: list):
    """``fn`` (the K4 wrapper or a planted fault) in its place on the serve
    path, every call also held against ``ssd_plain`` on the same inputs:
    ``worst[0]`` keeps the largest error of y or the state as a multiple of
    its tolerance (``tolerance``: 2e-2 of max|ref| for bf16 y, 1e-3 for the
    fp32 state of bf16 inputs)."""
    import torch
    from repro_torch.kernels import ops, ref

    def call(x, dt, a_log, b, c, d_skip, *, chunk, init_state=None):
        got = fn(x, dt, a_log, b, c, d_skip, chunk=chunk, init_state=init_state)
        want = ref.ssd_plain(x, dt, a_log, b, c, d_skip,
                             chunk=ops.ssd_chunk(x.shape[1], chunk),
                             init_state=init_state)
        in_dtype = "float32" if x.dtype == torch.float32 else "bfloat16"
        for g, r in zip(got, want):
            err = (g.float() - r.float()).abs().max().item()
            scale = max(r.float().abs().max().item(), 1e-30)
            worst[0] = max(worst[0], err / (tolerance(r.dtype, in_dtype) * scale))
        return got
    return call


def serve_model(arch: str, results: dict) -> None:
    """One model at full width and depth through PrefillEngine +
    TorchExecutor.

    bf16, the model's main path: the launch counters are set to 0 just
    before its kernel combinations and read just after; every kernel of the
    path must have launched. Each combination is held against a witness on
    the same pages (auto / int8): the ``torch`` attention backend with p in
    fp32 (``p32_witness``) and the ``torch`` SSD, by the logits' max abs
    error, at most BF16_LOGIT_TOL[arch] of max|logit|. Argmax is reported,
    not held: in bf16 a last-bit difference in fp32 flips the rounding of a
    few activations, every residual update carries it to the logits, and a
    request whose top two logits lie closer than that may take either. For
    qwen3-8b the K2 and K3 pools must agree to BF16_POOL_PAIR_TOL, and the
    ``torch`` backend itself (p rounded to bf16 before PV, as the
    reference's JnpBackend) is reported beside. Each planted K2 fault must
    break the bf16 limit, which shows that it separates a wrong kernel. The
    planted K4 faults change what the last token sees only through the few
    heads whose memory outlasts a chunk (A = -(1..H) at init), by less than
    the bf16 spread between any two summation orders, so no logits limit
    separates them in bf16 (their logits errors are reported): there one
    more bf16 serve run holds every K4 launch of the path against
    ``ssd_plain`` on its own inputs (``shadowed``), which the real kernel
    must pass and each fault must break.
    fp32 (same geometry, weights drawn in fp32): summation order is the
    only difference left, so every combination's argmax must equal the
    ``torch`` backends' on the same pages, with the logits within
    FP32_LOGIT_TOL[arch]; both planted faults must break that."""
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

    spec = SERVE_MODELS[arch]
    cfg = get_config(arch)
    seq = N_CHUNKS * CHUNK
    base = RunConfig(num_chunks=N_CHUNKS, num_stages=N_STAGES, mbkr=not cfg.attn_free)
    plan = pp.build_plan(cfg, N_STAGES, seq, base)
    log(f"[serve] {arch} d={cfg.d_model} layers={cfg.num_layers} mode={plan.mode} "
        f"lps={plan.layers_per_stage} N={N_STAGES} M={N_CHUNKS} C={CHUNK} "
        f"slots={plan.num_slots} p2={plan.p2} host_slots_used="
        f"{plan.host_slots_used.tolist()} ticks={plan.num_ticks}")
    if not cfg.attn_free:
        check(plan.p2 < N_CHUNKS - 1, "the plan has no remote chunk to attend to")
    kvs = sorted({combo[3] for combo in spec["combos"]})

    def weights(model_cfg):
        t0 = time.perf_counter()
        gen = torch.Generator(device="cuda").manual_seed(0)
        staged = init_staged(model_cfg, plan, gen, device="cuda")
        torch.cuda.synchronize()
        log(f"  {model_cfg.dtype} weights: {time.perf_counter() - t0:.2f} s, "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
        return staged

    def serve(model_cfg, staged, remote: str, attn: str, pool: str, kv: str,
              ssm: str = "cuda"):
        run = RunConfig(num_chunks=N_CHUNKS, num_stages=N_STAGES,
                        mbkr=not model_cfg.attn_free, remote_attn=remote,
                        attn_backend=attn, pool_backend=pool, kv_dtype=kv,
                        ssm_backend=ssm)
        ex = TorchExecutor(model_cfg, staged, run, device="cuda")
        eng = PrefillEngine(EngineConfig(model=model_cfg, num_stages=N_STAGES,
                                         num_chunks=N_CHUNKS, max_batch=BATCH,
                                         buckets=(seq,)), ex)
        for r in make_requests(REQUESTS, seq, model_cfg.vocab_size, seed=0):
            eng.submit(r)
        eng.run_until_drained()
        done = sorted(eng.done, key=lambda r: r.rid)
        name = f"{arch} {model_cfg.dtype} {remote}/{attn}/{pool}/{kv}" + \
            ("" if model_cfg.family == "dense" else f"/ssd {ssm}")
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

    def passes(model_cfg, err: float, same: int) -> bool:
        if model_cfg.dtype == "float32":
            return same == REQUESTS and err < FP32_LOGIT_TOL[arch]
        return err <= BF16_LOGIT_TOL[arch]

    failures = []

    def hold(model_cfg, logits, want, what: str, name: str) -> None:
        _, err, same = against(logits, want, what)
        if not passes(model_cfg, err, same):
            failures.append(f"{arch} {model_cfg.dtype} {name}: argmax equal {same}, "
                            f"logits err {err} vs the {what}")

    def planted(model_cfg, staged, want, what: str) -> None:
        combo, kind = spec["combos"][0], spec["faults"]
        real = getattr(ops, kind)
        per_launch = kind == "ssd" and model_cfg.dtype == "bfloat16"
        runs = [(name, fn, True) for name, fn in planted_faults(kind, real).items()]
        if per_launch:
            runs.insert(0, ("none (the kernel itself)", real, False))
        for fault, fn, is_fault in runs:
            worst = [0.0]
            with swapped(ops, kind, shadowed(fn, worst) if per_launch else fn):
                logits, _ = serve(model_cfg, staged, *combo)
            log(f"  planted fault: {fault}")
            _, err, same = against(logits, want, what)
            if per_launch:
                log(f"    every K4 launch vs ssd_plain on its inputs: worst "
                    f"{worst[0]:.3e} of its tolerance")
                if (worst[0] > 1.0) != is_fault:
                    failures.append(f"{arch} bf16 per-launch K4 check, planted fault "
                                    f"'{fault}': {worst[0]} of the tolerance")
            elif passes(model_cfg, err, same):
                failures.append(f"{arch} {model_cfg.dtype}: planted fault '{fault}' "
                                f"passes the check ({err})")

    # ---- bf16, the main path: the launch counts are read around it
    staged = weights(cfg)
    with swapped(attention, "_BACKENDS",
                 dict(attention._BACKENDS, torch=p32_witness())):
        witness = {kv: serve(cfg, staged, "qship", "torch", "torch", kv, "torch")[0]
                   for kv in kvs}
    log(f"  (the runs above: witness) top-2 margin of max|logit| per "
        f"request: {margins(witness['auto'])}")
    torch_be = None
    if arch == "qwen3-8b":
        torch_be, _ = serve(cfg, staged, "qship", "torch", "torch", "auto")
    ops.reset_launches()
    bf16 = {combo: serve(cfg, staged, *combo)[0] for combo in spec["combos"]}
    launches = dict(ops.LAUNCHES)
    log(f"  launches on the {arch} main path: {launches}")
    for name in spec["kernels"]:
        check(launches[name] > 0, f"kernel {name} was not launched on the {arch} main path")
        results[name].setdefault("launches_by_path", {})[arch] = launches[name]
    for combo, logits in bf16.items():
        log(f"  bf16 {'/'.join(combo)}")
        hold(cfg, logits, witness[combo[3]], "witness", "/".join(combo))
        if torch_be is not None and combo[3] == "auto":
            against(logits, torch_be, "torch backend")
    for remote in ("qship", "fetch"):
        pair = [bf16.get((remote, "cuda", pool, "auto")) for pool in ("cuda", "paged")]
        if pair[0] is None or pair[1] is None:
            continue
        log(f"  bf16 {remote}: cuda pool (K2) against paged pool (K3)")
        _, err, _ = against(pair[0], pair[1], "paged pool")
        if err > BF16_POOL_PAIR_TOL:
            failures.append(f"bf16 {remote}: K2 and K3 pools differ by {err}")
    planted(cfg, staged, witness["auto"], "witness")
    del staged, witness, torch_be, bf16
    torch.cuda.empty_cache()

    # ---- fp32: the argmax of every request, every combination
    cfg32 = replace(cfg, dtype="float32")
    staged = weights(cfg32)
    refs = {kv: serve(cfg32, staged, "qship", "torch", "torch", kv, "torch")[0]
            for kv in kvs}
    for combo in spec["combos"]:
        logits, _ = serve(cfg32, staged, *combo)
        hold(cfg32, logits, refs[combo[3]], "torch backends", "/".join(combo))
    planted(cfg32, staged, refs["auto"], "torch backends")
    del staged
    torch.cuda.empty_cache()
    check(not failures, "; ".join(failures))


def serve_phase(results: dict) -> None:
    for arch in SERVE_MODELS:
        t0 = time.perf_counter()
        serve_model(arch, results)
        log(f"[serve] {arch} {time.perf_counter() - t0:.1f} s")
    for r in results.values():
        r["launches"] = sum(r.get("launches_by_path", {}).values())


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
        source, tpu = KERNELS[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": tpu, "tpu_kernel": tpu,
            "launches": r["launches"], "launches_by_path": r["launches_by_path"],
            "max_abs_err": r["max_abs_err"], "max_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            **{k: v for k, v in r.items() if isinstance(v, dict)
               and k != "launches_by_path"}})
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
