#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA card.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases, each of which raises on failure (the script then exits non-zero and
prints no result line):

1. card: prints the card's name and power limit (nvidia-smi), turns TF32 off;
2. build: compiles every ``src/repro_torch/csrc/*.cu`` with nvcc (one
   process per library, all at once), timed, with each library's
   registers and spills, and each instance's of the tensor-core bodies
   (K1-K3, K4) and of K5;
3. kernels: holds each CUDA kernel against its plain PyTorch version on the
   card, each output tensor at its own scale (see ``compare``), and times
   kernel, plain version and, where one exists, a PyTorch call computing
   the same function (never used by the port):
   - K1 chunk attention, K2 pool attention, K3 paged pool attention at
     qwen3-8b's shapes (head dim 128, GQA) in bf16 and fp32 with bf16/fp32,
     int8 and fp8 pages, at zamba2-7b's shared-block shape (head dim
     112, MHA) in bf16 with bf16, int8 and fp8 pages, and at granite-3-2b's
     (head dim 64, G 4), granite-moe-3b-a800m's (64, G 3) and
     stablelm-3b's (80, MHA) in bf16 and fp32 with the same pages (at
     d 80 also three planted faults in the tensor-core body, compiled from
     edited copies of the sources: two in the columns 64-79 of the padded
     box, which must break the check, and garbage in its pad, reported);
     at every head dim the tensor-core body (bf16 q) is also held, for K1,
     with a prefix offset and kv_len < T (T no multiple of the 64-key tile,
     bf16 and quantized pages) and on a ragged chunk of 500 queries whose
     first rows see no key, and, for K2, with kv_len < T (T no multiple of
     64, the keys and values past kv_len poisoned; bf16, int8, fp8) and on
     a stack of 32 slots with one group at every slot valid, and, for K3,
     with int8 and fp8 pages and with shuffled handles to pages of 128 and
     of 16 tokens (a tile within a page; four pages a tile) and a partial
     last page (bf16, int8; fp32 through the CUDA-core body); every K2 and
     K3 case has an all-invalid group, which must come out exactly (-1e30,
     0, 0); K1's, K2's and K3's bf16 times are also read from a
     torch.profiler trace and from windows of back-to-back calls;
   - K1 at the GPipe baseline's shape: 8 rows of a whole 4096-token
     sequence against itself (C = T = 4096, causal offset 0), qwen3-8b's
     heads, bf16, held against the plain version on 2 rows, each query row
     at its own scale, which two planted K1 faults must break, and timed
     beside SDPA's causal time (``k1_gpipe_shape``);
   - K4 the Mamba2 SSD scan at zamba2-7b's and mamba2-130m's shapes in
     bf16 and fp32, with a non-zero init_state, one a_log / d_skip row per
     stage (Gs = 8), x, b and c dense and as strided views of one
     conv-output buffer (the layout the Mamba2 block hands over), and a
     case with G < H SSM groups; the bf16 time also in windows and from a
     torch.profiler trace, which must show the tensor-core body;
   - K5 flash-decode at qwen3-8b's (GQA, head dim 128) and zamba2-7b's (MHA,
     head dim 112) decode shapes, 8 rows over a 32768-token cache, bf16 and
     fp32, timed with every row at full length (also in windows and from a
     torch.profiler trace) and held at ragged lengths (0, 1, ..., S) and at
     lengths 100x apart, with the tail past each length poisoned;
4. smoke parity: the small qwen3-8b, zamba2-7b, mamba2-130m, granite-3-2b,
   stablelm-3b, qwen2-moe-a2.7b and granite-moe-3b-a800m configs in fp32
   through the kernel backends on the card against the same pipeline on
   the CPU (plain versions);
5. serve: each model at full width and depth (random weights from a seeded
   generator) through ``PrefillEngine`` + ``TorchExecutor``: N=8 stages,
   M=8 chunks of 512 tokens, 2 requests a wave, 4 requests. qwen3-8b
   (36 layers) under qship/fetch x cuda/paged pools plus one int8-page run;
   zamba2-7b (81 layers) under qship/cuda, fetch/paged and one int8-page
   run; mamba2-130m (24 layers) under terapipe; granite-3-2b (40 layers)
   under qship/cuda, fetch/paged and qship/cuda int8; stablelm-3b (32)
   under terapipe fetch/cuda and mocap qship/paged; qwen2-moe-a2.7b (24;
   its fp32 runs cut to 8 layers, one a stage: 24 layers of fp32 experts
   are ~57 GB) and granite-moe-3b-a800m (32) under two of qship/fetch x
   cuda/paged. Each model's bf16 runs are
   its main path: the kernels' launch counters are set to 0 just before
   them and read just after, and every kernel of the path must have
   launched. Then one more bf16 qship/cuda wave of the model runs under
   torch.profiler (not for stablelm-3b and granite-moe-3b-a800m): its
   device time by kernel (K1, K2, K4, matmuls, the MoE dispatch, page
   gathers and scatters, the rest) and the device's idle share
   (``wave_split``); every K4 launch in it must be the tensor-core body.
   In bf16 the logits are held against a witness that keeps p in
   fp32 as the kernels do (and the ``torch`` SSD), at a limit that two
   planted kernel faults must break (K2 faults for qwen3-8b and
   stablelm-3b), or, where no bf16 limit separates them, every launch of
   the kernel held against its plain version, which the faults must break
   (K4 faults for zamba2-7b and mamba2-130m; K1-K3 with K2 faults for the
   MoE models, whose router flips experts near ties under any change of
   summation order, and for granite-3-2b, whose logits hardly see
   attention; the bf16 spread and the router choices that differ are
   reported); in fp32 every request's argmax must equal the ``torch``
   backends' (qwen2-moe-a2.7b's fp32 runs at 8 layers, one a stage: its
   24 fp32 layers of experts would not fit; see ``serve_model``);
6. decode: each model at full width and depth through ``Model.forward(
   return_cache=True)`` on a 512-token prompt, the KV axis padded by 8, and
   8 ``Model.decode_step``s (the decode path's K5 launches counted, exactly
   36 a step for qwen3-8b, 13 for zamba2-7b, 0 for mamba2-130m): fp32 logits
   against ``forward`` on the longer sequence, bf16 logits against bf16
   ``forward`` and against the same decode with K5's plain version; two
   planted K5 faults must break the fp32 limit and a per-launch check of K5
   against its plain version. Then
   long-context decode in bf16 (qwen3-8b, zamba2-7b): 4 rows at ragged
   positions in a 32768-token cache, 16 steps with K5, with its plain
   version, and with every K5 launch held against the plain version, which
   both planted faults must break by 10x (see ``decode_phase``);
7. baselines + continuous: qwen3-8b at full width and depth in bf16, the
   same 8 requests through MOCAP and terapipe (``PrefillEngine``), the GPipe
   baseline (``build_plan(mode="gpipe")``, M = 8, through
   ``prefill_pipeline``; K1 exactly layers_per_stage x (M + N - 1) times)
   and ``ContinuousEngine`` (EDF, an SLO, Poisson arrivals, waves of 2;
   K1 and K2): logits against MOCAP's (GPipe's argmax held where MOCAP's
   top-2 margin is above the measured bf16 spread), planted K1 faults, the waves in
   admission order, the four paths' wall times; then GPipe in fp32 against
   the ``torch`` backends (see ``baselines_phase``).

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
import warnings
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
    "decode_attention": ("src/repro_torch/csrc/decode_attn.cu",
                         "src/repro/kernels/decode_attn.py:65"),
}
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}

# serve-phase geometry; the kernel phases use the same shapes
N_STAGES, N_CHUNKS, CHUNK, BATCH, REQUESTS = 8, 8, 512, 2, 4
RAGGED_CHUNK = 500                 # K1's ragged query edge (not a multiple of 64)
# the baselines phase: 8 requests; GPipe over M = 8 microbatches of bm rows,
# K1 held against its plain version on GP_HELD rows of a tick's launch
GP_REQUESTS, GP_BM, GP_HELD = 8, 1, 2
K1_KINDS = ("int8", "fp8")         # K1's quantized pages, at every head dim


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


def windowed_ms(fn, iters: int = 12, warmup: int = 2, window_ms: float = 1.0) -> float:
    """Median device time of one call, CUDA events around each of ``iters``
    windows of back-to-back calls (as many as make a window last
    ``window_ms``, at most 20), each window entered with one call already in
    flight, so that the host's time to issue a call hides under the device's
    work. ``time_ms`` times one call from an idle card, which also counts
    that issue time; this reading is kept beside it, never in its place."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    calls = max(1, min(20, int(window_ms / max(a.elapsed_time(b), 1e-3))))
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        fn()
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def profiled_ms(fn, kernel: str, calls: int = 20):
    """The device time of one launch of the CUDA kernel whose name holds
    ``kernel``, from a ``torch.profiler`` trace of ``calls`` calls of
    ``fn``: (ms, launches seen); (None, 0) if the trace holds no device
    time for it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if kernel in e.key]
    us = sum(getattr(e, "device_time_total", 0.0) for e in events)
    n = sum(e.count for e in events)
    return (us / 1e3 / n, n) if n and us else (None, 0)


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


def poison(x, start: int, sign: int) -> None:
    """Sets the positions at and past ``start`` of axis 2 of ``x`` (bf16,
    or int8 / fp8 payloads) to the largest value of that sign: 1e4, or the
    payload's largest code."""
    import torch
    if x.dtype == torch.float8_e4m3fn:           # 0x7e / 0xfe: +-448
        x.view(torch.uint8)[:, :, start:] = 0x7E if sign > 0 else 0xFE
    elif x.dtype == torch.int8:
        x[:, :, start:] = 127 * sign
    else:
        x[:, :, start:] = 1e4 * sign


def pool_case(label: str, kind: str, kernel, plain, *args, **kw):
    """A pool kernel (K2 or K3) against its plain version on the same
    inputs (``compare``), whose ``valid`` (the last positional argument)
    leaves group 0 without a valid slot: its rows must come out exactly
    (-1e30, 0, 0). Returns (the kernel's state, its largest error)."""
    got = kernel(*args, **kw)
    err = compare(label, got, plain(*args, **kw), kind)
    m, l, acc = got
    check(not bool(args[-1][0].any()), f"{label}: group 0 has a valid slot")
    check(bool((m[:BATCH] == -1e30).all() and (l[:BATCH] == 0).all()
               and (acc[:BATCH] == 0).all()),
          f"{label}: an all-invalid group is not exactly (-1e30, 0, 0)")
    return got, err


def attention_phase(results: dict, h: int, kvh: int, d: int, key=None,
                    fp32: bool = True) -> None:
    """K1-K3 at one model's attention shape: q [16, 512, h, d] (8 stages x
    batch 2 folded into the rows), k/v with kvh heads. ``key`` None
    (qwen3-8b, d 128) records the kernels' main times; otherwise the times
    go under ``results[kernel][key]`` (zamba2-7b "d112"; granite-3-2b
    "d64", granite-moe-3b-a800m "d64_g3", stablelm-3b "d80",
    qwen2-moe-a2.7b "d128_mha"). ``fp32``
    also runs fp32 q with fp32 pages (the CUDA-core body) and K3's fp32
    pages of 128 tokens. At every shape, int8 and fp8 pages, and the
    tensor-core body (bf16 q) where it can go wrong: K1 with a prefix and
    kv_len < T and a ragged chunk with empty rows; K2 with kv_len < T and a
    poisoned tail and a 32-slot stack; K3 with shuffled handles to pages of
    128 and 16 tokens and a partial last page. At d 80 the planted faults
    of ``pad_faults`` run too."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    gb, c = N_STAGES * BATCH, CHUNK
    floats = (("bfloat16", torch.bfloat16), ("float32", torch.float32)) if fp32 \
        else (("bfloat16", torch.bfloat16),)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def record(name: str, **times) -> None:
        if key is None:
            results.setdefault(name, {}).update(times)
        else:
            results.setdefault(name, {})[key] = dict(heads=h, kv_heads=kvh, head_dim=d,
                                                     **times)

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
            call = lambda: ops.chunk_attention(q, k, v, return_state=True)
            ms, win_ms = time_ms(call), windowed_ms(call)
            prof_ms, seen = profiled_ms(call, "ChunkWalk")
            log(f"  torch.profiler: attn_tc_kernel<ChunkWalk> {seen} launches, "
                + (f"{prof_ms:.4f} ms device time each" if seen else "no device time seen"))
            plain = time_ms(lambda: ref.chunk_attention_plain(q, k, v))
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True))
            pairs = gb * h * c * (c + 1) / 2
            b_ms, by = bound_ms(nbytes(q, k, v, *got), 4.0 * d * pairs, name)
            record("chunk_attention", ms=ms, windowed_ms=win_ms, profiler_ms=prof_ms,
                   plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=by)
            log(f"  time: kernel {ms:.4f} ms ({win_ms:.4f} ms a call in windows of "
                f"back-to-back calls), plain {plain:.4f} ms, "
                f"sdpa {lib:.4f} ms, bound {b_ms:.4f} ms ({by})")
    # stored-chunk blocks with quantized pages (full visibility: offset T)
    q = randn(gb, c, h, d, dtype=torch.bfloat16)
    for kind in K1_KINDS:
        kq, ks = quantize(randn(gb, c, kvh, d), kind, (1, 3))
        vq, vs = quantize(randn(gb, c, kvh, d), kind, (1, 3))
        ks = ks.expand(gb, c, kvh, 1)[..., 0].contiguous()
        vs = vs.expand(gb, c, kvh, 1)[..., 0].contiguous()
        got = ops.chunk_attention(q, kq, vq, causal_offset=c, return_state=True,
                                  k_scale=ks, v_scale=vs)
        want = ref.chunk_attention_plain(q, kq, vq, causal_offset=c,
                                         k_scale=ks, v_scale=vs)
        k1_err = max(k1_err, compare(f"chunk block {kind} pages", got, want, kind))
    if fp32:
        # a prefix offset with padded keys: kv_len < T
        q, k, v = randn(gb, c, h, d), randn(gb, 2 * c, kvh, d), randn(gb, 2 * c, kvh, d)
        kv_len = 2 * c - c // 3
        got = ops.chunk_attention(q, k, v, causal_offset=c, kv_len=kv_len,
                                  return_state=True)
        want = ref.chunk_attention_plain(q, k, v, causal_offset=c, kv_len=kv_len)
        k1_err = max(k1_err, compare(f"offset {c}, kv_len {kv_len} < T fp32", got,
                                     want, "float32"))
    # the tensor-core body (bf16 q) where it can go wrong: a prefix offset
    # with kv_len < T and T not a multiple of the 64-key tile; a ragged chunk
    # of 500 queries whose first rows see no key (offset -5: the sentinel)
    bf16 = torch.bfloat16
    t_pre = 2 * c - 37
    kv_len = t_pre - c // 3
    q, k, v = randn(gb, c, h, d, dtype=bf16), randn(gb, t_pre, kvh, d, dtype=bf16), \
        randn(gb, t_pre, kvh, d, dtype=bf16)
    got = ops.chunk_attention(q, k, v, causal_offset=c, kv_len=kv_len, return_state=True)
    want = ref.chunk_attention_plain(q, k, v, causal_offset=c, kv_len=kv_len)
    k1_err = max(k1_err, compare(f"offset {c}, kv_len {kv_len} < T {t_pre} bfloat16",
                                 got, want, "bfloat16"))
    c_r = RAGGED_CHUNK
    q, k, v = randn(gb, c_r, h, d, dtype=bf16), randn(gb, c_r, kvh, d, dtype=bf16), \
        randn(gb, c_r, kvh, d, dtype=bf16)
    got = ops.chunk_attention(q, k, v, causal_offset=-5, return_state=True)
    want = ref.chunk_attention_plain(q, k, v, causal_offset=-5)
    check(bool((want[1][:, :, :5] == -1e30).all()), "the ragged case has no empty rows")
    k1_err = max(k1_err, compare(f"ragged chunk C {c_r}, offset -5 bfloat16", got, want,
                                 "bfloat16"))
    # quantized pages at every head dim, and a prefix of them with kv_len < T
    q = randn(gb, c, h, d, dtype=bf16)
    for kind in K1_KINDS:
        kq, ks = quantize(randn(gb, t_pre, kvh, d), kind, (1, 3))
        vq, vs = quantize(randn(gb, t_pre, kvh, d), kind, (1, 3))
        ks = ks.expand(gb, t_pre, kvh, 1)[..., 0].contiguous()
        vs = vs.expand(gb, t_pre, kvh, 1)[..., 0].contiguous()
        kw = dict(causal_offset=c, kv_len=kv_len, k_scale=ks, v_scale=vs)
        got = ops.chunk_attention(q, kq, vq, return_state=True, **kw)
        want = ref.chunk_attention_plain(q, kq, vq, **kw)
        k1_err = max(k1_err, compare(f"{kind} pages, kv_len {kv_len} < T {t_pre}", got,
                                     want, kind))
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
    k2_fns = (ops.pool_attention, ref.pool_attention_plain)

    for name, dt in floats:
        q = randn(gb, c, h, d, dtype=dt)
        k, v = randn(slots, gb, c, kvh, d, dtype=dt), randn(slots, gb, c, kvh, d, dtype=dt)
        got, err = pool_case(f"pool {name}", name, *k2_fns, q, k, v, valid)
        k2_err = max(k2_err, err)
        if name == "bfloat16":
            call = lambda: ops.pool_attention(q, k, v, valid)
            ms, win_ms = time_ms(call), windowed_ms(call)
            prof_ms, seen = profiled_ms(call, "StackWalk")
            log(f"  torch.profiler: attn_tc_kernel<StackWalk> {seen} launches, "
                + (f"{prof_ms:.4f} ms device time each" if seen else "no device time seen"))
            plain = time_ms(lambda: ref.pool_attention_plain(q, k, v, valid))
            kv_read = 2.0 * n_valid * BATCH * c * kvh * d * k.element_size()
            ops_n = 4.0 * d * n_valid * BATCH * h * c * c
            b_ms, by = bound_ms(nbytes(q, valid, *got) + kv_read, ops_n, name)
            record("pool_attention", ms=ms, windowed_ms=win_ms, profiler_ms=prof_ms,
                   plain_ms=plain, library_ms=None, bound_ms=b_ms, bound_by=by)
            log(f"  time: kernel {ms:.4f} ms ({win_ms:.4f} ms a call in windows of "
                f"back-to-back calls), plain {plain:.4f} ms, bound {b_ms:.4f} ms ({by}), "
                f"{n_valid} valid (stage, slot), {ops_n / 1e9:.1f} GFLOP")
        del k, v
    # the tensor-core body (bf16 q): int8 and fp8 pages; kv_len < T with T
    # no multiple of the 64-key tile and the keys and values past kv_len
    # poisoned (+-1e4); a long stack of 32 slots, one group with all valid
    bf16 = torch.bfloat16
    q = randn(gb, c, h, d, dtype=bf16)
    t_k2 = c - 37
    kv_k2 = t_k2 - 50
    for kind in ("bf16",) + K1_KINDS:
        if kind != "bf16":
            kq, ks = quantize(randn(slots, gb, c, kvh, d), kind, (2, 4))
            vq, vs = quantize(randn(slots, gb, c, kvh, d), kind, (2, 4))
            ks = ks.expand(slots, gb, c, kvh, 1)[..., 0].contiguous()
            vs = vs.expand(slots, gb, c, kvh, 1)[..., 0].contiguous()
            _, err = pool_case(f"pool {kind} pages", kind, *k2_fns, q, kq, vq, valid,
                               k_scale=ks, v_scale=vs)
            k2_err = max(k2_err, err)
        if kind == "bf16":
            k, v = (randn(slots, gb, t_k2, kvh, d, dtype=bf16) for _ in range(2))
            kw = dict(kv_len=kv_k2)
        else:
            k, ks = quantize(randn(slots, gb, t_k2, kvh, d), kind, (2, 4))
            v, vs = quantize(randn(slots, gb, t_k2, kvh, d), kind, (2, 4))
            ks = ks.expand(slots, gb, t_k2, kvh, 1)[..., 0].contiguous()
            vs = vs.expand(slots, gb, t_k2, kvh, 1)[..., 0].contiguous()
            ks[:, :, kv_k2:], vs[:, :, kv_k2:] = 1e4, 1e4
            kw = dict(kv_len=kv_k2, k_scale=ks, v_scale=vs)
        poison(k, kv_k2, 1)
        poison(v, kv_k2, -1)
        _, err = pool_case(f"pool {kind}, kv_len {kv_k2} < T {t_k2}, tail poisoned",
                           "bfloat16" if kind == "bf16" else kind, *k2_fns, q, k, v, valid,
                           **kw)
        k2_err = max(k2_err, err)
    long_s, c_long = 32, 128
    valid_long = torch.zeros((N_STAGES, long_s), dtype=torch.bool, device=dev)
    for s in range(N_STAGES):           # 0, 4, 9, ..., 32 valid slots
        valid_long[s, :long_s * s // (N_STAGES - 1)] = True
    k, v = randn(long_s, gb, c, kvh, d, dtype=bf16), randn(long_s, gb, c, kvh, d, dtype=bf16)
    _, err = pool_case(f"pool bf16, {long_s}-slot stack, C {c_long}", "bfloat16", *k2_fns,
                       randn(gb, c_long, h, d, dtype=bf16), k, v, valid_long)
    k2_err = max(k2_err, err)
    del k, v
    k2 = results["pool_attention"]
    k2["max_abs_err"] = max(k2.get("max_abs_err", 0.0), k2_err)

    # ---------------- K3: pages read in place from a strided stage-stacked pool
    npages, lps = slots + 1, 2
    log(f"[kernels] K3 pool_attention_paged  layer view of a "
        f"[{N_STAGES},{npages},{lps},{BATCH},{c},{kvh},{d}] pool")
    k3_err = 0.0
    k3_fns = (ops.pool_attention_paged, ref.pool_attention_paged_plain)
    handles = torch.arange(slots, dtype=torch.int32, device=dev)
    for name, dt in floats:
        q = randn(gb, c, h, d, dtype=dt)
        kp = randn(N_STAGES, npages, lps, BATCH, c, kvh, d, dtype=dt)
        vp = randn(N_STAGES, npages, lps, BATCH, c, kvh, d, dtype=dt)
        k_l, v_l = kp[:, :, 1], vp[:, :, 1]           # strided views
        got, err = pool_case(f"paged {name}", name, *k3_fns, q, k_l, v_l, handles, valid, ppc=1)
        k3_err = max(k3_err, err)
        if name == "bfloat16":
            call = lambda: ops.pool_attention_paged(q, k_l, v_l, handles, valid, ppc=1)
            ms, win_ms = time_ms(call), windowed_ms(call)
            prof_ms, seen = profiled_ms(call, "PagedWalk")
            log(f"  torch.profiler: attn_tc_kernel<PagedWalk> {seen} launches, "
                + (f"{prof_ms:.4f} ms device time each" if seen else "no device time seen"))
            plain = time_ms(lambda: ref.pool_attention_paged_plain(
                q, k_l, v_l, handles, valid, ppc=1))
            kv_read = 2.0 * n_valid * BATCH * c * kvh * d * kp.element_size()
            ops_n = 4.0 * d * n_valid * BATCH * h * c * c
            b_ms, by = bound_ms(nbytes(q, valid, handles, *got) + kv_read, ops_n, name)
            record("pool_attention_paged", ms=ms, windowed_ms=win_ms, profiler_ms=prof_ms,
                   plain_ms=plain, library_ms=None, bound_ms=b_ms, bound_by=by)
            log(f"  time: kernel {ms:.4f} ms ({win_ms:.4f} ms a call in windows of "
                f"back-to-back calls), plain {plain:.4f} ms, bound {b_ms:.4f} ms ({by})")
        del kp, vp
    # quantized pages with per-page scales read through the same handles
    q = randn(gb, c, h, d, dtype=torch.bfloat16)
    for kind in K1_KINDS:
        kp, ksp = quantize(randn(N_STAGES, npages, lps, BATCH, c, kvh, d), kind, (4, 6))
        vp, vsp = quantize(randn(N_STAGES, npages, lps, BATCH, c, kvh, d), kind, (4, 6))
        _, err = pool_case(f"paged {kind} pages", kind, *k3_fns, q, kp[:, :, 0], vp[:, :, 0],
                           handles, valid, ppc=1, k_scale=ksp[:, :, 0], v_scale=vsp[:, :, 0])
        k3_err = max(k3_err, err)
    # several pages a chunk, shuffled handles, a partial last page: pages of
    # 128 tokens (a tile within a page) and of 16 (four pages a tile), fp32
    # (with fp32) and, through the tensor-core body, bf16 and int8
    for pt in (c // 4, 16):
        ppc = c // pt
        perm = torch.randperm(npages * ppc, generator=gen, device=dev)
        hnd = perm[: slots * ppc].to(torch.int32)
        kv_len = 3 * 128 - 128 // 5                   # 358: a partial page and tile
        cases = (("float32", "float32"),) if fp32 and pt == c // 4 else ()
        for name, kind in cases + (("bfloat16", "bfloat16"), ("int8", "int8")):
            dt = torch.float32 if name == "float32" else torch.bfloat16
            kp = randn(N_STAGES, npages * ppc, lps, BATCH, pt, kvh, d)
            vp = randn(N_STAGES, npages * ppc, lps, BATCH, pt, kvh, d)
            kw = dict(ppc=ppc, kv_len=kv_len)
            if kind == "int8":
                kp, ksp = quantize(kp, kind, (4, 6))
                vp, vsp = quantize(vp, kind, (4, 6))
                kw.update(k_scale=ksp[:, :, 1], v_scale=vsp[:, :, 1])
            else:
                kp, vp = kp.to(dt), vp.to(dt)
            _, err = pool_case(f"paged pt {pt} (ppc {ppc}), shuffled handles, kv_len "
                               f"{kv_len} {name}", kind, *k3_fns, randn(gb, c, h, d, dtype=dt),
                               kp[:, :, 1], vp[:, :, 1], hnd, valid, **kw)
            k3_err = max(k3_err, err)
            del kp, vp
    k3 = results["pool_attention_paged"]
    k3["max_abs_err"] = max(k3.get("max_abs_err", 0.0), k3_err)
    if d == 80:
        pad_faults(results, randn, h, kvh, d)


# planted faults in the tensor-core body at D 80, each compiled from an
# edited copy of csrc/ (one library, one (q, kv) combination): name ->
# (KV_COMBO, [(file, text, replacement)], must it break the check, where
# False: must its output be bit-identical to the real kernel's)
PAD_FAULTS = {
    "the scores skip the padded box's columns 64-79 (Q·K^T one k-step short)": (
        3, [("hopper_tc.cuh", "for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64",
             "for (int kk = 0; kk < (D == 80 ? 4 : D / 16); ++kk) wgmma_ss_n64")], True),
    "the widened int8 tile zeroes columns 72-79 (its pad starts a 16-byte unit early)": (
        4, [("chunk_attn_tc.cuh", "    if (u * 8 < D) {",
             "    if (u * 8 < (D == 80 ? D - 8 : D)) {")], True),
    "the widened int8 tile's pad (columns 80-127) is left as bf16 3.4e38, not zero": (
        4, [("chunk_attn_tc.cuh", "    uint4 w = make_uint4(0, 0, 0, 0);",
             "    uint4 w = make_uint4(0x7f7f7f7fu, 0x7f7f7f7fu, 0x7f7f7f7fu, 0x7f7f7f7fu);")],
        False),
}
_FAULT_BUILDS: dict = {}   # fault -> (Popen, library path, log path), then the CDLL


def start_fault_builds() -> None:
    """Starts one nvcc per PAD_FAULTS entry on an edited copy of csrc/
    (under the ignored build/), beside the real build."""
    import shutil
    from repro_torch.kernels import build
    for i, (fault, (combo, edits, _)) in enumerate(PAD_FAULTS.items()):
        root = build.build_dir().parent / "faults" / f"f{i}"
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(build.CSRC, root)
        for name, old, new in edits:
            path = root / name
            text = path.read_text()
            check(text.count(old) == 1, f"fault '{fault}': {old!r} not found once in {name}")
            path.write_text(text.replace(old, new))
        lib, log = root / "libfault.so", root / "nvcc.log"
        proc = subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, f"-DKV_COMBO={combo}", "-o",
                                 str(lib), str(root / "chunk_attn.cu")],
                                stdout=log.open("w"), stderr=subprocess.STDOUT)
        _FAULT_BUILDS[fault] = (proc, lib, log)


def fault_lib(fault: str):
    import ctypes
    entry = _FAULT_BUILDS[fault]
    if isinstance(entry, tuple):
        proc, lib, log = entry
        check(proc.wait() == 0, f"fault '{fault}' did not build:\n{log.read_text()[-3000:]}")
        entry = _FAULT_BUILDS[fault] = ctypes.CDLL(str(lib))
    return entry


def fault_ratio(got, want, in_dtype: str) -> float:
    """The largest error of any output as a multiple of its tolerance
    (``compare``'s limits, at each output's own max|ref|), or inf where a
    sentinel is not kept or a value is not finite."""
    import torch
    worst = 0.0
    for g, r in zip(got, want):
        tol = tolerance(r.dtype, in_dtype)
        g, r = g.float(), r.float()
        empty = r <= -1e29
        g_kept, r_kept = g[~empty], r[~empty]
        if not bool((g[empty] == r[empty]).all()) or not bool(torch.isfinite(g_kept).all()):
            return float("inf")
        if r_kept.numel():
            worst = max(worst, (g_kept - r_kept).abs().max().item()
                        / (tol * max(r_kept.abs().max().item(), 1e-30)))
    return worst


def pad_faults(results: dict, randn, h: int, kvh: int, d: int) -> None:
    """The PAD_FAULTS libraries in the real one's place at d 80 (bf16 q):
    K1 on a causal self block with bf16 pages and on a prefix with int8
    pages, K2 on a stack of int8 pages, against the plain version. A
    fault in the columns the products read (64-79) must break
    ``compare``'s limit. A fault in the pad (80-127) must leave the
    output bit-identical to the real kernel's: no product reads the pad
    (Q·K^T runs D / 16 k-steps, P·V is an n80 wgmma)."""
    import torch
    from repro_torch.kernels import build, ops, ref

    log(f"[kernels] planted faults in the D {d} tensor-core body")
    bf16, gb, c = torch.bfloat16, N_STAGES * BATCH, CHUNK
    q = randn(gb, c, h, d, dtype=bf16)
    k, v = randn(gb, c, kvh, d, dtype=bf16), randn(gb, c, kvh, d, dtype=bf16)
    cases = {3: [("K1 self block, bf16 pages", "bfloat16",
                  lambda: ops.chunk_attention(q, k, v, return_state=True),
                  lambda: ref.chunk_attention_plain(q, k, v))]}
    kq, ks = quantize(randn(gb, c, kvh, d), "int8", (1, 3))
    vq, vs = quantize(randn(gb, c, kvh, d), "int8", (1, 3))
    ks = ks.expand(gb, c, kvh, 1)[..., 0].contiguous()
    vs = vs.expand(gb, c, kvh, 1)[..., 0].contiguous()
    kw = dict(causal_offset=c, k_scale=ks, v_scale=vs)
    sk, sks = quantize(randn(4, gb, c, kvh, d), "int8", (2, 4))
    sv, svs = quantize(randn(4, gb, c, kvh, d), "int8", (2, 4))
    sks = sks.expand(4, gb, c, kvh, 1)[..., 0].contiguous()
    svs = svs.expand(4, gb, c, kvh, 1)[..., 0].contiguous()
    valid = torch.ones((N_STAGES, 4), dtype=torch.bool, device=q.device)
    skw = dict(k_scale=sks, v_scale=svs)
    cases[4] = [("K1 prefix block, int8 pages", "int8",
                 lambda: ops.chunk_attention(q, kq, vq, return_state=True, **kw),
                 lambda: ref.chunk_attention_plain(q, kq, vq, **kw)),
                ("K2 4-slot stack, int8 pages", "int8",
                 lambda: ops.pool_attention(q, sk, sv, valid, **skw),
                 lambda: ref.pool_attention_plain(q, sk, sv, valid, **skw))]
    planted = results.setdefault("chunk_attention", {}).setdefault("planted_d80", {})
    for fault, (combo, _, must_break) in PAD_FAULTS.items():
        name = f"chunk_attn.{combo}"
        real_lib = build.lib(name)
        for what, in_dtype, kernel, plain in cases[combo]:
            want = plain()
            with swapped(build, "_LIBS", dict(build._LIBS, **{name: fault_lib(fault)})):
                got = kernel()
            torch.cuda.synchronize()
            ratio = fault_ratio(got, want, in_dtype)
            same = all(torch.equal(a, b) for a, b in zip(got, kernel()))
            log(f"  planted fault: {fault}: {what}: worst {ratio:.3e} of the tolerance"
                f"{'; bit-identical to the real kernel' if same else ''}")
            planted[f"{fault}: {what}"] = ratio
            if must_break:
                check(ratio > 1.0, f"planted fault '{fault}' passes on {what} ({ratio})")
            else:
                check(same, f"planted fault '{fault}' changes the output on {what}: "
                      f"a product reads the pad")
        check(build.lib(name) is real_lib, "the real library was not put back")


# (heads H, head dim P, state N) of the SSD scan at each model's serve shape
SSD_SHAPES = {"zamba2-7b": (112, 64, 64), "mamba2-130m": (24, 64, 128)}
SSD_CHUNK = 256                    # both models' ssm.chunk_size


def ssd_inputs(gen, rows: int, t: int, h: int, p: int, g: int, n: int, dtype,
               strided: bool = False):
    """Random SSD inputs with the model's distributions: dt log-uniform in
    [1e-3, 1e-1] per head (``init_block``'s dt_bias) times a log-normal
    factor, A = -(1..H) with one a_log row per stage (Gs = 8), d_skip near
    1, B and C unit-variance, a non-zero fp32 init_state. ``strided``: x, b
    and c are views into one [rows, t, h p + 2 g n] buffer, the layout the
    Mamba2 block hands K4 (its conv output, read in place)."""
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
    if strided:
        x, b, c = torch.split(randn(rows, t, h * p + 2 * g * n).to(dtype),
                              [h * p, g * n, g * n], dim=-1)
        x, b, c = x.view(rows, t, h, p), b.view(rows, t, g, n), c.view(rows, t, g, n)
    else:
        x, b, c = (randn(rows, t, h, p).to(dtype), randn(rows, t, g, n).to(dtype),
                   randn(rows, t, g, n).to(dtype))
    return x, dt, a_log, b, c, d_skip, 0.1 * randn(rows, h, p, n)


def ssd_phase(results: dict) -> None:
    """K4 against ``ssd_plain`` at both models' serve shapes (16 rows =
    8 stages x batch 2, T = 512, chunk 256), bf16 and fp32, non-zero
    init_state, Gs = 8, with x, b and c dense and as the strided views the
    Mamba2 block hands over (one conv-output buffer); then G = 2 < H
    without an init_state, bf16 (the tensor-core body) and fp32. In bf16
    at each shape: kernel and plain version timed on dense inputs (and the
    kernel on the strided views), in windows of back-to-back calls and from
    a torch.profiler trace, which must show the tensor-core body
    (``ssd_tc_kernel``)."""
    import torch
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(2)
    rows, t = N_STAGES * BATCH, CHUNK
    err = 0.0
    labels = ("y", "state")
    for arch, (h, p, n) in SSD_SHAPES.items():
        for name, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            times = {}
            for strided in (False, True):
                layout = "strided views" if strided else "dense"
                log(f"[kernels] K4 ssd {arch} {name}  x [{rows},{t},{h},{p}], "
                    f"b/c [{rows},{t},1,{n}], Gs {N_STAGES}, init_state, {layout}")
                args = ssd_inputs(gen, rows, t, h, p, 1, n, dt, strided=strided)
                *xs, init = args
                got = ops.ssd(*xs, chunk=SSD_CHUNK, init_state=init)
                want = ref.ssd_plain(*xs, chunk=SSD_CHUNK, init_state=init)
                torch.cuda.synchronize()
                err = max(err, compare(f"ssd {arch} {name} {layout}", got, want, name,
                                       labels))
                if name != "bfloat16":
                    continue
                call = lambda: ops.ssd(*xs, chunk=SSD_CHUNK, init_state=init)
                if strided:
                    times["strided_ms"] = time_ms(call)
                    log(f"  time: kernel {times['strided_ms']:.4f} ms")
                    continue
                ms, win_ms = time_ms(call), windowed_ms(call)
                prof_ms, seen = profiled_ms(call, "ssd_tc_kernel")
                log(f"  torch.profiler: ssd_tc_kernel {seen} launches, "
                    + (f"{prof_ms:.4f} ms device time each" if seen else "no device time seen"))
                check(seen > 0, f"K4 {arch} bf16: the tensor-core body did not run")
                plain = time_ms(lambda: ref.ssd_plain(*xs, chunk=SSD_CHUNK, init_state=init))
                tri = SSD_CHUNK * (SSD_CHUNK + 1) / 2
                per_chunk = 2.0 * tri * (n + p) + 4.0 * SSD_CHUNK * p * n
                ops_n = per_chunk * rows * h * (t // SSD_CHUNK)
                b_ms, by = bound_ms(nbytes(*args, *got), ops_n, name)
                times.update(ms=ms, windowed_ms=win_ms, profiler_ms=prof_ms, plain_ms=plain,
                             library_ms=None, bound_ms=b_ms, bound_by=by)
                log(f"  time: kernel {ms:.4f} ms ({win_ms:.4f} ms a call in windows of "
                    f"back-to-back calls), plain {plain:.4f} ms, bound {b_ms:.4f} ms ({by}), "
                    f"{ops_n / 1e9:.1f} GFLOP")
            if name != "bfloat16":
                continue
            if arch == "zamba2-7b":
                results.setdefault("ssd", {}).update(times)
            else:
                results.setdefault("ssd", {})[arch] = times
    h, p, n = SSD_SHAPES["zamba2-7b"]
    for name, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        log(f"[kernels] K4 ssd G = 2 < H = {h}, no init_state, {name}")
        *xs, _ = ssd_inputs(gen, rows, t, h, p, 2, n, dt)
        got = ops.ssd(*xs, chunk=SSD_CHUNK)
        want = ref.ssd_plain(*xs, chunk=SSD_CHUNK)
        err = max(err, compare(f"ssd G=2 {name}", got, want, name, labels))
    results["ssd"]["max_abs_err"] = err


# (heads H, kv heads, head dim) of each decode shape; the main one first
DECODE_SHAPES = {"qwen3-8b": (32, 8, 128), "zamba2-7b": (32, 32, 112)}
DECODE_KERNEL_BATCH, DECODE_KERNEL_S = 8, 32768   # decode_32k, batch 128 cut to 8


def sdpa_decode(q, k, v, kv_len):
    """The library call computing K5's function, timed as ``library_ms``
    and never used by the port: ``scaled_dot_product_attention`` with GQA
    and a boolean length mask, pinned to the backend that the default
    dispatch takes (the first of torch's priority order that accepts these
    inputs), so that the backend recorded is the one timed. Returns (call,
    backend name)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qt = q[:, :, None, :]                                   # [B, H, 1, D]
    kt, vt = (x.transpose(1, 2).contiguous() for x in (k, v))   # [B, KVH, S, D]
    mask = (torch.arange(k.shape[1], device=q.device)[None, :]
            < kv_len[:, None])[:, None, None, :]           # [B, 1, 1, S]

    def call():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)
    backend = None
    for b in map(SDPBackend, torch._C._get_sdp_priority_order()):
        try:
            with sdpa_kernel([b]), warnings.catch_warnings():
                warnings.simplefilter("ignore")   # each refusal warns why
                call()
            backend = b
            break
        except RuntimeError:
            continue
    check(backend is not None, "no SDPA backend takes the decode inputs")

    def pinned():
        with sdpa_kernel([backend]):
            return call()
    return pinned, backend.name


def decode_kernel_phase(results: dict) -> None:
    """K5 against ``decode_attention_plain`` at each decode shape, 8 rows
    over a 32768-token cache, bf16 and fp32. Timed (bf16, median of 12
    CUDA-event windows) with every row at full length, so that the bound
    counts every byte K5 must read; held at ragged lengths 0, 1, 77, 4099,
    12345, 20001, 32767 and S with keys and values past each length
    poisoned (+-1e4), and at lengths 100x apart in one call (~300 and
    ~32k, which the device-side split must balance), each output at its own
    max|ref| (``compare``), the empty row exactly zero. The bf16 time is
    also read in windows of back-to-back calls and from a torch.profiler
    trace."""
    import torch
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    b, s = DECODE_KERNEL_BATCH, DECODE_KERNEL_S
    ragged = torch.tensor([0, 1, 77, 4099, 12345, 20001, s - 1, s], dtype=torch.int32,
                          device=dev)
    spread = torch.tensor([300, 30000, 327, s, 310, 31000, 299, 32000], dtype=torch.int32,
                          device=dev)
    err = 0.0
    for arch, (h, kvh, d) in DECODE_SHAPES.items():
        for name, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            log(f"[kernels] K5 decode_attention {arch} {name}  q [{b},{h},{d}], "
                f"k/v [{b},{s},{kvh},{d}]")
            q = torch.randn((b, h, d), generator=gen, device=dev).to(dt)
            k = torch.randn((b, s, kvh, d), generator=gen, device=dev).to(dt)
            v = torch.randn((b, s, kvh, d), generator=gen, device=dev).to(dt)
            full = torch.full((b,), s, dtype=torch.int32, device=dev)
            got = ops.decode_attention(q, k, v, full)
            want = ref.decode_attention_plain(q, k, v, full)
            err = max(err, compare(f"decode {arch} {name} full length", (got,), (want,),
                                   name, ("out",)))
            if name == "bfloat16":
                call = lambda: ops.decode_attention(q, k, v, full)
                ms, win_ms = time_ms(call), windowed_ms(call)
                prof_ms, seen = profiled_ms(call, "decode_attn_kernel")
                log(f"  torch.profiler: decode_attn_kernel {seen} launches, "
                    + (f"{prof_ms:.4f} ms device time each" if seen else "no device time seen"))
                plain = time_ms(lambda: ref.decode_attention_plain(q, k, v, full))
                lib_call, backend = sdpa_decode(q, k, v, full)
                check((lib_call().squeeze(2).float() - want.float()).abs().max().item()
                      <= 2e-2 * want.float().abs().max().item(),
                      "the SDPA yardstick does not compute K5's function")
                lib = time_ms(lib_call)
                b_ms, by = bound_ms(nbytes(q, k, v, full, got), 4.0 * d * s * h * b, name)
                times = dict(ms=ms, windowed_ms=win_ms, profiler_ms=prof_ms, plain_ms=plain,
                             library_ms=lib, bound_ms=b_ms,
                             bound_by=by, library=f"scaled_dot_product_attention "
                             f"(enable_gqa, bool mask; backend {backend})")
                if arch == "qwen3-8b":
                    results.setdefault("decode_attention", {}).update(times)
                else:
                    results.setdefault("decode_attention", {})[f"d{d}"] = times
                log(f"  time: kernel {ms:.4f} ms ({win_ms:.4f} ms a call in windows of "
                    f"back-to-back calls), plain {plain:.4f} ms, sdpa {lib:.4f} ms "
                    f"({backend}), bound {b_ms:.4f} ms ({by}), "
                    f"{nbytes(k, v) / 1e9:.3f} GB of K/V")
            for lens, what in ((ragged, "ragged"), (spread, "lengths 100x apart")):
                if what != "ragged":                  # fresh keys, then a new poison
                    k.normal_(generator=gen)
                    v.normal_(generator=gen)
                for i, n in enumerate(lens.tolist()):   # poison past each length
                    k[i, n:], v[i, n:] = 1e4, -1e4
                got = ops.decode_attention(q, k, v, lens)
                want = ref.decode_attention_plain(q, k, v, lens)
                if what == "ragged":
                    check(bool((got[0] == 0).all()),
                          f"K5 {arch} {name}: the kv_len = 0 row is not zero")
                err = max(err, compare(f"decode {arch} {name} {what}, tail poisoned",
                                       (got,), (want,), name, ("out",)))
            del q, k, v, got, want
            torch.cuda.empty_cache()
    results["decode_attention"]["max_abs_err"] = err


def row_errors(got, want) -> tuple:
    """Each query row's (row, position, head) largest error over the head
    dim, as a fraction of that row's own max|ref|, and held at compare's
    bf16 limit: (the worst such fraction over its limit, the largest
    absolute error). A row that averages over thousands of keys is some
    50x smaller than the first rows (whose output is v0), so a limit on
    max|ref| over the whole output would not see an error there."""
    g, r = got.float(), want.float()
    err = (g - r).abs().amax(-1)
    scale = r.abs().amax(-1).clamp(min=1e-30)
    return (err / scale).max().item() / tolerance(want.dtype, "bfloat16"), err.max().item()


def k1_gpipe_shape(results: dict) -> None:
    """K1 at the GPipe baseline's shape: one launch a (layer, tick) over the
    N x bm = 8 rows of a tick, each a whole 4096-token sequence against
    itself (C = T = 4096, causal offset 0), qwen3-8b's heads, bf16, as
    ``core.gpipe`` calls it (no state). The plain version materializes
    [rows, H, 4096, 4096] fp32 scores, so the kernel's first GP_HELD rows
    are held against it on those rows alone, each query row at its own
    scale (``row_errors``); each planted K1 fault (``k1_faults``), run on
    the kernel, must break that limit. Times: ``time_ms``,
    ``windowed_ms``, ``profiled_ms`` of the 8-row launch, SDPA's causal
    time at the same shape, the plain version's on the held rows; recorded
    under ``results["chunk_attention"]["gpipe_shape"]``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    rows, s, h, kvh, d = N_STAGES * GP_BM, N_CHUNKS * CHUNK, 32, 8, 128
    log(f"[kernels] K1 chunk_attention at gpipe's shape  q [{rows},{s},{h},{d}], "
        f"k/v [{rows},{s},{kvh},{d}] bf16, causal offset 0")
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
               for shape in ((rows, s, h, d), (rows, s, kvh, d), (rows, s, kvh, d)))
    got = ops.chunk_attention(q, k, v, causal_offset=0)
    held = (q[:GP_HELD], k[:GP_HELD], v[:GP_HELD])
    want = ref.chunk_attention_plain(*held, causal_offset=0)[0]
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), "K1 at gpipe's shape: non-finite output")
    worst, err = row_errors(got[:GP_HELD], want)
    log(f"  gpipe shape, rows 0-{GP_HELD - 1} of {rows} out: max abs err {err:.3e}; worst "
        f"query row {worst:.3f} of its limit ({tolerance(want.dtype, 'bfloat16'):.0e} "
        f"of the row's max|ref|)")
    check(worst <= 1.0, f"K1 at gpipe's shape: a query row off by {worst} of its limit")
    for fault, fn in k1_faults(ops.chunk_attention).items():
        bad, _ = row_errors(fn(*held, causal_offset=0), want)
        log(f"  planted fault on the kernel: {fault}: worst query row {bad:.3f} of its limit")
        check(bad > 1.0, f"K1 at gpipe's shape: planted fault '{fault}' passes ({bad})")
    del want
    torch.cuda.empty_cache()
    call = lambda: ops.chunk_attention(q, k, v, causal_offset=0)
    ms, win_ms = time_ms(call), windowed_ms(call)
    prof_ms, seen = profiled_ms(call, "ChunkWalk", calls=10)
    plain = time_ms(lambda: ref.chunk_attention_plain(*held, causal_offset=0), iters=4,
                    warmup=1)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                         enable_gqa=True))
    pairs = rows * h * s * (s + 1) / 2
    b_ms, by = bound_ms(nbytes(q, k, v, got), 4.0 * d * pairs, "bfloat16")
    k1 = results["chunk_attention"]
    k1["gpipe_shape"] = dict(rows=rows, seq=s, ms=ms, windowed_ms=win_ms,
                             profiler_ms=prof_ms, plain_ms=plain, plain_rows=GP_HELD,
                             library_ms=lib, bound_ms=b_ms, bound_by=by)
    k1["max_abs_err"] = max(k1.get("max_abs_err", 0.0), err)
    log(f"  torch.profiler: attn_tc_kernel<ChunkWalk> {seen} launches, "
        + (f"{prof_ms:.4f} ms device time each" if seen else "no device time seen"))
    log(f"  time: kernel {ms:.4f} ms ({win_ms:.4f} ms a call in windows), plain "
        f"{plain:.4f} ms on {GP_HELD} rows, sdpa {lib:.4f} ms, bound {b_ms:.4f} ms ({by})")
    del q, k, v, qt, kt, vt, got, held
    torch.cuda.empty_cache()


# K1-K3 at the attention shapes of the models served here past qwen3-8b
# and zamba2-7b: the key their times go under -> (H, KVH, D, also fp32 q)
ATTN_SHAPES = {"d64": (32, 8, 64, True),        # granite-3-2b (G 4)
               "d64_g3": (24, 8, 64, True),     # granite-moe-3b-a800m (G 3)
               "d80": (32, 32, 80, True),       # stablelm-3b (MHA; the padded box)
               "d128_mha": (16, 16, 128, False)}   # qwen2-moe-a2.7b (MHA, bf16 only)


def kernel_phase(results: dict) -> None:
    attention_phase(results, h=32, kvh=8, d=128)                # qwen3-8b
    k1_gpipe_shape(results)
    attention_phase(results, h=32, kvh=32, d=112, key="d112", fp32=False)   # zamba2-7b
    for key, (h, kvh, d, fp32) in ATTN_SHAPES.items():
        t0 = time.perf_counter()
        attention_phase(results, h=h, kvh=kvh, d=d, key=key, fp32=fp32)
        log(f"[kernels] K1-K3 at {key} (H {h}, KVH {kvh}): {time.perf_counter() - t0:.1f} s")
    ssd_phase(results)
    decode_kernel_phase(results)


# ------------------------------------------------------------ smoke parity

SMOKE_CASES = [   # (arch, remote_attn, pool_backend, kv_dtype)
    ("qwen3-8b", "qship", "cuda", "auto"), ("qwen3-8b", "fetch", "paged", "auto"),
    ("qwen3-8b", "fetch", "cuda", "int8"), ("qwen3-8b", "qship", "paged", "fp8"),
    ("zamba2-7b", "qship", "cuda", "auto"), ("zamba2-7b", "fetch", "paged", "auto"),
    ("zamba2-7b", "qship", "cuda", "int8"), ("mamba2-130m", "qship", "cuda", "auto"),
    # the other decoder families (D 16: the new model math, not the new head dims)
    ("granite-3-2b", "qship", "cuda", "auto"), ("stablelm-3b", "fetch", "paged", "auto"),
    ("qwen2-moe-a2.7b", "qship", "cuda", "auto"),
    ("granite-moe-3b-a800m", "fetch", "paged", "auto"),
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
# combinations (remote_attn, attn_backend, pool_backend, kv_dtype and, where
# it is not the family's, the mode; the SSD runs K4), the kernels its main
# path must launch, and which wrapper the planted faults replace. Optional:
# ``per_launch``, the wrappers held per launch against their plain versions
# on the bf16 path (where no bf16 logits limit separates a fault); ``wave``
# False, no profiled wave; ``fp32_layers``, the depth of the fp32 runs
ATTN_KERNELS = ("chunk_attention", "pool_attention", "pool_attention_paged")
SERVE_MODELS = {
    "qwen3-8b": dict(
        combos=[("qship", "cuda", "cuda", "auto"), ("qship", "cuda", "paged", "auto"),
                ("fetch", "cuda", "cuda", "auto"), ("fetch", "cuda", "paged", "auto"),
                ("qship", "cuda", "cuda", "int8")],
        kernels=ATTN_KERNELS, faults="pool_attention"),
    "zamba2-7b": dict(
        combos=[("qship", "cuda", "cuda", "auto"), ("fetch", "cuda", "paged", "auto"),
                ("qship", "cuda", "cuda", "int8")],
        kernels=ATTN_KERNELS + ("ssd",), faults="ssd"),
    "mamba2-130m": dict(
        combos=[("qship", "cuda", "cuda", "auto")],
        kernels=("ssd",), faults="ssd"),
    "granite-3-2b": dict(
        combos=[("qship", "cuda", "cuda", "auto"), ("fetch", "cuda", "paged", "auto"),
                ("qship", "cuda", "cuda", "int8")],
        # its logits hardly see attention (embedding x 12, attention scale
        # 1/64, residual x 0.22): the K2 faults stay under the bf16 spread
        kernels=ATTN_KERNELS, faults="pool_attention", per_launch=ATTN_KERNELS),
    "stablelm-3b": dict(
        combos=[("fetch", "cuda", "cuda", "auto", "terapipe"),
                ("qship", "cuda", "paged", "auto", "mocap")],
        kernels=ATTN_KERNELS, faults="pool_attention", wave=False),
    "qwen2-moe-a2.7b": dict(
        combos=[("qship", "cuda", "cuda", "auto"), ("fetch", "cuda", "paged", "auto")],
        kernels=ATTN_KERNELS, faults="pool_attention", per_launch=ATTN_KERNELS,
        # 24 layers of fp32 experts are ~57 GB: the fp32 runs take one layer a stage
        fp32_layers=N_STAGES),
    "granite-moe-3b-a800m": dict(
        combos=[("fetch", "cuda", "cuda", "auto"), ("qship", "cuda", "paged", "auto")],
        kernels=ATTN_KERNELS, faults="pool_attention", per_launch=ATTN_KERNELS,
        wave=False),
}
# serve checks, as fractions of the reference's max|logit|: a bf16 kernel
# combination against the witness, the cuda pool (K2) against the paged
# pool (K3) under the same remote mode in bf16, and an fp32 combination
# against the torch backends (per model: mamba2-130m's fp32 logits depend on
# the carried SSD state by ~1e-3 of max|logit|, so its limit sits lower)
BF16_LOGIT_TOL = {"qwen3-8b": 0.1, "zamba2-7b": 0.1, "mamba2-130m": 0.1,
                  "granite-3-2b": 0.1, "stablelm-3b": 0.1,
                  # MoE: the spread of two bf16 summation orders (the torch
                  # backend against the witness, router flips and all) is
                  # measured and printed; the kernels are also held per
                  # launch. qwen2-moe-a2.7b's spread reaches ~0.3 of
                  # max|logit| and flips argmaxes, so no limit holds there:
                  # its bf16 logits are reported (None), not held
                  "qwen2-moe-a2.7b": None, "granite-moe-3b-a800m": 0.1}
BF16_POOL_PAIR_TOL = 1e-3
FP32_LOGIT_TOL = {"qwen3-8b": 1e-3, "zamba2-7b": 1e-3, "mamba2-130m": 1e-4,
                  # granite-3-2b's logits move ~5e-4 of max|logit| when K2
                  # drops a slot (its summation-order spread: ~3e-7)
                  "granite-3-2b": 1e-5, "stablelm-3b": 1e-3, "qwen2-moe-a2.7b": 1e-3,
                  "granite-moe-3b-a800m": 1e-3}


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


def plain_of(kind: str):
    """The plain version of the wrapper ``ops.<kind>``, with its signature:
    for K1-K3 the wrapper itself (its checks and argument handling) with
    its CPU route taken on the card's tensors (``ops._on_card`` reading
    False), which is the plain version's call."""
    from repro_torch.kernels import ops, ref
    if kind == "decode_attention":
        return ref.decode_attention_plain
    if kind in ATTN_KERNELS:
        wrapper = getattr(ops, kind)

        def plain(*args, **kw):
            with swapped(ops, "_on_card", lambda *ts: False):
                return wrapper(*args, **kw)
        return plain

    def ssd(x, dt, a_log, b, c, d_skip, *, chunk, init_state=None):
        return ref.ssd_plain(x, dt, a_log, b, c, d_skip,
                             chunk=ops.ssd_chunk(x.shape[1], chunk), init_state=init_state)
    return ssd


def shadowed(fn, kind: str, worst: list):
    """``fn`` (the wrapper ``ops.<kind>``: K1-K5, or a planted fault) in
    its place on a model path, every call also held against the plain
    version on the same inputs: ``worst[0]`` keeps the largest error of any
    output as a multiple of its tolerance (``fault_ratio``: 2e-2 of
    max|ref| for a bf16 output, 1e-3 for an fp32 one of bf16 inputs, 1e-4
    for fp32 inputs; entries holding the empty-row sentinel m = -1e30 must
    match it and stay out of max|ref|)."""
    import torch
    plain = plain_of(kind)

    def call(*args, **kw):
        got = fn(*args, **kw)
        want = plain(*args, **kw)
        in_dtype = "float32" if args[0].dtype == torch.float32 else "bfloat16"
        pair = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        worst[0] = max(worst[0], fault_ratio(*pair, in_dtype))
        return got
    return call


# a wave's device time by kernel: (label, lowercased substrings of the
# kernel's name), the first match wins; the rest is "other"
WAVE_CATEGORIES = (
    ("K1 chunk_attention", ("chunkwalk", "chunk_attn")),
    ("K2 pool_attention", ("stackwalk", "pool_attn")),
    ("K3 pool_attention_paged", ("paged_attn",)),
    ("K4 ssd", ("ssd",)),
    ("matmuls", ("gemm", "nvjet", "cutlass", "xmma", "cublas")),
    # the MoE dispatch: its sorts, its counts' scan, its gathers and scatters
    ("MoE dispatch (sort, scan, gather / scatter)", ("sort", "scan", "scatter_gather")),
    ("page gathers / scatters", ("index", "gather", "scatter")),
    ("copies / casts", ("copy", "memcpy", "memset")),
)


def wave_split(arch: str, staged=None,
               combo=("qship", "cuda", "cuda", "auto")) -> dict:
    """One bf16 wave (BATCH requests) of ``arch`` at full width and depth
    through PrefillEngine + TorchExecutor under ``combo`` (the SSD on K4),
    traced by
    torch.profiler (device activity only) after a warm-up wave and an
    untraced wave: the device time by WAVE_CATEGORIES (seconds), the busy
    time (the union of the kernels' intervals) and the device's idle share
    of the traced window (first kernel's start to last kernel's end), the
    wave's host wall time traced and untraced, the card's clocks, power
    and temperature just after it, and the 12 kernels that take the most
    device time. ``staged``: the model's bf16 weights (made from seed 0 if
    None). Logs and returns the numbers."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.core import pipeline as pp
    from repro_torch.core.staging import init_staged
    from repro_torch.launch.serve import make_requests
    from repro_torch.runtime.engine import (EngineConfig, PrefillEngine,
                                            TorchExecutor)

    cfg = get_config(arch)
    seq = N_CHUNKS * CHUNK
    remote, attn, pool, kv = combo
    run = RunConfig(num_chunks=N_CHUNKS, num_stages=N_STAGES, mbkr=not cfg.attn_free,
                    remote_attn=remote, attn_backend=attn, pool_backend=pool, kv_dtype=kv,
                    ssm_backend="cuda")
    if staged is None:
        plan = pp.build_plan(cfg, N_STAGES, seq, run)
        staged = init_staged(cfg, plan, torch.Generator(device="cuda").manual_seed(0),
                             device="cuda")

    def wave() -> float:
        ex = TorchExecutor(cfg, staged, run, device="cuda")
        eng = PrefillEngine(EngineConfig(model=cfg, num_stages=N_STAGES, tp=1,
                                         num_chunks=N_CHUNKS, max_batch=BATCH,
                                         buckets=(seq,), partition="uniform"), ex)
        for r in make_requests(BATCH, seq, cfg.vocab_size, seed=0):
            eng.submit(r)
        eng.run_until_drained()
        check(len(ex.waves) == 1 and len(eng.done) == BATCH, f"{arch}: not one wave")
        return ex.waves[0]["dur"]

    wave()                              # warm-up: allocator, library handles
    untraced = wave()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        traced = wave()
        torch.cuda.synchronize()
    clocks = card_clocks()
    path = ROOT / "build" / f"wave_trace_{arch}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e)
    check(bool(spans), f"{arch}: the traced wave holds no device time")
    split: dict = {}
    by_name: dict = {}
    for t0, t1, name in spans:
        low = name.lower()
        label = next((lab for lab, keys in WAVE_CATEGORIES if any(k in low for k in keys)),
                     "other")
        split[label] = split.get(label, 0.0) + (t1 - t0) / 1e6
        by_name[name] = by_name.get(name, 0.0) + (t1 - t0) / 1e6
    busy, (lo, hi) = 0.0, spans[0][:2]
    for t0, t1, _ in spans[1:]:
        if t0 > hi:
            busy, lo, hi = busy + hi - lo, t0, t1
        else:
            hi = max(hi, t1)
    busy = (busy + hi - lo) / 1e6
    window = (max(t1 for _, t1, _ in spans) - spans[0][0]) / 1e6
    # K4's launches by body: the tensor-core one, or the CUDA-core one
    k4 = {body: sum(key in name for _, _, name in spans)
          for body, key in (("tensor cores", "ssd_tc_kernel"), ("cuda cores", "ssd_kernel"))}
    out = dict(split=split, busy_s=busy, window_s=window, idle_share=1.0 - busy / window,
               wave_s=untraced, traced_wave_s=traced, kernels=len(spans), card=clocks,
               k4_launches=k4)
    log(f"[wave] {arch} bf16 {'/'.join(combo)}: wave {untraced:.4f} s untraced, "
        f"{traced:.4f} s traced; {len(spans)} device activities; busy {busy:.4f} s of a "
        f"{window:.4f} s window, idle share {1.0 - busy / window:.4f}; card after it "
        f"(SM clock, its max, power draw, temperature): {clocks}")
    for label, sec in sorted(split.items(), key=lambda x: -x[1]):
        log(f"  {label}: {sec:.4f} s ({sec / busy:.1%} of the device's busy time)")
    if any(k4.values()):
        log(f"  K4 launches by body: {k4}")
    for name, sec in sorted(by_name.items(), key=lambda x: -x[1])[:12]:
        log(f"    {sec:.4f} s  {name[:110]}")
    return out


def moe_cap(cfg) -> int:
    """An expert's slots for one (stage, row) chunk of CHUNK tokens."""
    from repro_torch.models.layers import moe_capacity
    m = cfg.moe
    return moe_capacity(CHUNK, m.top_k, m.real_experts, m.capacity_factor)


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
    Models held per launch (``per_launch``): in the MoE models a last-bit
    difference in a router input flips a token's expert near a tie, which
    changes that token's FFN output wholesale, so in bf16 the logits of
    two summation orders lie further apart; granite-3-2b's logits hardly
    see attention at all (its scalars), so a K2 fault moves them less than
    the bf16 spread. The spread is measured (the ``torch`` backend against
    the witness) and, for MoE, the (token, slot) choices that differ from
    the witness's are counted for every run but the counted main-path ones
    (their per-launch reruns, on the same kernels, count them), beside the
    logits held at BF16_LOGIT_TOL as for the other models, or reported
    where no limit holds the real kernels (None: qwen2-moe-a2.7b, whose
    spread flips argmaxes). Every K1, K2 and K3 launch of each bf16
    combination is then held against its plain version on its
    own inputs, which the real kernels must pass and each planted K2 fault
    must break.
    fp32 (same geometry, weights drawn in fp32; ``fp32_layers`` deep where
    set): summation order is the only difference left, so every
    combination's argmax must equal the ``torch`` backends' on the same
    pages, with the logits within FP32_LOGIT_TOL[arch]; both planted faults
    must break that."""
    import numpy as np
    import torch
    from repro_torch.configs import RunConfig, get_config, replace
    from repro_torch.core import attention
    from repro_torch.core import pipeline as pp
    from repro_torch.core.staging import init_staged
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import layers as layers_mod
    from repro_torch.models.layers import pad_vocab
    from repro_torch.runtime.engine import (EngineConfig, PrefillEngine,
                                            TorchExecutor)

    spec = SERVE_MODELS[arch]
    cfg = get_config(arch)
    seq = N_CHUNKS * CHUNK
    base = RunConfig(num_chunks=N_CHUNKS, num_stages=N_STAGES, mbkr=not cfg.attn_free)
    plan = pp.build_plan(cfg, N_STAGES, seq, base)
    log(f"[serve] {arch} d={cfg.d_model} layers={cfg.num_layers} heads={cfg.num_heads}/"
        f"{cfg.num_kv_heads} hd={cfg.resolved_head_dim} mode={plan.mode} "
        f"lps={plan.layers_per_stage} N={N_STAGES} M={N_CHUNKS} C={CHUNK} "
        f"slots={plan.num_slots} p2={plan.p2} host_slots_used="
        f"{plan.host_slots_used.tolist()} ticks={plan.num_ticks}"
        + ("" if cfg.moe is None else f" experts={cfg.moe.num_experts} top_k="
           f"{cfg.moe.top_k} shared={cfg.moe.num_shared_experts} cap/chunk={moe_cap(cfg)}"))
    if not cfg.attn_free:
        check(plan.p2 < N_CHUNKS - 1, "the plan has no remote chunk to attend to")
    kvs = sorted({combo[3] for combo in spec["combos"]})
    per_launch = spec.get("per_launch", ())

    def weights(model_cfg):
        t0 = time.perf_counter()
        gen = torch.Generator(device="cuda").manual_seed(0)
        staged = init_staged(model_cfg, pp.build_plan(model_cfg, N_STAGES, seq, base), gen,
                             device="cuda")
        torch.cuda.synchronize()
        log(f"  {model_cfg.dtype} weights, {model_cfg.num_layers} layers: "
            f"{time.perf_counter() - t0:.2f} s, "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
        return staged

    choices: list = []          # the MoE router's choices of the run under way
    route = layers_mod.moe_route

    def record_choices(*args, **kw):
        weights_, picked = route(*args, **kw)
        choices.append(picked.to(torch.uint8))
        return weights_, picked

    def serve(model_cfg, staged, remote: str, attn: str, pool: str, kv: str,
              mode=None, ssm: str = "cuda", record: bool = True):
        """One run of REQUESTS requests: its logits, and the MoE router's
        choices where ``record`` (False on the counted main path, which
        runs the code as users run it)."""
        run = RunConfig(num_chunks=N_CHUNKS, num_stages=N_STAGES,
                        mbkr=(mode == "mocap") if mode else not model_cfg.attn_free,
                        remote_attn=remote, attn_backend=attn, pool_backend=pool,
                        kv_dtype=kv, ssm_backend=ssm)
        ex = TorchExecutor(model_cfg, staged, run, device="cuda")
        eng = PrefillEngine(EngineConfig(model=model_cfg, num_stages=N_STAGES, tp=1,
                                         num_chunks=N_CHUNKS, max_batch=BATCH,
                                         buckets=(seq,), partition="uniform"), ex)
        for r in make_requests(REQUESTS, seq, model_cfg.vocab_size, seed=0):
            eng.submit(r)
        choices.clear()
        with swapped(layers_mod, "moe_route", record_choices if record and model_cfg.moe
                     else route):
            eng.run_until_drained()
        done = sorted(eng.done, key=lambda r: r.rid)
        name = f"{arch} {model_cfg.dtype} {'mbkr' if run.mbkr else 'terapipe'} " \
            f"{remote}/{attn}/{pool}/{kv}" + \
            ("" if model_cfg.family in ("dense", "moe") else f"/ssd {ssm}")
        check(len(done) == REQUESTS, f"{name}: {len(done)} of {REQUESTS} answered")
        logits = np.stack([r.result for r in done])
        check(logits.shape == (REQUESTS, pad_vocab(model_cfg.vocab_size)),
              f"{name}: logits shape {logits.shape}")
        check(bool(np.isfinite(logits).all()), f"{name}: non-finite logits")
        walls = [w["dur"] for w in ex.waves]
        log(f"  {name}: argmax {logits.argmax(-1).tolist()}, wave wall s "
            f"{[round(w, 4) for w in walls]}")
        return logits, list(choices)

    def flips(got: list, want: list) -> str:
        """How many (token, slot) router choices of a run differ from
        another's (call by call: the same waves, ticks and layers; every
        stage row, the bubble's included); nothing where either run did
        not record them."""
        if not got or not want:
            return ""
        check(len(got) == len(want), "the runs routed a different number of times")
        n = sum(int((a != b).sum()) for a, b in zip(got, want))
        total = sum(a.numel() for a in want)
        return f"; router choices differing {n} of {total} (token, slot)"

    def against(logits, want, what: str, extra: str = "") -> tuple:
        cos = (logits * want).sum(-1) / (np.linalg.norm(logits, axis=-1)
                                         * np.linalg.norm(want, axis=-1))
        err = np.abs(logits - want).max() / np.abs(want).max()
        same = int((logits.argmax(-1) == want.argmax(-1)).sum())
        log(f"    vs {what}: cosine min {cos.min():.6f}, max abs err "
            f"{err:.3e} of max|logit|, argmax equal {same}/{len(want)}{extra}")
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

    def hold(model_cfg, run, want, what: str, name: str) -> None:
        logits, picked = run
        held = model_cfg.dtype == "float32" or BF16_LOGIT_TOL[arch] is not None
        _, err, same = against(logits, want[0], what + ("" if held else
                                                       " (reported, not held)"),
                               flips(picked, want[1]))
        if held and not passes(model_cfg, err, same):
            failures.append(f"{arch} {model_cfg.dtype} {name}: argmax equal {same}, "
                            f"logits err {err} vs the {what}")

    def planted(model_cfg, staged, want, what: str) -> None:
        combo, kind = spec["combos"][0], spec["faults"]
        real = getattr(ops, kind)
        bf16 = model_cfg.dtype == "bfloat16"
        shadow = (kind,) if kind == "ssd" and bf16 else per_launch if bf16 else ()
        runs = [(name, fn, True, combo) for name, fn in planted_faults(kind, real).items()]
        if shadow:   # the real kernels first, on every combination
            runs = [("none (the kernels themselves)", None, False, c)
                    for c in (spec["combos"] if per_launch else [combo])] + runs
        for fault, fn, is_fault, run_combo in runs:
            worst = [0.0]
            with contextlib.ExitStack() as stack:
                for k in shadow:
                    wrapped = fn if (k == kind and fn is not None) else getattr(ops, k)
                    stack.enter_context(swapped(ops, k, shadowed(wrapped, k, worst)))
                if not shadow:
                    stack.enter_context(swapped(ops, kind, fn))
                got = serve(model_cfg, staged, *run_combo)
            log(f"  planted fault: {fault} ({'/'.join(run_combo)})")
            _, err, same = against(got[0], want[0], what, flips(got[1], want[1]))
            if shadow:
                log(f"    every {'/'.join(shadow)} launch vs its plain version: worst "
                    f"{worst[0]:.3e} of its tolerance")
                if (worst[0] > 1.0) != is_fault:
                    failures.append(f"{arch} bf16 per-launch check, planted fault "
                                    f"'{fault}': {worst[0]} of the tolerance")
            # a fault held per launch in bf16 may hide under the bf16 spread
            if is_fault and not shadow and passes(model_cfg, err, same):
                failures.append(f"{arch} {model_cfg.dtype}: planted fault '{fault}' "
                                f"passes the check ({err})")

    # ---- bf16, the main path: the launch counts are read around it
    staged = weights(cfg)
    with swapped(attention, "_BACKENDS",
                 dict(attention._BACKENDS, torch=p32_witness())):
        witness = {kv: serve(cfg, staged, "qship", "torch", "torch", kv, ssm="torch")
                   for kv in kvs}
    log(f"  (the runs above: witness) top-2 margin of max|logit| per "
        f"request: {margins(witness['auto'][0])}")
    torch_be = None
    if arch == "qwen3-8b" or per_launch:
        torch_be = serve(cfg, staged, "qship", "torch", "torch", "auto")
    if per_launch:     # the spread of two bf16 summation orders
        log("  bf16 spread: the torch backend (p rounded to bf16) against the witness")
        against(torch_be[0], witness["auto"][0], "witness", flips(torch_be[1],
                                                                  witness["auto"][1]))
    ops.reset_launches()
    bf16 = {combo: serve(cfg, staged, *combo, record=False) for combo in spec["combos"]}
    launches = dict(ops.LAUNCHES)
    log(f"  launches on the {arch} main path: {launches}")
    for name in spec["kernels"]:
        check(launches[name] > 0, f"kernel {name} was not launched on the {arch} main path")
        results[name].setdefault("launches_by_path", {})[arch] = launches[name]
    # where a bf16 wave's device time goes; every K4 launch of it must run
    # the tensor-core body
    if spec.get("wave", True):
        split = wave_split(arch, staged)
        if "ssd" in spec["kernels"]:
            k4 = split["k4_launches"]
            check(k4["tensor cores"] > 0 and k4["cuda cores"] == 0,
                  f"{arch} bf16 wave: K4 launches by body {k4}")
    for combo, run in bf16.items():
        log(f"  bf16 {'/'.join(combo)}")
        hold(cfg, run, witness[combo[3]], "witness", "/".join(combo))
        if torch_be is not None and combo[3] == "auto":
            against(run[0], torch_be[0], "torch backend", flips(run[1], torch_be[1]))
    for remote in ("qship", "fetch"):
        pair = [bf16.get((remote, "cuda", pool, "auto")) for pool in ("cuda", "paged")]
        if pair[0] is None or pair[1] is None:
            continue
        log(f"  bf16 {remote}: cuda pool (K2) against paged pool (K3)")
        _, err, _ = against(pair[0][0], pair[1][0], "paged pool")
        if err > BF16_POOL_PAIR_TOL:
            failures.append(f"bf16 {remote}: K2 and K3 pools differ by {err}")
    planted(cfg, staged, witness["auto"], "witness")
    del staged, witness, torch_be, bf16
    torch.cuda.empty_cache()

    # ---- fp32: the argmax of every request, every combination
    cfg32 = replace(cfg, dtype="float32", num_layers=spec.get("fp32_layers", cfg.num_layers))
    staged = weights(cfg32)
    refs = {kv: serve(cfg32, staged, "qship", "torch", "torch", kv, ssm="torch")
            for kv in kvs}
    for combo in spec["combos"]:
        hold(cfg32, serve(cfg32, staged, *combo), refs[combo[3]], "torch backends",
             "/".join(combo))
    planted(cfg32, staged, refs["auto"], "torch backends")
    del staged
    torch.cuda.empty_cache()
    check(not failures, "; ".join(failures))


def serve_phase(results: dict) -> None:
    for arch in SERVE_MODELS:
        t0 = time.perf_counter()
        serve_model(arch, results)
        log(f"[serve] {arch} {time.perf_counter() - t0:.1f} s")


# ------------------------------------------------ baselines + continuous

GP_ARRIVAL_RATE, GP_SLO_MS = 2.0, 4000.0


def k1_faults(real):
    """Wrong versions of ``ops.chunk_attention`` (K1) for the GPipe check:
    a causal block that lets every query see every key, and one that drops
    the last 64-key tile of the sequence."""
    def sees_the_future(q, k, v, *, causal_offset=0, **kw):
        return real(q, k, v, causal_offset=k.shape[1], **kw)

    def last_tile_dropped(q, k, v, **kw):
        return real(q, k, v, kv_len=k.shape[1] - 64, **kw)

    return {"K1 lets every query see every key": sees_the_future,
            "K1 drops the last 64-key tile": last_tile_dropped}


def baselines_phase(results: dict) -> None:
    """qwen3-8b at full width and depth (36 layers), bf16, N = 8 stages,
    S = 4096, random weights from seed 0, the same GP_REQUESTS requests
    through four paths of the port:

    - MOCAP (``PrefillEngine`` + ``TorchExecutor``, qship/cuda, waves of
      2) and terapipe (the same without MBKR): the reference logits;
    - GPipe (``build_plan(mode="gpipe")``, M = 8 microbatches) through
      ``prefill_pipeline`` in one call, its path: the launch counters are
      set to 0 just before and read just after, and K1 must have launched
      exactly layers_per_stage x (M + N - 1) times and nothing else; its
      logits are held against MOCAP's at the bf16 serve limit
      (BF16_LOGIT_TOL, fraction of max|logit|), and each planted K1 fault
      (``k1_faults``) must break that limit. The argmax must equal MOCAP's
      for every request whose MOCAP top-2 margin (a fraction of max|logit|)
      is above the spread of two bf16 summation orders, measured in the
      same run as terapipe's logits against MOCAP's; the argmax of a
      request with a smaller margin may flip under any summation order
      (terapipe's does too) and is reported, not held;
    - ``ContinuousEngine`` + ``TorchExecutor`` (EDF, an SLO, Poisson
      arrivals, ``max_batch`` 2, qship/cuda), its path with K1 and K2
      launched: every request answered, its logits against MOCAP's at the
      same limit with argmax equal, the waves in the scheduler's admission
      order, two to a wave;

    and the wall time of each path on the same requests beside the card's
    clocks (recorded, not held: on one card the stage axis is a batch, not
    a pipeline of chips). The scheduler's TTFT is the analytic model's and
    is printed under its profile's name. Then fp32 at full depth, where
    summation order moves the logits by ~1e-5 of max|logit|: GPipe on K1
    against MOCAP on the ``torch`` backends, every request's argmax equal
    and the logits within FP32_LOGIT_TOL."""
    import numpy as np
    import torch
    from repro_torch.configs import RunConfig, get_config, replace
    from repro_torch.core import pipeline as pp
    from repro_torch.core.staging import init_staged
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import make_requests, measured_completions
    from repro_torch.runtime.engine import (ContinuousEngine, EngineConfig,
                                            PrefillEngine, TorchExecutor)

    arch = "qwen3-8b"
    seq, n, m = N_CHUNKS * CHUNK, N_STAGES, N_CHUNKS
    failures = []

    def runs(model_cfg, **kw):
        return {mode: RunConfig(num_chunks=m, num_stages=n, mbkr=mode == "mocap",
                                remote_attn="qship", **kw)
                for mode in ("mocap", "terapipe")}

    def engine_run(model_cfg, staged, run, scheduler="batch"):
        ex = TorchExecutor(model_cfg, staged, run, device="cuda")
        ec = EngineConfig(model=model_cfg, num_stages=n, tp=1, num_chunks=m,
                          max_batch=BATCH, buckets=(seq,), partition="uniform",
                          policy="edf", slo=GP_SLO_MS / 1e3)
        eng = (ContinuousEngine if scheduler == "continuous" else PrefillEngine)(ec, ex)
        rate = GP_ARRIVAL_RATE if scheduler == "continuous" else 0.0
        for r in make_requests(GP_REQUESTS, seq, model_cfg.vocab_size, seed=0,
                               arrival_rate=rate):
            eng.submit(r)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        done = sorted(eng.done, key=lambda r: r.rid)
        check(len(done) == GP_REQUESTS, f"{scheduler} engine: {len(done)} answered")
        logits = np.stack([r.result for r in done])
        check(bool(np.isfinite(logits).all()), f"{scheduler} engine: non-finite logits")
        return logits, wall, eng, ex

    def gpipe(model_cfg, staged, attn="cuda"):
        run = RunConfig(num_chunks=GP_REQUESTS // GP_BM, num_stages=n, attn_backend=attn)
        plan = pp.build_plan(model_cfg, n, seq, run, mode="gpipe")
        toks = np.stack([r.tokens for r in make_requests(
            GP_REQUESTS, seq, model_cfg.vocab_size, seed=0)])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pp.prefill_pipeline(model_cfg, staged, toks, plan, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        logits = out.cpu().numpy()
        check(bool(np.isfinite(logits).all()), "gpipe: non-finite logits")
        return logits, wall, plan

    def against(got, want, what: str):
        err = float(np.abs(got - want).max() / np.abs(want).max())
        equal = got.argmax(-1) == want.argmax(-1)
        log(f"    {what}: max abs err {err:.3e} of max|logit|, argmax equal "
            f"{int(equal.sum())}/{len(want)}, differs for requests "
            f"{np.flatnonzero(~equal).tolist()}")
        return err, int(equal.sum()), equal

    cfg = get_config(arch)
    mocap_plan = pp.build_plan(cfg, n, seq, runs(cfg)["mocap"])
    lps = mocap_plan.layers_per_stage
    gen = torch.Generator(device="cuda").manual_seed(0)
    staged = init_staged(cfg, mocap_plan, gen, device="cuda")
    torch.cuda.synchronize()
    log(f"[baselines + continuous] {arch} bf16, {cfg.num_layers} layers (lps {lps}), "
        f"N={n}, S={seq}, {GP_REQUESTS} requests; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB of weights on the card")
    walls = {}
    cuda_runs = runs(cfg, attn_backend="cuda", pool_backend="cuda")
    mocap, walls["mocap"], _, ex = engine_run(cfg, staged, cuda_runs["mocap"])
    log(f"  mocap (PrefillEngine, {len(ex.waves)} waves of {BATCH}): wave wall s "
        f"{[round(w['dur'], 4) for w in ex.waves]}; card: {card_clocks()}")
    tera, walls["terapipe"], _, ex = engine_run(cfg, staged, cuda_runs["terapipe"])
    log(f"  terapipe (PrefillEngine, {len(ex.waves)} waves of {BATCH}): wave wall s "
        f"{[round(w['dur'], 4) for w in ex.waves]}; card: {card_clocks()}")
    top2 = np.sort(mocap, axis=-1)[:, -2:]
    margin = (top2[:, 1] - top2[:, 0]) / np.abs(mocap).max()
    spread, _, _ = against(tera, mocap, "terapipe vs mocap")
    wide = margin > spread
    log(f"    MOCAP's top-2 margins of max|logit|: {[round(float(x), 5) for x in margin]}; "
        f"above the bf16 spread {spread:.3e}: requests {np.flatnonzero(wide).tolist()}")

    # ---- GPipe, its path: K1 alone, exactly lps x (M + N - 1) launches
    ops.reset_launches()
    gp, wall_first, gplan = gpipe(cfg, staged)
    launches = dict(ops.LAUNCHES)
    want_k1 = lps * gplan.num_ticks
    log(f"  gpipe (M={gplan.num_chunks} microbatches of {GP_BM}, {gplan.num_ticks} "
        f"ticks): launches {launches} (K1 expected {lps} x {gplan.num_ticks} = {want_k1}); "
        f"first call {wall_first:.4f} s")
    check(launches["chunk_attention"] == want_k1 and
          sum(launches.values()) == want_k1,
          f"gpipe path: launches {launches}, K1 expected exactly {want_k1}")
    results["chunk_attention"].setdefault("launches_by_path", {})["gpipe"] = want_k1
    err, _, equal = against(gp, mocap, "gpipe vs mocap")
    if err > BF16_LOGIT_TOL[arch] or not equal[wide].all():
        failures.append(f"gpipe bf16: logits err {err}, argmax differs for requests "
                        f"{np.flatnonzero(wide & ~equal).tolist()} of margin above "
                        f"the spread {spread}")
    for fault, fn in k1_faults(ops.chunk_attention).items():
        with swapped(ops, "chunk_attention", fn):
            bad, _, _ = gpipe(cfg, staged)
        log(f"  planted fault: {fault}")
        f_err, _, _ = against(bad, mocap, "gpipe vs mocap")
        if f_err <= BF16_LOGIT_TOL[arch]:
            failures.append(f"gpipe bf16: planted fault '{fault}' passes ({f_err})")
    _, walls["gpipe"], _ = gpipe(cfg, staged)

    # ---- ContinuousEngine + TorchExecutor, its path: K1 and K2
    ops.reset_launches()
    cont, walls["continuous"], eng, ex = engine_run(cfg, staged, cuda_runs["mocap"],
                                                    scheduler="continuous")
    launches = dict(ops.LAUNCHES)
    log(f"  continuous (EDF, SLO {GP_SLO_MS:.0f} ms, Poisson {GP_ARRIVAL_RATE} req/s, "
        f"max_batch {BATCH}): launches {launches}")
    for name in ("chunk_attention", "pool_attention"):
        check(launches[name] > 0, f"kernel {name} was not launched on the continuous path")
        results[name].setdefault("launches_by_path", {})["continuous"] = launches[name]
    order = [r.rid for r in eng.done]
    waves = [w["rids"] for w in ex.waves]
    check(sum(waves, []) == order and all(len(w) <= BATCH for w in waves),
          f"continuous: waves {waves} do not follow the admission order {order}")
    met = eng.metrics()
    done_at = measured_completions(ex.waves)
    log(f"    admission order {order}, waves {waves}, wave wall s "
        f"{[round(w['dur'], 4) for w in ex.waves]}; measured completion s "
        f"{[round(done_at[r], 4) for r in order]}")
    log(f"    analytic ({eng.ec.hw.name}): sched clock {met['makespan']:.4f} s, avg TTFT "
        f"{met['avg_ttft']:.4f} s, p99 TTFT {met['p99_ttft']:.4f} s, SLO "
        f"{met['slo_met']}/{met['slo_total']}, completed {met['completed']}, "
        f"rejected {met['rejected']}")
    check(met["completed"] == GP_REQUESTS and met["rejected"] == 0,
          f"continuous: {met['completed']} completed, {met['rejected']} rejected")
    err, same, _ = against(cont, mocap, "continuous vs mocap")
    if err > BF16_LOGIT_TOL[arch] or same != GP_REQUESTS:
        failures.append(f"continuous bf16: logits err {err}, argmax equal {same}")
    log(f"  wall s of the same {GP_REQUESTS} requests on this card: "
        + ", ".join(f"{k} {v:.4f}" for k, v in walls.items())
        + f"; card after them: {card_clocks()}")
    results["chunk_attention"].setdefault("gpipe_shape", {})["path_walls_s"] = walls
    del staged
    torch.cuda.empty_cache()

    # ---- fp32: GPipe on K1 against MOCAP on the torch backends
    cfg32 = replace(cfg, dtype="float32")
    plan32 = pp.build_plan(cfg32, n, seq, runs(cfg32)["mocap"])
    staged = init_staged(cfg32, plan32, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    want, ref32, _, _ = engine_run(cfg32, staged, runs(cfg32, attn_backend="torch",
                                                        pool_backend="torch")["mocap"])
    got, wall32, _ = gpipe(cfg32, staged)
    log(f"  fp32, {cfg32.num_layers} layers: gpipe on K1 {wall32:.4f} s, mocap on the "
        f"torch backends {ref32:.4f} s")
    err, same, _ = against(got, want, "gpipe vs mocap (torch backends)")
    if err >= FP32_LOGIT_TOL[arch] or same != GP_REQUESTS:
        failures.append(f"gpipe fp32: logits err {err}, argmax equal {same}")
    del staged
    torch.cuda.empty_cache()
    check(not failures, "; ".join(failures))


# ------------------------------------------------------------------ decode

# K5 launches a decode step: one per attention layer (qwen3-8b 36 layers,
# zamba2-7b 13 applications of the shared block, mamba2-130m none)
DECODE_MODELS = {"qwen3-8b": 36, "zamba2-7b": 13, "mamba2-130m": 0}
DEC_BATCH, DEC_PROMPT, DEC_PAD, DEC_STEPS = 2, 512, 8, 8
# fractions of max|logit|: fp32 decode against forward on the longer
# sequence (the fp32 serve limit); bf16 decode against bf16 forward on the
# longer sequence and against the same decode with K5's plain version (the
# bf16 serve limit)
DEC_FP32_TOL, DEC_BF16_TOL = 1e-3, 0.1
# long-context decode: 4 rows at ragged positions between 8k and 32k - 16 in
# a 32768-token cache, 16 steps
LONG_CAP, LONG_STEPS = 32768, 16
LONG_POS = (8192, 15001, 24577, LONG_CAP - LONG_STEPS)


def decode_faults(real):
    """Wrong versions of the K5 wrapper ``real``, for showing that the
    decode checks fail a wrong kernel."""
    def last_key_dropped(q, k, v, kv_len, **kw):
        # the token just written at pos is never read
        return real(q, k, v, kv_len - 1, **kw)

    def kv_head0_only(q, k, v, kv_len, **kw):
        # every query head reads kv head 0
        return real(q, k[:, :, :1].expand_as(k).contiguous(),
                    v[:, :, :1].expand_as(v).contiguous(), kv_len, **kw)

    return {"K5 drops the key just written (kv_len - 1)": last_key_dropped,
            "K5 reads kv head 0 for every query head": kv_head0_only}


def decode_run(model, params, cache, toks):
    """``toks.shape[1]`` decode steps from ``cache`` (updated in place).
    Returns (logits [steps, B, Vpad] fp32, each step's wall seconds: host
    clock around the step, ending in a synchronize)."""
    import torch
    out, walls = [], []
    for t in range(toks.shape[1]):
        t0 = time.perf_counter()
        logits, cache = model.decode_step(params, cache, toks[:, t])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        out.append(logits)
    return torch.stack(out), walls


def frac(got, want) -> float:
    """max abs err of ``got`` as a fraction of max|want|."""
    return ((got - want).abs().max() / want.abs().max()).item()


def decode_bridge(arch: str, dtype: str, results: dict) -> list:
    """The prefill->decode bridge of one model at full width and depth
    (``tests/test_models.py::test_decode_continues_prefill`` at the card's
    size): B = 2 rows, a 512-token prompt through ``Model.forward(
    return_cache=True)``, the KV axis padded by 8, 8 ``Model.decode_step``s
    fed with seeded tokens.
    bf16, the decode main path: the launch counts are set to 0 just before
    the K5 run and read just after (exactly 8 x 36 / 13 / 0); the logits are
    held within DEC_BF16_TOL of max|logit| against bf16 ``forward`` on the
    prompt and the fed tokens (this holds the bf16 Mamba2 decode) and, where
    the model has attention, against the same decode with
    ``ref.decode_attention_plain`` in K5's place.
    fp32: every step's logits against ``forward`` on the prompt and the fed
    tokens at that position, within DEC_FP32_TOL of max|logit|; then each
    planted K5 fault (``decode_faults``) must break that limit and, with
    every K5 launch held against its plain version on its own inputs
    (``shadowed``), the per-launch check by 10x or more, where the real
    kernel stays within it. Returns the failures."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config, replace
    from repro_torch.kernels import ops, ref
    from repro_torch.models.api import build_model

    cfg = replace(get_config(arch), dtype=dtype)
    model = build_model(cfg)
    per_step = DECODE_MODELS[arch]
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (DEC_BATCH, DEC_PROMPT + DEC_STEPS),
                         generator=gen, device="cuda")
    _, prefill = model.forward(params, toks[:, :DEC_PROMPT], return_cache=True)
    if "k" in prefill:
        pad = (0, 0, 0, 0, 0, DEC_PAD)
        prefill = {**prefill, "k": F.pad(prefill["k"], pad), "v": F.pad(prefill["v"], pad)}
    torch.cuda.synchronize()
    log(f"[decode] {arch} {dtype}: weights + {DEC_PROMPT}-token prefill "
        f"{time.perf_counter() - t0:.2f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    def fresh():
        return {k: v.clone() for k, v in prefill.items()}

    def run(cache):
        return decode_run(model, params, cache, toks[:, DEC_PROMPT:])

    failures = []
    name = f"{arch} {dtype} bridge"
    want = model.forward(params, toks)[:, DEC_PROMPT:].transpose(0, 1)
    if dtype == "bfloat16":
        ops.reset_launches()
        got, walls = run(fresh())
        launches = dict(ops.LAUNCHES)
        n = launches["decode_attention"]
        log(f"  {name}: K5 launches {n} ({per_step} a step expected), launches "
            f"{launches}, step wall s {[round(w, 4) for w in walls]}")
        check(n == per_step * DEC_STEPS, f"{name}: {n} K5 launches, expected "
              f"{per_step * DEC_STEPS}")
        check(all(v == 0 for k, v in launches.items() if k != "decode_attention"),
              f"{name}: a prefill kernel launched during decode: {launches}")
        results.setdefault("decode_attention", {}).setdefault(
            "launches_by_path", {})[f"{arch} decode"] = n
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite logits")
        refs = {f"bf16 forward on {DEC_PROMPT + DEC_STEPS} tokens": want}
        if per_step:
            with swapped(ops, "decode_attention", ref.decode_attention_plain):
                refs["the plain-K5 witness"], _ = run(fresh())
        for what, ref_logits in refs.items():
            err = frac(got, ref_logits)
            log(f"  {name}: logits vs {what} {err:.3e} of max|logit| "
                f"(limit {DEC_BF16_TOL}), argmax equal "
                f"{int((got.argmax(-1) == ref_logits.argmax(-1)).sum())}/{got[..., 0].numel()}")
            if not err <= DEC_BF16_TOL:
                failures.append(f"{name}: {err} of max|logit| against {what}")
        return failures

    got, walls = run(fresh())
    err = frac(got, want)
    log(f"  {name}: logits vs forward on {DEC_PROMPT + DEC_STEPS} tokens {err:.3e} of "
        f"max|logit| (limit {DEC_FP32_TOL}), per step "
        f"{[f'{frac(g, w):.2e}' for g, w in zip(got, want)]}, argmax equal "
        f"{int((got.argmax(-1) == want.argmax(-1)).sum())}/{got[..., 0].numel()}")
    if not err < DEC_FP32_TOL:
        failures.append(f"{name}: {err} of max|logit| against forward")
    if per_step == 0:
        return failures
    runs = [("none (the kernel itself)", ops.decode_attention, False)] + \
        [(f, fn, True) for f, fn in decode_faults(ops.decode_attention).items()]
    for fault, fn, is_fault in runs:
        worst = [0.0]
        with swapped(ops, "decode_attention", shadowed(fn, "decode_attention", worst)):
            got, _ = run(fresh())
        err = frac(got, want)
        log(f"  planted fault: {fault}: logits {err:.3e} of max|logit|; every K5 launch "
            f"vs its plain version: worst {worst[0]:.3e} of its tolerance")
        results.setdefault("decode_attention", {}).setdefault("planted", {})[
            f"{arch} fp32 bridge: {fault}"] = dict(logits=err, per_launch=worst[0])
        if is_fault and (err < DEC_FP32_TOL or worst[0] < 10.0):
            failures.append(f"{name}: planted fault '{fault}' not caught "
                            f"(logits {err}, per launch {worst[0]})")
        if not is_fault and worst[0] > 1.0:
            failures.append(f"{name}: K5 off its plain version by {worst[0]} of the tolerance")
    return failures


def decode_long(arch: str, results: dict) -> list:
    """Long-context decode in bf16 at full width and depth: 4 rows at the
    ragged positions LONG_POS of a 32768-token cache whose K/V come from a
    seeded generator (SSM state zero), 16 steps. Every run starts from the
    same state: the k/v at and past each row's start position are rewritten
    before they are read, so rewinding ``pos`` (and zeroing the SSM state)
    restores it without a second copy of the cache. Runs: K5 (step times,
    launches exactly 16 x per step), its plain version in its place (step
    times; logits within DEC_BF16_TOL of K5's), K5 with every launch held
    against the plain version on its own inputs (within its tolerance),
    and the planted faults under the same per-launch check, which each must
    break by 10x or more (on an H100, "kv_len - 1" read 15.76x and 44.04x
    of the tolerance for qwen3-8b and zamba2-7b). Returns the failures."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.models.api import build_model

    cfg = get_config(arch)
    model = build_model(cfg)
    per_step = DECODE_MODELS[arch]
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(2)
    cache = model.init_cache(len(LONG_POS), LONG_CAP, device="cuda")
    for key in ("k", "v"):
        for layer in cache[key]:
            layer.normal_(generator=gen)
    pos0 = torch.tensor(LONG_POS, dtype=torch.int32, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (len(LONG_POS), LONG_STEPS), generator=gen,
                         device="cuda")
    torch.cuda.synchronize()
    log(f"[decode] {arch} long context: {len(LONG_POS)} rows at {list(LONG_POS)} of "
        f"{LONG_CAP}, {LONG_STEPS} steps; set-up {time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    def rewound():
        for key, t in cache.items():
            if key not in ("k", "v", "pos"):
                t.zero_()
        return {**cache, "pos": pos0.clone()}

    failures = []
    name = f"{arch} bf16 long context"
    ops.reset_launches()
    got, walls = decode_run(model, params, rewound(), toks)
    n = ops.LAUNCHES["decode_attention"]
    check(n == per_step * LONG_STEPS, f"{name}: {n} K5 launches")
    with swapped(ops, "decode_attention", ref.decode_attention_plain):
        plain, plain_walls = decode_run(model, params, rewound(), toks)
    err = frac(got, plain)
    # K5 alone on one layer's inputs of this state (kv_len = pos + 1)
    h, kvh, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = torch.randn((len(LONG_POS), h, d), generator=gen, device="cuda").to(torch.bfloat16)
    kv_len = pos0 + 1
    k5_ms = time_ms(lambda: ops.decode_attention(q, cache["k"][0], cache["v"][0], kv_len))
    k5_plain_ms = time_ms(lambda: ref.decode_attention_plain(q, cache["k"][0], cache["v"][0],
                                                             kv_len))
    step_ms = 1e3 * statistics.median(walls)
    plain_step_ms = 1e3 * statistics.median(plain_walls)
    log(f"  {name}: step median {step_ms:.3f} ms with K5, {plain_step_ms:.3f} ms with its "
        f"plain version; K5 {k5_ms:.4f} ms a launch (plain {k5_plain_ms:.4f}) x "
        f"{per_step} = {per_step * k5_ms:.3f} ms a step; logits K5 vs plain {err:.3e} "
        f"of max|logit| (limit {DEC_BF16_TOL})")
    results.setdefault("decode_attention", {}).setdefault("long_context", {})[arch] = dict(
        step_ms=step_ms, plain_step_ms=plain_step_ms, k5_ms=k5_ms, k5_plain_ms=k5_plain_ms,
        k5_ms_per_step=per_step * k5_ms, logits_vs_plain=err)
    if not err <= DEC_BF16_TOL:
        failures.append(f"{name}: logits {err} of max|logit| against the plain version")
    runs = [("none (the kernel itself)", ops.decode_attention, False)] + \
        [(f, fn, True) for f, fn in decode_faults(ops.decode_attention).items()]
    for fault, fn, is_fault in runs:
        worst = [0.0]
        with swapped(ops, "decode_attention", shadowed(fn, "decode_attention", worst)):
            decode_run(model, params, rewound(), toks)
        log(f"  {name}, planted fault: {fault}: every K5 launch vs its plain version: "
            f"worst {worst[0]:.3e} of its tolerance")
        results["decode_attention"]["long_context"][arch][fault] = worst[0]
        if is_fault and worst[0] < 10.0:
            failures.append(f"{name}: planted fault '{fault}' not caught "
                            f"(per launch {worst[0]})")
        if not is_fault and worst[0] > 1.0:
            failures.append(f"{name}: K5 off its plain version by {worst[0]} of the tolerance")
    return failures


def decode_phase(results: dict) -> None:
    import torch
    failures = []
    for arch in DECODE_MODELS:
        for dtype in ("bfloat16", "float32"):
            t0 = time.perf_counter()
            failures += decode_bridge(arch, dtype, results)
            torch.cuda.empty_cache()
            log(f"[decode] {arch} {dtype} bridge {time.perf_counter() - t0:.1f} s")
    for arch in ("qwen3-8b", "zamba2-7b"):
        t0 = time.perf_counter()
        failures += decode_long(arch, results)
        torch.cuda.empty_cache()
        log(f"[decode] {arch} long context {time.perf_counter() - t0:.1f} s")
    check(not failures, "; ".join(failures))


# ------------------------------------------------------------------- build

# the tensor-core body (K1-K3) and K5: (mangled template argument, name) of
# their element types
TC_KV_TYPES = (("13__nv_bfloat16", "bf16"), ("a", "int8"), ("13__nv_fp8_e4m3", "fp8"),
               ("f", "fp32"))
TC_WALKS = {"ChunkWalk": "K1", "StackWalk": "K2", "PagedWalk": "K3"}


def build_phase() -> None:
    """Compiles every library (``-Xptxas -v``) and prints, per library, the
    largest register count and spill of its kernels and, for each instance
    of the tensor-core bodies (K1-K3, K4) and of K5, its own registers and
    spills."""
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    start_fault_builds()                # beside the real build; waited for at first use
    build.build_all(verbose=True)
    log(f"[build] nvcc {time.perf_counter() - t0:.1f} s -> {build.build_dir()}")
    for name, text in sorted(build.LOGS.items()):
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", text)]
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", text)]
        log(f"  lib{name}.so: {len(regs)} kernels, registers max {max(regs, default=0)}, "
            f"spill stores max {max(spills, default=0)} bytes")
        for line in text.splitlines():   # ptxas warnings and advice
            if "ptxas" in line and ("warning" in line.lower() or "Performance" in line):
                log(f"    {line.strip()}")
        for part in text.split("Compiling entry function '")[1:]:
            fn = part.split("'", 1)[0]
            reg = re.search(r"Used (\d+) registers", part)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", part)
            usage = (f"registers {reg.group(1) if reg else '?'}, spill stores / loads "
                     f"{spill.group(1) + ' / ' + spill.group(2) if spill else '?'} bytes")
            if "ssd_tc_kernelI" in fn:
                n = re.search(r"Li(\d+)E", fn.split("ssd_tc_kernelI", 1)[1]).group(1)
                log(f"    K4 tensor-core body, bf16, P 64, N {n}: {usage}")
                continue
            if "attn_tc_kernelI" in fn:
                args = fn.split("attn_tc_kernelI", 1)[1]
                walk = next((k for w, k in TC_WALKS.items() if w in args), "?")
                what = f"{walk} tensor-core body, bf16 q"
            elif "decode_attn_kernelI" in fn:
                args = fn.split("decode_attn_kernelI", 1)[1]
                _, group, heads = re.findall(r"Li(\d+)E", args)[:3]
                what = f"K5 G {group}, {heads} kv head(s) a unit"
            else:
                continue
            kv = next((n for m, n in TC_KV_TYPES if args.startswith(m)), args[:24])
            d = re.search(r"Li(\d+)E", args).group(1)
            log(f"    {what}, {kv} K/V, D {d}: {usage}")


# -------------------------------------------------------------------- main

def card_clocks() -> str:
    """The card's SM clock, its maximum, power draw and temperature as
    nvidia-smi prints them (beside a timing: a card set below its power
    limit or running hot runs slower under load); what nvidia-smi says
    if it cannot."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
                          "temperature.gpu", "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return ((out.stdout or out.stderr).strip() or "not read").splitlines()[0]


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

        build_phase()

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
        t0 = time.perf_counter()
        decode_phase(results)
        log(f"[decode] {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        baselines_phase(results)
        log(f"[baselines + continuous] {time.perf_counter() - t0:.1f} s")
        torch.cuda.synchronize()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    kernels = []
    base = ("launches_by_path", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    for name, r in results.items():
        source, tpu = KERNELS[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": tpu, "tpu_kernel": tpu,
            "launches": sum(r["launches_by_path"].values()),
            "launches_by_path": r["launches_by_path"],
            "max_abs_err": r["max_abs_err"], "max_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            **{k: v for k, v in r.items() if k not in base}})
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
