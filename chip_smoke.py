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
   (K1-K3, K4) and of K5 (its query heads a thread, which must be
   ``ops.decode_head_slices``'; no K5 instance at D 128, nor at D 16 G 12
   / 16, may spill);
3. kernels: holds each CUDA kernel against its plain PyTorch version on the
   card, each output tensor at its own scale (see ``compare``), and times
   kernel, plain version and, where one exists, a PyTorch call computing
   the same function (never used by the port):
   - K1 chunk attention, K2 pool attention, K3 paged pool attention at
     qwen3-8b's shapes (head dim 128, GQA) in bf16 and fp32 with bf16/fp32,
     int8 and fp8 pages, at zamba2-7b's shared-block shape (head dim
     112, MHA) in bf16 with bf16, int8 and fp8 pages, and at granite-3-2b's
     (head dim 64, G 4), granite-moe-3b-a800m's (64, G 3) and
     stablelm-3b's (80, MHA) in bf16 and fp32 with the same pages, and at
     the GQA groups of qwen3-14b (40 / 8 heads of 128, G 5), llama3-70b
     (64 / 8, G 8), mistral-123b (96 / 8, G 12) and qwen3-235b (64 / 4, G
     16), llava-next-34b (56 / 8, G 7) and whisper-small's decoder (12 /
     12 heads of 64, in bf16 and fp32) in bf16 with the same pages (at G
     7 and G 16 also the two planted K2 faults on the tensor-core body,
     which must break the check; at
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
   - K1-K3 at [long]'s shapes (C = 4096: K1's causal self block, K2
     over 6 slots of 4096 keys, K3 off pages of 4096 tokens with bf16,
     int8 and fp8 pages; C = 16384, one row a stage group: the same with
     bf16 pages; C = 4096 at zamba2-7b's shared block, 32 heads of 112,
     MHA, bf16 pages), held on every row's last 512 queries and timed
     beside the library calls (``long_attention_shapes``);
   - K1 at the GPipe baseline's shape: 8 rows of a whole 4096-token
     sequence against itself (C = T = 4096, causal offset 0), qwen3-8b's
     heads, bf16, held against the plain version on 2 rows, each query row
     at its own scale, which two planted K1 faults must break, and timed
     beside SDPA's causal time (``k1_gpipe_shape``);
   - K1 non-causal (``ops.full_attention``) at whisper-small's shapes,
     bf16 and fp32: the decoder's cross-attention (16 rows x 56 queries
     against 1500 encoder frames) and the encoder (2 rows x 1500 x 1500),
     neither a multiple of K1's tiles, with three planted faults that
     must break the check (the last drops the 28 keys past the last whole
     tile), timed beside
     SDPA's non-causal call (``k1_whisper_shapes``); and K1-K3 at the
     shapes whisper-small's pipeline launches them (C = 56, pages of 56
     tokens: K3's CUDA-core body), held and timed
     (``whisper_pipeline_shapes``); K1-K3 at the kv_split shard of
     qwen3-14b at tp 16 (3 query heads, 1 kv head of 128, 256 rows), with
     the planted K2 faults; at every K2 / K3 shape (whisper's pipeline
     shape included), K2's and K3's function also timed as one call of
     PyTorch's memory-efficient attention with an attn_bias over the
     invalid slots (``sdpa_pool_ms``);
   - K4 the Mamba2 SSD scan at zamba2-7b's and mamba2-130m's shapes in
     bf16 and fp32, with a non-zero init_state, one a_log / d_skip row per
     stage (Gs = 8), x, b and c dense and as strided views of one
     conv-output buffer (the layout the Mamba2 block hands over), and a
     case with G < H SSM groups; the bf16 time also in windows and from a
     torch.profiler trace, which must show the tensor-core body; and in
     bf16 at [long-ssm]'s launch length, T = 4096 (16 SSD chunks a launch),
     dense and strided, held whole and timed (``ssd_long_rows``);
   - K5 flash-decode at qwen3-8b's (GQA, head dim 128) and zamba2-7b's (MHA,
     head dim 112) decode shapes, at G 5, 7, 8, 12 and 16 (qwen3-14b's,
     llava-next-34b's, llama3-70b's, mistral-123b's and qwen3-235b's
     heads), G 16 over 8 kv heads (llama3-405b), G 1 at D 128
     (qwen2-moe-a2.7b, one kv head a unit) and at head
     dims 64 (granite-3-2b G 4, granite-moe-3b-a800m G 3, whisper-small
     G 1) and 80 (stablelm-3b, G 1), 8 rows over a 32768-token cache, and
     at whisper-small's cross-attention (8 rows over its 1500 frames),
     bf16 and fp32, timed with every row at full length (also in windows
     and from a torch.profiler trace) and held at ragged lengths (0, 1,
     ..., S) and at lengths 100x apart, with the tail past each length
     poisoned; at every shape past qwen3-8b's and zamba2-7b's the two
     planted K5 faults must break the check;
4. smoke parity: the small qwen3-8b, zamba2-7b, mamba2-130m, granite-3-2b,
   stablelm-3b, qwen2-moe-a2.7b and granite-moe-3b-a800m configs in fp32
   through the kernel backends on the card against the same pipeline on
   the CPU (plain versions);
5. serve: each model at full width (random weights from a seeded
   generator) through ``PrefillEngine`` + ``TorchExecutor``: N=8 stages,
   M=8 chunks of 512 tokens, 2 requests a wave, 4 requests. qwen3-8b
   (36 layers) under qship/fetch x cuda/paged pools plus one int8-page run;
   zamba2-7b (45 of 81 layers: one hybrid group a stage) under qship/cuda,
   fetch/paged and one int8-page run; mamba2-130m (24 layers) under
   terapipe; granite-3-2b (8 of 40 layers) under qship/cuda, fetch/paged
   and qship/cuda int8; stablelm-3b (32)
   under terapipe fetch/cuda and mocap qship/paged; qwen2-moe-a2.7b (24)
   and granite-moe-3b-a800m (8 of 32 layers) under two of qship/fetch x
   cuda/paged;
   qwen3-14b (8 of 40 layers, GQA group 5; K1-K3 held per launch) under qship/cuda,
   fetch/paged and qship/cuda int8; the paper's four models, llama3-70b
   (G 8; also int8 pages and a profiled wave), mistral-123b (G 12),
   qwen3-235b (MoE, 128 experts top 8, G 16) and llama3-405b (G 16), cut
   to 8 layers (one a stage, ``bf16_layers``; at full depth they do not
   fit the card) under qship/cuda and fetch/paged, bf16 only, one wave of
   2 requests a run, K1-K3 held per launch. The fp32 runs of qwen3-8b,
   zamba2-7b (one group a stage, one wave of 2 requests a run),
   granite-3-2b, stablelm-3b,
   qwen2-moe-a2.7b, granite-moe-3b-a800m and qwen3-14b take one layer a
   stage (``fp32_layers``); mamba2-130m's run at full depth. Each
   model's peak device memory is printed. Each model's bf16 runs are
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
   backends' (see ``serve_model``);
6. long: qwen3-8b at full width, bf16, through ``PrefillEngine`` +
   ``TorchExecutor`` at the engine's default buckets, at the largest, S =
   131072 (N 8, M 8, C 16384, one request a wave): at 8 layers a mocap
   qship/cuda wave and a qship/paged one with every K1, K2 and K3 launch
   held against its plain version on every row's last 512 queries, the two
   pools' logits within 1e-3, planted faults that drop a launch's keys past
   512 (K1) and past 4096 (K1, K2, K3); at S 32768 and 8 layers the four
   held combinations (qship/cuda and qship/paged on auto pages, fetch/paged
   int8, qship/paged fp8) against the tiled P32 witness, every K3 launch
   held per launch, the planted K2 faults and a planted K3 fault that drops
   a page's keys past 512; at full depth and S 131072 the counted mocap
   and terapipe waves under torch.profiler (launches against their closed
   forms, wall time, peak memory, the pools' bytes exactly the plan's
   18.79 / 24.16 GB, the per-stage peak kv_bytes ratio exactly 6/8, device
   time by category, mocap's product FLOPs against the meta count, bound /
   busy and MFU, mocap's logits against terapipe's) (see ``long_phase``);
7. long-ssm: the Mamba2 families at S = 32768 (N 8, M 8, C 4096, K4 16
   SSD chunks a launch), bf16, through ``PrefillEngine`` +
   ``TorchExecutor`` at the default buckets: zamba2-7b at one hybrid group
   a stage, one request, a mocap qship/cuda wave with every K1 and K2
   launch held on every row's last 512 queries and every K4 launch held
   whole, and a qship/paged wave with K1 and K3 held so, the two pools'
   logits within 1e-3, planted faults that drop a launch's keys past 512
   (K1, K2, K3) or start each SSD chunk past its first 512 positions from
   a zero state (K4); zamba2-7b at full depth (81 layers, 2 groups a
   stage), a wave of 2, mocap under torch.profiler and terapipe (launches
   against their
   closed forms, the pools exactly 13.15 / 16.91 GB, the kv_bytes ratio
   exactly 6/8, each peak within PEAK_SLACK of its meta count, mocap's
   product FLOPs against the count, device time by category, mocap's
   logits against terapipe's); mamba2-130m at full depth, a terapipe wave
   of 2 with every K4 launch held whole (45 launches) and the K4 fault
   (see ``long_ssm_phase``);
8. frontends: llava-next-34b (full width cut to 8 layers; 2880 patch
   embeddings then 1216 tokens, S = 4096, N = M = 8, C = 512: chunk 5
   straddles the front) and whisper-small (full width and depth: 1500
   frames into the encoder, 448 decoder tokens as N = M = 8 chunks of 56)
   through ``prefill_pipeline(embeds=)`` under qship/cuda and fetch/paged,
   2 rows: the launch counts read around the bf16 main path, logits
   against the witness, every K1-K3 launch held against its plain version
   with planted K2 faults (and, whisper-small, planted non-causal K1
   faults) that must break it, a timed wave through
   ``measure_prefill(embeds=)``; whisper-small's fp32 argmaxes against the
   ``torch`` backends (see ``frontend_model``);
9. decode: each model at full width through ``Model.forward(
   return_cache=True)`` on a 512-token prompt, the KV axis padded by 8, and
   8 ``Model.decode_step``s (the decode path's K5 launches counted, exactly
   36 a step for qwen3-8b, 13 for zamba2-7b, 0 for mamba2-130m, 40 for
   qwen3-14b, whose fp32 bridge takes 8 layers, ``fp32_layers``; 24 for
   qwen2-moe-a2.7b (G 1 at D 128; fp32 at 8 layers); the K5 shapes held
   per launch at 8 layers, 8 a step: granite-3-2b, granite-moe-3b-a800m,
   stablelm-3b, llava-next-34b after its 2880 patch embeddings, and the
   paper's four, llama3-70b (G 8), mistral-123b (G 12), qwen3-235b (G 16
   over 4 kv heads; fp32 at 2 layers) and llama3-405b (G 16 over 8; fp32
   at 2 layers); whisper-small at full depth after its 1500 frames on a
   440-token prompt, 24 a step, 12 of them its cross-attention): fp32
   logits against ``forward`` on the longer sequence (an MoE model's
   router choices that differ between the two reported), bf16 logits
   against bf16 ``forward`` and against the same decode with K5's plain
   version (reported, not held, for qwen2-moe-a2.7b and qwen3-235b, whose
   router flips experts near ties: ``BF16_LOGIT_TOL``); two planted K5
   faults must break the fp32 limit and a per-launch check of K5 against
   its plain version (each (row, head) at its own max|ref|; every model's
   bf16 launches held per launch too).
   Then long-context decode in bf16 at 8 layers (qwen3-8b, zamba2-7b, 7
   shared-block applications, and qwen3-235b): 4 rows at ragged positions
   in a 32768-token cache, 16 steps with K5, with its plain version, and
   with every K5 launch held against the plain version, which both planted
   faults must break by 10x (qwen3-235b's plain run routed as its held K5
   run; see ``decode_phase``);
10. baselines + continuous: qwen3-8b at full width and depth in bf16, the
   same 8 requests through MOCAP and terapipe (``PrefillEngine``), the GPipe
   baseline (``build_plan(mode="gpipe")``, M = 8, through
   ``prefill_pipeline``; K1 exactly layers_per_stage x (M + N - 1) times)
   and ``ContinuousEngine`` (EDF, an SLO, Poisson arrivals, waves of 2;
   K1 and K2): logits against MOCAP's (GPipe's argmax held where MOCAP's
   top-2 margin is above the measured bf16 spread), planted K1 faults, the waves in
   admission order, the four paths' wall times; then GPipe in fp32 (one
   layer a stage) against the ``torch`` backends (see ``baselines_phase``);
11. prefix: cross-request prefix KV reuse on qwen3-8b at full width and
   depth in bf16 (k = 6 shared chunks of 512): ``prefill_pipeline`` seeded
   from a ``return_kv`` pool with garbage in the hit region, bit-identical
   to the unseeded run under qship/cuda, fetch/paged and int8 pages (K1-K3
   held per launch), ``prefix_hit`` against its closed form, a witness
   that the garbage shows without the seed; ``ContinuousEngine`` +
   ``TorchExecutor`` with the prefix cache off and on (logits bit-identical,
   every wave after the first seeded); a ``HostOffloadStager`` round trip
   (see ``prefix_phase``);
12. obs: the device half of observability on qwen3-8b at full width and
   depth in bf16, qship/``cuda``: stage telemetry on against off
   (bit-identical logits, equal launches and profiler device activities,
   occupancy and wire bytes against their closed forms), each stage's
   peak KV bytes under MBKR against terapipe, tick spans from CUDA events
   against the wave's wall time, a timed launch frame, the health
   sentinel armed (healthy: no alert) and on one stage's NaN weights, a
   calibration of the cost model from ``hgx-b200`` to the measured spans,
   and the serve CLI once with ``--trace-out --metrics-out --health
   --calibrate`` (see ``obs_phase``);
13. fleet: two qwen3-8b cells (bf16, full depth; cell1 on int8 pages)
    behind the jsf router through the serve CLI, EDF, an SLO, Poisson
    arrivals, 8 requests: each completed once, both cells used, each
    argmax equal to a single cell's on the same pages and seed, an
    ``--options-in`` replay equal, the merged trace's rows per cell; then
    one cell drained with requests in flight through ``FleetFabric`` (see
    ``fleet_phase``);
14. tp: the manual tensor-parallel lowering (``TorchExecutor(layout=)``,
    the params through ``shard_params``), the card's name and power limit
    printed beside it: qwen3-8b at full width and depth at N 8 x tp 2
    under qship/cuda and fetch/paged against the tp 1 runs of the same
    weights (bf16; fp32 at one layer a stage within 1e-5), the ``tp``
    ledger bytes against their closed form; qwen3-14b at 8 layers in the
    kv_split view at tp 16 = (kv 8, qg 2), 40 -> 48 query heads (K1-K3 at
    G 3, D 128, held per launch, planted K2 faults); qwen2-moe-a2.7b at 8
    layers with expert parallelism at tp 8, 60 -> 64 experts, against tp 1
    (router flips reported; fp32 argmax held) (see ``tp_phase``);
15. train (``repro_torch.train``, the card's name and power limit beside
    it): one fp32 step of each family's smoke config (qwen3-8b,
    qwen2-moe-a2.7b, mamba2-130m, zamba2-7b, llava-next-34b, whisper-small)
    on the card against the same on the CPU (loss, every gradient leaf,
    the params after the step); grad_accum 4 against 1 on the card;
    qwen3-8b at full width cut to 8 layers in bf16, 4 steps of 2 x 4096
    tokens in 2 microbatches with remat (step 0's loss against ln V and an
    fp32 forward; step time, tokens/s, peak memory); the train CLI as a
    subprocess (stablelm-3b, 100m preset, 40 steps, checkpoints every 20)
    and a second one resumed from its step-20 checkpoint; no kernel
    launched over the phase (see ``train_phase``).

Then one JSON line of per-kernel numbers and, last, the result line.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import math
import re
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path
from typing import Optional

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

KERNEL_IDS = {"chunk_attention": "K1", "pool_attention": "K2", "pool_attention_paged": "K3",
              "ssd": "K4", "decode_attention": "K5"}

# serve-phase geometry; the kernel phases use the same shapes
N_STAGES, N_CHUNKS, CHUNK, BATCH, REQUESTS = 8, 8, 512, 2, 4
RAGGED_CHUNK = 500                 # K1's ragged query edge (not a multiple of 64)
# the baselines phase: 8 requests; GPipe over M = 8 microbatches of bm rows,
# K1 held against its plain version on GP_HELD rows of a tick's launch
GP_REQUESTS, GP_BM, GP_HELD = 8, 1, 2
K1_KINDS = ("int8", "fp8")         # K1's quantized pages, at every head dim


# [long]: qwen3-8b at full width at the reference engine's largest bucket,
# S = 131072 = LONG_M chunks of 16384 at N_STAGES = 8 (the geometry where
# MBKR keeps 6 slots a stage against terapipe's 8), one request a wave
# (a wave of two counts 95.41 GiB on meta): (a) at full depth, (b) at 8 layers
LONG_SEQ, LONG_M, LONG_BATCH = 131072, 8, 1
# (c): the held runs at 8 layers at S = 32768 (C 4096) against the P32
# witness, LONG_HELD_BATCH request (one halves the witness's fp32 scores)
HELD_SEQ, LONG_HELD_BATCH = 32768, 1
LONG_Q_BLOCK = 512           # the sliced per-launch check: every row, its last 512 queries
LONG_FAULT_KEYS = 512        # the long-only planted faults drop the keys past these
CHUNK_FAULT_KEYS = 4096      # and, on (b)'s launches of 16384 keys, past these
LONG_COMBO = ("qship", "cuda", "cuda", "auto")
LONG_PAGED = ("qship", "cuda", "paged", "auto")
LONG_HELD = (LONG_COMBO, LONG_PAGED, ("fetch", "cuda", "paged", "int8"),
             ("qship", "cuda", "paged", "fp8"))
LONG_TIMING = dict(iters=3, warmup=1)   # a long kernel call takes tens of ms

# [long-ssm]: the Mamba2 families at S = HELD_SEQ (N 8, M 8, C 4096): (a)
# zamba2-7b at full depth and (d) mamba2-130m at full depth, waves of
# SSM_LONG_BATCH requests; (b) zamba2-7b at one hybrid group a stage, one
# request (the plain SSD holding every K4 launch takes 8 rows, not 16)
SSM_LONG_BATCH, SSM_HELD_BATCH = 2, 1
SSD_FAULT_POS = 512          # the long-only K4 fault: SSD chunks past these start from zero


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------ timing

# the plain versions (tens of ms a call in the kernel phase) are timed over
# fewer calls than the kernels
PLAIN_TIMING = dict(iters=4, warmup=1)


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


def bound_ms(tag: str, *args, **kw):
    """(ms, "bytes" | "operations", flops): the least time the card could
    take for one call of kernel ``tag`` on these inputs, the larger of
    bytes over the memory rate and operations over the peak rate of the
    products' type, from ``roofline.kernel_work`` (the dry run's formula):
    each input byte read once, each output byte written once, and only the
    work these inputs need (K2 / K3 the valid (group, slot) pairs, K1 the
    causal pairs, K5 the rows' kv_len; masks and lengths as host values)."""
    from repro_torch.roofline import analysis
    flops, nbytes_, dtype = analysis.kernel_work(tag, *args, **kw)
    sec, by = analysis.kernel_bound(flops, nbytes_, dtype)
    return 1e3 * sec, by, flops


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
    valid = args[-1]
    rows = m.shape[0] // valid.shape[0]          # a group's rows
    check(not bool(valid[0].any()), f"{label}: group 0 has a valid slot")
    check(bool((m[:rows] == -1e30).all() and (l[:rows] == 0).all()
               and (acc[:rows] == 0).all()),
          f"{label}: an all-invalid group is not exactly (-1e30, 0, 0)")
    return got, err


def sdpa_pool_ms(q, k, v, valid, got, **timing) -> Optional[float]:
    """The time of one call of PyTorch's memory-efficient attention
    (``aten._scaled_dot_product_efficient_attention``, compute_log_sumexp)
    computing K2's (and K3's) function on the same inputs: each row's
    queries against the keys of every slot of its stack [S, GB, C, KVH, D],
    the slots its group may not read masked through ``attn_bias`` (-inf);
    its (out, lse) is K2's state normalised (out = acc / l, lse = m +
    log l). The GQA heads are expanded and the bias built outside the timed
    call. Its output is compared with the kernel's normalised state ``got``
    on the rows that read a slot (logged, not held). None, with the reason
    logged, if the call cannot run on these inputs. ``timing``: ``time_ms``'s
    options."""
    import torch
    s, gb, c, kvh, d = k.shape
    h = q.shape[2]
    groups = valid.shape[0]

    def keys(x):
        x = x.permute(1, 3, 0, 2, 4).reshape(gb, kvh, 1, s * c, d)
        return x.expand(gb, kvh, h // kvh, s * c, d).reshape(gb, h, s * c, d)
    qt, kt, vt = q.transpose(1, 2).contiguous(), keys(k), keys(v)
    mask = (~valid).repeat_interleave(gb // groups, 0)[:, :, None].expand(gb, s, c)
    bias = torch.zeros((gb, 1, c, s * c), dtype=q.dtype, device=q.device)
    bias.masked_fill_(mask.reshape(gb, 1, 1, s * c), float("-inf"))
    bias = bias.expand(gb, h, c, s * c)

    def call():
        return torch.ops.aten._scaled_dot_product_efficient_attention(
            qt, kt, vt, bias, True, 0.0, False, scale=1.0 / math.sqrt(d))
    try:
        out = call()[0]
        ms = time_ms(call, **timing)
    except RuntimeError as e:
        log(f"  sdpa (memory-efficient, attn_bias) cannot run here: {str(e)[:160]}")
        return None
    m, l, acc = got
    rows = valid.repeat_interleave(gb // groups, 0).any(1)
    norm = acc / l.transpose(1, 2)[..., None]
    err = (out.transpose(1, 2)[rows].float() - norm[rows]).abs().max().item()
    log(f"  sdpa (memory-efficient, attn_bias over {s} slots): {ms:.4f} ms a call; its out "
        f"vs the kernel's acc / l: max abs err {err:.3e} (max|acc / l| "
        f"{norm[rows].abs().max().item():.3e})")
    del qt, kt, vt, bias
    return ms


def attention_phase(results: dict, h: int, kvh: int, d: int, key=None,
                    fp32: bool = True, k2_faults: bool = False,
                    batch: int = BATCH) -> None:
    """K1-K3 at one model's attention shape: q [8 x batch, 512, h, d] (8
    stages x ``batch`` rows folded into the rows: batch 2, or the manual TP
    lowering's tp x 2), k/v with kvh heads. ``key`` None
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
    of ``pad_faults`` run too. ``k2_faults``: the planted K2 faults
    (``planted_faults``) on the tensor-core body's bf16 stack, each of
    which must break ``compare``'s limit. The K2 / K3 function is also
    timed as one call of PyTorch's memory-efficient attention
    (``sdpa_pool_ms``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    gb, c = N_STAGES * batch, CHUNK
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
            plain = time_ms(lambda: ref.chunk_attention_plain(q, k, v), **PLAIN_TIMING)
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True))
            b_ms, by, _ = bound_ms("chunk_attention", q, k, v, return_state=True)
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
            plain = time_ms(lambda: ref.pool_attention_plain(q, k, v, valid), **PLAIN_TIMING)
            b_ms, by, ops_n = bound_ms("pool_attention", q, k, v, valid.cpu())
            lib = sdpa_pool_ms(q, k, v, valid, got)
            record("pool_attention", ms=ms, windowed_ms=win_ms, profiler_ms=prof_ms,
                   plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=by)
            log(f"  time: kernel {ms:.4f} ms ({win_ms:.4f} ms a call in windows of "
                f"back-to-back calls), plain {plain:.4f} ms, bound {b_ms:.4f} ms ({by}), "
                f"{n_valid} valid (stage, slot), {ops_n / 1e9:.1f} GFLOP")
            if k2_faults:
                want = ref.pool_attention_plain(q, k, v, valid)
                for fault, fn in planted_faults("pool_attention", ops.pool_attention).items():
                    ratio = fault_ratio(fn(q, k, v, valid), want, name)
                    log(f"  planted fault on the tensor-core body: {fault}: worst "
                        f"{ratio:.3e} of the tolerance")
                    check(ratio > 1.0, f"K2 at {key}: planted fault '{fault}' passes ({ratio})")
                    results["pool_attention"].setdefault("planted", {})[
                        f"{key}: {fault}"] = ratio
                del want
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
        f"[{N_STAGES},{npages},{lps},{batch},{c},{kvh},{d}] pool")
    k3_err = 0.0
    k3_fns = (ops.pool_attention_paged, ref.pool_attention_paged_plain)
    handles = torch.arange(slots, dtype=torch.int32, device=dev)
    for name, dt in floats:
        q = randn(gb, c, h, d, dtype=dt)
        kp = randn(N_STAGES, npages, lps, batch, c, kvh, d, dtype=dt)
        vp = randn(N_STAGES, npages, lps, batch, c, kvh, d, dtype=dt)
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
                q, k_l, v_l, handles, valid, ppc=1), **PLAIN_TIMING)
            b_ms, by, _ = bound_ms("pool_attention_paged", q, k_l, v_l, handles.numel(),
                                   valid.cpu(), ppc=1)
            # the same function: K2's stack of the same slots
            lib = sdpa_pool_ms(q, k_l[:, :slots].movedim(1, 0).flatten(1, 2),
                               v_l[:, :slots].movedim(1, 0).flatten(1, 2), valid, got)
            record("pool_attention_paged", ms=ms, windowed_ms=win_ms, profiler_ms=prof_ms,
                   plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=by)
            log(f"  time: kernel {ms:.4f} ms ({win_ms:.4f} ms a call in windows of "
                f"back-to-back calls), plain {plain:.4f} ms, bound {b_ms:.4f} ms ({by})")
        del kp, vp
    # quantized pages with per-page scales read through the same handles
    q = randn(gb, c, h, d, dtype=torch.bfloat16)
    for kind in K1_KINDS:
        kp, ksp = quantize(randn(N_STAGES, npages, lps, batch, c, kvh, d), kind, (4, 6))
        vp, vsp = quantize(randn(N_STAGES, npages, lps, batch, c, kvh, d), kind, (4, 6))
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
            kp = randn(N_STAGES, npages * ppc, lps, batch, pt, kvh, d)
            vp = randn(N_STAGES, npages * ppc, lps, batch, pt, kvh, d)
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


# K5's bf16 tolerance per (row, head) (``head_ratio``): K5 and its plain
# version round fp32 results that differ by ~1e-6 to bf16, so they differ by
# at most one bf16 ulp, 2^-7 = 0.0078 of the (row, head)'s max|ref| at most
K5_BF16_HEAD_TOL = 1e-2


def head_ratio(got, want, in_dtype: str) -> float:
    """K5's error ([B, H, D] outputs) as a multiple of its tolerance at each
    (row, head)'s own max|ref| (bf16: ``K5_BF16_HEAD_TOL``; fp32:
    ``tolerance``), or inf where a value is not finite. Each (row, head) is
    a softmax average of its own keys: at ragged lengths a row over 32k keys
    is ~2x smaller than one over 8k, and heads differ as much, so the whole
    output's max|ref| would let an error in the smaller ones pass (a
    dropped key moves a long row by ~1/len). A kv_len = 0 row (max|ref| 0)
    must be exactly zero."""
    import torch
    g, r = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        return float("inf")
    tol = K5_BF16_HEAD_TOL if want.dtype == torch.bfloat16 else tolerance(want.dtype, in_dtype)
    scale = r.abs().amax(-1, keepdim=True).clamp(min=1e-30)
    return ((g - r).abs() / (tol * scale)).max().item()


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
                plain = time_ms(lambda: ref.ssd_plain(*xs, chunk=SSD_CHUNK, init_state=init),
                                **PLAIN_TIMING)
                b_ms, by, ops_n = bound_ms("ssd", *args,
                                           chunk=ops.ssd_chunk(t, SSD_CHUNK))
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


SSD_LONG_T = HELD_SEQ // LONG_M     # K4's launch at [long-ssm]'s chunk: 16 SSD chunks


def ssd_long_rows(results: dict) -> None:
    """K4 at [long-ssm]'s launch length T = SSD_LONG_T = 4096 (16 SSD
    chunks of 256 in one launch, the state carried in registers across
    them) at both SSD_SHAPES: 16 rows (8 stages x a wave of 2), bf16, a
    non-zero init_state, Gs = 8, x, b and c dense and as the strided views
    of one conv-output buffer, each held whole against ``ssd_plain``
    (``compare``). On the dense inputs the kernel timed (``time_ms`` /
    ``windowed_ms`` / ``profiled_ms``, which must show the tensor-core
    body, at LONG_TIMING's few calls), the plain version and the bound from
    ``roofline.kernel_work``; on the views the kernel's time. No PyTorch
    call computes the scan (library: none). Recorded under
    ``results["ssd"]["long_<T>"][arch]``."""
    import torch
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(3)
    rows, t = N_STAGES * SSM_LONG_BATCH, SSD_LONG_T
    out = results.setdefault("ssd", {}).setdefault(f"long_{t}", {})
    err = 0.0
    for arch, (h, p, n) in SSD_SHAPES.items():
        times = {}
        for strided in (False, True):
            layout = "strided views" if strided else "dense"
            log(f"[kernels] K4 ssd at [long-ssm]'s launch, {arch} bfloat16  x [{rows},{t},{h},"
                f"{p}], b/c [{rows},{t},1,{n}], Gs {N_STAGES}, init_state, {layout}")
            *xs, init = ssd_inputs(gen, rows, t, h, p, 1, n, torch.bfloat16, strided=strided)
            call = lambda: ops.ssd(*xs, chunk=SSD_CHUNK, init_state=init)   # noqa: E731
            want = ref.ssd_plain(*xs, chunk=SSD_CHUNK, init_state=init)
            err = max(err, compare(f"ssd {arch} T {t} {layout}", call(), want, "bfloat16",
                                   ("y", "state")))
            del want
            if strided:
                times["strided_ms"] = time_ms(call, **LONG_TIMING)
                log(f"  time: kernel {times['strided_ms']:.4f} ms")
                continue
            ms, win_ms = time_ms(call, **LONG_TIMING), windowed_ms(call, iters=3, warmup=0)
            prof_ms, seen = profiled_ms(call, "ssd_tc_kernel", calls=4)
            log(f"  torch.profiler: ssd_tc_kernel {seen} launches, "
                + (f"{prof_ms:.4f} ms device time each" if seen else "no device time seen"))
            check(seen > 0, f"K4 {arch} T {t}: the tensor-core body did not run")
            plain = time_ms(lambda: ref.ssd_plain(*xs, chunk=SSD_CHUNK, init_state=init),
                            **PLAIN_TIMING)
            b_ms, by, ops_n = bound_ms("ssd", *xs, init, chunk=ops.ssd_chunk(t, SSD_CHUNK))
            times.update(rows=rows, positions=t, heads=h, head_dim=p, state=n, ms=ms,
                         windowed_ms=win_ms, profiler_ms=prof_ms, plain_ms=plain,
                         library_ms=None, bound_ms=b_ms, bound_by=by)
            log(f"  time: kernel {ms:.4f} ms ({win_ms:.4f} ms a call in windows of "
                f"back-to-back calls), plain {plain:.4f} ms, bound {b_ms:.4f} ms ({by}), "
                f"{ops_n / 1e9:.1f} GFLOP")
        out[arch] = times
        torch.cuda.empty_cache()
    results["ssd"]["max_abs_err"] = max(results["ssd"].get("max_abs_err", 0.0), err)


# K5's decode shapes: arch -> (H, KVH, D, the key its times go under; None:
# the kernel's main row); every shape past qwen3-8b's and zamba2-7b's also
# with the planted K5 faults (``decode_faults``); whisper-small's cross-
# attention at its own cache length (DECODE_CROSS_S frames), every other
# shape over DECODE_KERNEL_S keys
DECODE_SHAPES = {"qwen3-8b": (32, 8, 128, None), "zamba2-7b": (32, 32, 112, "d112"),
                 "qwen3-14b": (40, 8, 128, "g5"), "mistral-123b": (96, 8, 128, "g12"),
                 "qwen3-235b": (64, 4, 128, "g16"), "llava-next-34b": (56, 8, 128, "g7"),
                 "llama3-70b": (64, 8, 128, "g8"), "llama3-405b": (128, 8, 128, "g16_kvh8"),
                 "qwen2-moe-a2.7b": (16, 16, 128, "d128_g1"),
                 "granite-3-2b": (32, 8, 64, "d64_g4"),
                 "granite-moe-3b-a800m": (24, 8, 64, "d64_g3"),
                 "stablelm-3b": (32, 32, 80, "d80"), "whisper-small": (12, 12, 64, "d64_g1"),
                 "whisper-small cross": (12, 12, 64, "d64_cross")}
DECODE_KERNEL_BATCH, DECODE_KERNEL_S = 8, 32768   # decode_32k, batch 128 cut to 8
DECODE_CROSS_S = 1500                              # whisper-small's encoder frames
# K5's held lengths for each cache length: (ragged 0 .. S, ~S/100 and ~S).
# Most lie off a 64-key boundary, so that a partial last tile meets the
# device-side split; at whisper-small's 1500 frames every length past 0
# does (1500 % 64 = 28)
DECODE_LENGTHS = {DECODE_KERNEL_S: ((0, 1, 77, 4099, 12345, 20001, DECODE_KERNEL_S - 1,
                                     DECODE_KERNEL_S),
                                    (300, 30000, 327, DECODE_KERNEL_S, 310, 31000, 299,
                                     32000)),
                  DECODE_CROSS_S: ((0, 1, 77, 190, 619, 950, DECODE_CROSS_S - 1,
                                    DECODE_CROSS_S),
                                   (15, 1371, 42, DECODE_CROSS_S, 25, 1437, 14, 1469))}


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
    trace. At every shape past qwen3-8b's and zamba2-7b's each planted K5
    fault (``decode_faults``) on the ragged lengths must break that limit.
    whisper-small's cross-attention shape runs over DECODE_CROSS_S keys
    (every frame valid on its path; its ragged and 100x-apart lengths in
    DECODE_LENGTHS)."""
    import torch
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    b = DECODE_KERNEL_BATCH
    err = 0.0
    for arch, (h, kvh, d, key) in DECODE_SHAPES.items():
        s = DECODE_CROSS_S if key == "d64_cross" else DECODE_KERNEL_S
        ragged, spread = (torch.tensor(x, dtype=torch.int32, device=dev)
                          for x in DECODE_LENGTHS[s])
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
                plain = time_ms(lambda: ref.decode_attention_plain(q, k, v, full), **PLAIN_TIMING)
                lib_call, backend = sdpa_decode(q, k, v, full)
                check((lib_call().squeeze(2).float() - want.float()).abs().max().item()
                      <= 2e-2 * want.float().abs().max().item(),
                      "the SDPA yardstick does not compute K5's function")
                lib = time_ms(lib_call)
                b_ms, by, _ = bound_ms("decode_attention", q, k, v, full.cpu())
                times = dict(ms=ms, windowed_ms=win_ms, profiler_ms=prof_ms, plain_ms=plain,
                             library_ms=lib, bound_ms=b_ms,
                             bound_by=by, library=f"scaled_dot_product_attention "
                             f"(enable_gqa, bool mask; backend {backend})")
                if key is None:
                    results.setdefault("decode_attention", {}).update(times)
                else:
                    results.setdefault("decode_attention", {})[key] = dict(
                        heads=h, kv_heads=kvh, head_dim=d, **times)
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
                if what == "ragged" and key not in (None, "d112"):
                    for fault, fn in decode_faults(ops.decode_attention).items():
                        ratio = fault_ratio((fn(q, k, v, lens),), (want,), name)
                        log(f"  planted fault: {fault}: worst {ratio:.3e} of the tolerance")
                        check(ratio > 1.0, f"K5 {arch} {name}: planted fault '{fault}' "
                              f"passes ({ratio})")
                        results["decode_attention"].setdefault("planted", {})[
                            f"{key} {name}: {fault}"] = ratio
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
    plain = time_ms(lambda: ref.chunk_attention_plain(*held, causal_offset=0), **PLAIN_TIMING)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                         enable_gqa=True))
    b_ms, by, _ = bound_ms("chunk_attention", q, k, v)
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
# and zamba2-7b: the key their times go under -> (H, KVH, D, also fp32 q);
# the GQA groups 5, 7, 8, 12 and 16 in bf16 only (their int8 and fp8 pages
# too, as at every shape), the planted K2 faults at the new groups G 7 and
# G 16
ATTN_SHAPES = {"d64": (32, 8, 64, True),        # granite-3-2b (G 4)
               "d64_g3": (24, 8, 64, True),     # granite-moe-3b-a800m (G 3)
               "d64_g1": (12, 12, 64, True),    # whisper-small's decoder (MHA)
               "d80": (32, 32, 80, True),       # stablelm-3b (MHA; the padded box)
               "d128_mha": (16, 16, 128, False),   # qwen2-moe-a2.7b (MHA, bf16 only)
               "g5": (40, 8, 128, False),       # qwen3-14b
               "g7": (56, 8, 128, False),       # llava-next-34b
               "g8": (64, 8, 128, False),       # llama3-70b
               "g12": (96, 8, 128, False),      # mistral-123b
               "g16": (64, 4, 128, False),      # qwen3-235b (llama3-405b: 128 / 8)
               # qwen3-14b's kv_split shard at tp 16: 3 query heads, 1 kv head
               "g3_d128": (3, 1, 128, False)}
# rows a stage where a shape's path folds more than BATCH (the tp shards)
ATTN_BATCH = {"g3_d128": 16 * BATCH}
K2_FAULT_SHAPES = ("g7", "g16", "g3_d128")
# whisper-small's non-causal K1 shapes (12 heads of 64, MHA): the decoder's
# cross-attention, a chunk of WHISPER_C queries of N_STAGES x BATCH rows
# against the F = DECODE_CROSS_S encoder frames, and the encoder, F queries
# of BATCH rows against themselves; neither count is a multiple of K1's
# 64-row / 64-key tiles
WHISPER_C = 56


def k1_whisper_shapes(results: dict) -> None:
    """K1 non-causal (``ops.full_attention``) at whisper-small's cross and
    encoder shapes, bf16 and fp32, against the plain version (``compare``),
    with a partial last query tile and a partial last key tile; in bf16 each
    planted fault of ``full_attention_faults`` on the kernel must break that
    limit, the one that drops the F % 64 = 28 keys past the last whole
    tile among them.
    Times (bf16): ``time_ms``, ``windowed_ms``, ``profiled_ms``, the plain
    version's, SDPA's non-causal call; recorded under
    ``results["chunk_attention"]["whisper_cross" / "whisper_encoder"]``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    h, d, f = 12, 64, DECODE_CROSS_S
    k1 = results["chunk_attention"]
    for name, rows, c in (("whisper_cross", N_STAGES * BATCH, WHISPER_C),
                          ("whisper_encoder", BATCH, f)):
        for dname, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            log(f"[kernels] K1 full_attention at {name}  q [{rows},{c},{h},{d}], "
                f"k/v [{rows},{f},{h},{d}] {dname}, non-causal")
            q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dt)
                       for shape in ((rows, c, h, d), (rows, f, h, d), (rows, f, h, d)))
            got = ops.full_attention(q, k, v)
            want = ref.chunk_attention_plain(q, k, v, causal_offset=f)[0]
            k1["max_abs_err"] = max(k1.get("max_abs_err", 0.0),
                                    compare(f"{name} {dname}", (got,), (want,), dname,
                                            ("out",)))
            if dname == "float32":
                continue
            for fault, fn in full_attention_faults(ops.chunk_attention).items():
                ratio = fault_ratio((fn(q, k, v, causal_offset=f),), (want,), dname)
                log(f"  planted fault on the kernel: {fault}: worst {ratio:.3e} of the "
                    f"tolerance")
                check(ratio > 1.0, f"K1 at {name}: planted fault '{fault}' passes ({ratio})")
                k1.setdefault("planted", {})[f"{name}: {fault}"] = ratio
            call = lambda: ops.full_attention(q, k, v)
            ms, win_ms = time_ms(call), windowed_ms(call)
            prof_ms, seen = profiled_ms(call, "ChunkWalk")
            plain = time_ms(lambda: ref.chunk_attention_plain(q, k, v, causal_offset=f),
                            **PLAIN_TIMING)
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            lib = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
            b_ms, by, _ = bound_ms("chunk_attention", q, k, v, causal_offset=f)
            k1[name] = dict(heads=h, kv_heads=h, head_dim=d, rows=rows, queries=c, keys=f,
                            ms=ms, windowed_ms=win_ms, profiler_ms=prof_ms, plain_ms=plain,
                            library_ms=lib, bound_ms=b_ms, bound_by=by)
            log(f"  torch.profiler: attn_tc_kernel<ChunkWalk> {seen} launches, "
                + (f"{prof_ms:.4f} ms device time each" if seen else "no device time seen"))
            log(f"  time: kernel {ms:.4f} ms ({win_ms:.4f} ms a call in windows), plain "
                f"{plain:.4f} ms, sdpa {lib:.4f} ms, bound {b_ms:.4f} ms ({by})")
            del qt, kt, vt
        del q, k, v, got, want
        torch.cuda.empty_cache()


def whisper_pipeline_shapes(results: dict) -> None:
    """K1-K3 at the shapes whisper-small's pipeline launches them, bf16:
    N_STAGES x BATCH rows of WHISPER_C = 56 queries, 12 heads of 64. K1's
    causal self block and K2 over a stack of 6 stored chunks of 56 keys
    run the tensor-core body; K3 off pages of 56 tokens (one a chunk) runs
    the CUDA-core body (``paged_tc_fits`` wants pages that fill 64-key
    tiles). Each is held against its plain version (``compare``) and timed
    as ``attention_phase`` times its kernel (SDPA's causal call beside
    K1, the memory-efficient SDPA call of ``sdpa_pool_ms`` beside K2 and
    K3); recorded under ``results[kernel]["whisper_pipe"]``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    h, d, gb, c, slots = 12, 64, N_STAGES * BATCH, WHISPER_C, 6

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    valid = torch.zeros((N_STAGES, slots), dtype=torch.bool, device=dev)
    for s in range(N_STAGES):           # stage s at phase s: min(s, 6) slots
        valid[s, :min(s, slots)] = True
    q, k, v = randn(gb, c, h, d), randn(gb, c, h, d), randn(gb, c, h, d)
    k_st, v_st = randn(slots, gb, c, h, d), randn(slots, gb, c, h, d)
    k_pg, v_pg = (randn(N_STAGES, slots + 1, BATCH, c, h, d) for _ in range(2))
    handles = torch.arange(slots, dtype=torch.int32, device=dev)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    valid_h = valid.cpu()
    cases = (("chunk_attention", "ChunkWalk", "tensor-core",
              lambda: ops.chunk_attention(q, k, v, return_state=True),
              lambda: ref.chunk_attention_plain(q, k, v),
              ((q, k, v), dict(return_state=True)),
              lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)),
             ("pool_attention", "StackWalk", "tensor-core",
              lambda: ops.pool_attention(q, k_st, v_st, valid),
              lambda: ref.pool_attention_plain(q, k_st, v_st, valid),
              ((q, k_st, v_st, valid_h), {}),
              lambda got: sdpa_pool_ms(q, k_st, v_st, valid, got)),
             ("pool_attention_paged", "paged_attn_kernel", "CUDA-core",
              lambda: ops.pool_attention_paged(q, k_pg, v_pg, handles, valid, ppc=1),
              lambda: ref.pool_attention_paged_plain(q, k_pg, v_pg, handles, valid, ppc=1),
              ((q, k_pg, v_pg, handles.numel(), valid_h), dict(ppc=1)),
              lambda got: sdpa_pool_ms(q, *(x[:, :slots].movedim(1, 0).flatten(1, 2)
                                           for x in (k_pg, v_pg)), valid, got)))
    for kernel, tag, body, call, plain_call, (w_args, w_kw), lib_call in cases:
        log(f"[kernels] {kernel} at whisper-small's pipeline shape: q [{gb},{c},{h},{d}], "
            f"{body} body")
        got = call()
        res = results[kernel]
        res["max_abs_err"] = max(res.get("max_abs_err", 0.0), compare(
            f"{kernel} whisper pipeline bfloat16", got, plain_call(), "bfloat16"))
        ms, win_ms = time_ms(call), windowed_ms(call)
        prof_ms, seen = profiled_ms(call, tag)
        plain = time_ms(plain_call, **PLAIN_TIMING)
        lib = (time_ms(lib_call) if kernel == "chunk_attention"
               else lib_call(got))        # K2 / K3: the memory-efficient SDPA call
        b_ms, by, _ = bound_ms(kernel, *w_args, **w_kw)
        res["whisper_pipe"] = dict(heads=h, kv_heads=h, head_dim=d, rows=gb, queries=c,
                                   page_tokens=c, body=body, ms=ms, windowed_ms=win_ms,
                                   profiler_ms=prof_ms, plain_ms=plain, library_ms=lib,
                                   bound_ms=b_ms, bound_by=by)
        log(f"  torch.profiler: {tag} {seen} launches, "
            + (f"{prof_ms:.4f} ms device time each" if seen else "no device time seen"))
        log(f"  time: kernel {ms:.4f} ms ({win_ms:.4f} ms a call in windows), plain "
            f"{plain:.4f} ms, "
            + (f"sdpa {lib:.4f} ms, " if lib is not None else "")
            + f"bound {b_ms:.4f} ms ({by})")
    del q, k, v, k_st, v_st, k_pg, v_pg, qt, kt, vt
    torch.cuda.empty_cache()


# [long]'s kernel rows: (key, chunk, rows, K3's page kinds, timing of the
# kernel's three readings, timing of the library call, (heads, kv heads,
# head dim)). C 4096: (c)'s held runs at S 32768 with a wave of 2 (16 rows);
# C 16384: the S 131072 waves of one request (8 rows), bf16 pages, the
# library timed once after a warm-up; [long-ssm]'s C 4096 at zamba2-7b's
# shared block (32 heads of 112, MHA), 16 rows (its waves of 2), bf16 pages
LONG_ROWS = (("long", HELD_SEQ // LONG_M, N_STAGES * BATCH, ("bf16",) + K1_KINDS,
              dict(LONG_TIMING, windowed=3, profiled=4), LONG_TIMING, (32, 8, 128)),
             (f"long_{LONG_SEQ // LONG_M}", LONG_SEQ // LONG_M, N_STAGES * LONG_BATCH,
              ("bf16",), dict(iters=2, warmup=1, windowed=2, profiled=3),
              dict(iters=1, warmup=1), (32, 8, 128)),
             ("long_d112", HELD_SEQ // LONG_M, N_STAGES * SSM_LONG_BATCH, ("bf16",),
              dict(LONG_TIMING, windowed=3, profiled=4), LONG_TIMING, (32, 32, 112)))


def long_attention_shapes(results: dict) -> None:
    """K1-K3 at [long]'s shapes (``LONG_ROWS``), bf16: q [rows, C, 32, 128]
    (N_STAGES stage groups of one chunk of C queries, qwen3-8b's heads; the
    row's heads where it names others: [long-ssm]'s D 112, G 1); K1
    the causal self block against its C keys (return_state, as the
    pipeline calls it); K2 a stack of 6 slots x C keys (stage s reads
    min(s, 6) of them); K3 pages of C tokens, one a chunk, read in place
    from a strided [8, 7, 2, B, C, 8, 128] store, with the row's page
    kinds. Each is held against its plain version on the last
    LONG_Q_BLOCK query rows of every row (``compare``; the plain version on
    all C would hold ~26 GB of fp32 scores for one stage group of K2 at C
    4096), where the causal K1 sees every key; K2's and K3's all-invalid
    group must come out exactly (-1e30, 0, 0). Times (the row's timing:
    fewer calls than elsewhere, tens to hundreds of ms each): ``time_ms`` /
    ``windowed_ms`` / ``profiled_ms``, the plain version's on that slice,
    the library (K1: SDPA causal; K2 / K3: the memory-efficient SDPA over
    the masked stack, ``sdpa_pool_ms``, the 1-byte pages dequantized to
    bf16 outside the timed call) and the bound from
    ``roofline.kernel_work``; recorded under ``results[kernel][key]`` (K3:
    ``"<key>_<kind>"``)."""
    for key, c, gb, kinds, timing, lib_timing, heads in LONG_ROWS:
        t0 = time.perf_counter()
        long_attention_rows(results, key, c, gb, kinds, timing, lib_timing, heads)
        at = f"C {c}" + ("" if heads == (32, 8, 128) else
                         f", D {heads[2]}, G {heads[0] // heads[1]}")
        log(f"[kernels] K1-K3 at [long]'s {at}: {time.perf_counter() - t0:.1f} s")


def long_attention_rows(results: dict, key: str, c: int, gb: int, kinds: tuple,
                        timing: dict, lib_timing: dict, heads: tuple) -> None:
    """One row of ``LONG_ROWS`` (see ``long_attention_shapes``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    (h, kvh, d), slots = heads, 6
    b, q0, bf16 = gb // N_STAGES, c - LONG_Q_BLOCK, torch.bfloat16
    kernel_timing = {k: v for k, v in timing.items() if k in ("iters", "warmup")}
    # ``sdpa_pool_ms``'s call that checks the library's output is its first warm-up
    pool_lib = dict(lib_timing, warmup=lib_timing["warmup"] - 1)

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def held(kernel: str, got, args: tuple, kw: dict, label: str, in_dtype: str):
        want = query_block_call(kernel, plain_of(kernel), q0, c, args, kw)
        err = compare(f"{label}, last {LONG_Q_BLOCK} queries", query_part(got, q0, c), want,
                      in_dtype)
        del want
        plain = time_ms(lambda: query_block_call(kernel, plain_of(kernel), q0, c, args, kw),
                        **PLAIN_TIMING)
        res = results[kernel]
        res["max_abs_err"] = max(res.get("max_abs_err", 0.0), err)
        return plain

    def timed(call, tag: str) -> dict:
        ms = time_ms(call, **kernel_timing)
        win_ms = windowed_ms(call, iters=timing["windowed"], warmup=0)
        prof_ms, seen = profiled_ms(call, tag, calls=timing["profiled"])
        log(f"  torch.profiler: attn_tc_kernel<{tag}> {seen} launches, "
            + (f"{prof_ms:.4f} ms device time each" if seen else "no device time seen"))
        return dict(ms=ms, windowed_ms=win_ms, profiler_ms=prof_ms)

    def record(kernel: str, name: str, times: dict, plain: float, lib, bound, **shape):
        b_ms, by, _ = bound
        results[kernel][name] = dict(heads=h, kv_heads=kvh, head_dim=d, rows=gb, queries=c,
                                     plain_ms=plain, plain_queries=LONG_Q_BLOCK,
                                     library_ms=lib, bound_ms=b_ms, bound_by=by,
                                     **times, **shape)
        log(f"  time: kernel {times['ms']:.4f} ms ({times['windowed_ms']:.4f} ms a call in "
            f"windows), plain {plain:.4f} ms on the last {LONG_Q_BLOCK} queries of each row, "
            + (f"library {lib:.4f} ms, " if lib is not None else "")
            + f"bound {b_ms:.4f} ms ({by})")

    valid = torch.zeros((N_STAGES, slots), dtype=torch.bool, device=dev)
    for s in range(N_STAGES):           # stage s at phase s: min(s, 6) slots
        valid[s, :min(s, slots)] = True

    def identity_kept(label: str, got) -> None:
        m, l, acc = got
        check(bool((m[:b] == -1e30).all() and (l[:b] == 0).all() and (acc[:b] == 0).all()),
              f"{label}: an all-invalid group is not exactly (-1e30, 0, 0)")

    # ---------------- K1: the causal self block of a C-token chunk
    log(f"[kernels] K1 chunk_attention at [long]'s shape  q [{gb},{c},{h},{d}], "
        f"k/v [{gb},{c},{kvh},{d}] bf16, causal")
    q, k, v = randn(gb, c, h, d), randn(gb, c, kvh, d), randn(gb, c, kvh, d)
    call = lambda: ops.chunk_attention(q, k, v, return_state=True)
    plain = held("chunk_attention", call(), (q, k, v), dict(return_state=True),
                 f"long self block C {c}", "bfloat16")
    times = timed(call, "ChunkWalk")
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                         enable_gqa=True), **lib_timing)
    record("chunk_attention", key, times, plain, lib,
           bound_ms("chunk_attention", q, k, v, return_state=True), keys=c)
    del k, v, qt, kt, vt
    torch.cuda.empty_cache()

    # ---------------- K2: a stack of 6 stored chunks of C keys
    log(f"[kernels] K2 pool_attention at [long]'s shape  q [{gb},{c},{h},{d}], "
        f"k/v [{slots},{gb},{c},{kvh},{d}] bf16")
    k, v = randn(slots, gb, c, kvh, d), randn(slots, gb, c, kvh, d)
    call = lambda: ops.pool_attention(q, k, v, valid)
    got = call()
    identity_kept(f"long K2 C {c}", got)
    plain = held("pool_attention", got, (q, k, v, valid), {}, f"long pool bf16 C {c}",
                 "bfloat16")
    times = timed(call, "StackWalk")
    lib = sdpa_pool_ms(q, k, v, valid, got, **pool_lib)
    record("pool_attention", key, times, plain, lib,
           bound_ms("pool_attention", q, k, v, valid.cpu()), slots=slots, keys=c)
    del k, v, got
    torch.cuda.empty_cache()

    # ---------------- K3: pages of C tokens in place
    npages, lps = slots + 1, 2
    handles = torch.arange(slots, dtype=torch.int32, device=dev)
    for kind in kinds:
        log(f"[kernels] K3 pool_attention_paged at [long]'s shape  q [{gb},{c},{h},{d}], "
            f"layer view of a [{N_STAGES},{npages},{lps},{b},{c},{kvh},{d}] {kind} store")
        if kind == "bf16":
            kp, vp = (randn(N_STAGES, npages, lps, b, c, kvh, d) for _ in range(2))
            ks = vs = None
        else:
            kp, ks = quantize(randn(N_STAGES, npages, lps, b, c, kvh, d,
                                    dtype=torch.float32), kind, (4, 6))
            vp, vs = quantize(randn(N_STAGES, npages, lps, b, c, kvh, d,
                                    dtype=torch.float32), kind, (4, 6))
            ks, vs = ks[:, :, 1], vs[:, :, 1]
        k_l, v_l = kp[:, :, 1], vp[:, :, 1]           # strided views, as the pipeline's
        kw = dict(ppc=1, k_scale=ks, v_scale=vs)
        call = lambda: ops.pool_attention_paged(q, k_l, v_l, handles, valid, **kw)
        got = call()
        identity_kept(f"long K3 {kind} C {c}", got)
        plain = held("pool_attention_paged", got, (q, k_l, v_l, handles, valid), kw,
                     f"long paged {kind} C {c}", "bfloat16" if kind == "bf16" else kind)
        times = timed(call, "PagedWalk")

        def stack(x, sc):       # the same slots as K2's stack, dequantized to bf16
            x = x[:, :slots] if sc is None else (x[:, :slots].float() * sc[:, :slots]).to(bf16)
            return x.movedim(1, 0).flatten(1, 2)
        lib = sdpa_pool_ms(q, stack(k_l, ks), stack(v_l, vs), valid, got, **pool_lib)
        record("pool_attention_paged", f"{key}_{kind}", times, plain, lib,
               bound_ms("pool_attention_paged", q, k_l, v_l, handles.numel(), valid.cpu(),
                        ks, vs, ppc=1), slots=slots, page_tokens=c, pages=kind)
        del kp, vp, k_l, v_l, ks, vs, got
        torch.cuda.empty_cache()
    del q
    torch.cuda.empty_cache()


def kernel_phase(results: dict) -> None:
    attention_phase(results, h=32, kvh=8, d=128)                # qwen3-8b
    k1_gpipe_shape(results)
    long_attention_shapes(results)
    attention_phase(results, h=32, kvh=32, d=112, key="d112", fp32=False)   # zamba2-7b
    for key, (h, kvh, d, fp32) in ATTN_SHAPES.items():
        t0 = time.perf_counter()
        attention_phase(results, h=h, kvh=kvh, d=d, key=key, fp32=fp32,
                        k2_faults=key in K2_FAULT_SHAPES,
                        batch=ATTN_BATCH.get(key, BATCH))
        log(f"[kernels] K1-K3 at {key} (H {h}, KVH {kvh}): {time.perf_counter() - t0:.1f} s")
    k1_whisper_shapes(results)
    whisper_pipeline_shapes(results)
    ssd_phase(results)
    ssd_long_rows(results)
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

# one entry per model served at full width: its kernel combinations
# (remote_attn, attn_backend, pool_backend, kv_dtype and, where it is not
# the family's, the mode; the SSD runs K4), the kernels its main path must
# launch, and which wrapper the planted faults replace. Optional:
# ``per_launch``, the wrappers held per launch against their plain versions
# on the bf16 path (where no bf16 logits limit separates a fault, or a GQA
# group is new); ``wave`` False, no profiled wave; ``fp32`` False, no fp32
# runs; ``requests``, the requests a run serves (REQUESTS, two waves, where
# absent); ``bf16_layers`` and ``fp32_layers``, the depth of the bf16 and
# of the fp32 runs where they are cut (``depth``: N_STAGES is one layer a
# stage, for the hybrid one group a stage). The fp32 runs hold each
# launch's summation order, which depth does not change: qwen3-8b's and
# zamba2-7b's take one layer a stage for the script's time (their fp32
# waves at 36 and 81 layers took 6.0-9.6 s), and so do granite-3-2b's,
# stablelm-3b's and granite-moe-3b-a800m's (their fp32 serves at 40, 32 and
# 32 layers took some 20-36 s each), qwen2-moe-a2.7b's and
# qwen3-14b's for the card's memory (24 fp32 layers of experts are ~57 GB,
# 40 of qwen3-14b's ~59 GB); qwen3-14b's bf16 runs take one layer a stage
# (at 40 layers, holding each K1-K3 launch took 128 s of the script's time;
# its full depth runs in the decode phase), and so do granite-3-2b's and,
# one hybrid group a stage, zamba2-7b's, for the time of [long]'s S 131072
# waves at full depth. The paper's four models do not fit the card at
# full depth (llama3-70b's 80 layers are ~141 GB in bf16), so their bf16
# runs take one layer a stage at full width, one wave of BATCH requests a
# run, and they have no fp32 runs (their fp32 parity is the CPU tests')
ATTN_KERNELS = ("chunk_attention", "pool_attention", "pool_attention_paged")
SERVE_MODELS = {
    "qwen3-8b": dict(
        combos=[("qship", "cuda", "cuda", "auto"), ("qship", "cuda", "paged", "auto"),
                ("fetch", "cuda", "cuda", "auto"), ("fetch", "cuda", "paged", "auto"),
                ("qship", "cuda", "cuda", "int8")],
        kernels=ATTN_KERNELS, faults="pool_attention", fp32_layers=N_STAGES),
    # fp32: one wave of BATCH requests a run, for the script's time
    "zamba2-7b": dict(
        combos=[("qship", "cuda", "cuda", "auto"), ("fetch", "cuda", "paged", "auto"),
                ("qship", "cuda", "cuda", "int8")],
        kernels=ATTN_KERNELS + ("ssd",), faults="ssd", bf16_layers=N_STAGES,
        fp32_layers=N_STAGES, fp32_requests=BATCH),
    "mamba2-130m": dict(
        combos=[("qship", "cuda", "cuda", "auto")],
        kernels=("ssd",), faults="ssd"),
    "granite-3-2b": dict(
        combos=[("qship", "cuda", "cuda", "auto"), ("fetch", "cuda", "paged", "auto"),
                ("qship", "cuda", "cuda", "int8")],
        # its logits hardly see attention (embedding x 12, attention scale
        # 1/64, residual x 0.22): the K2 faults stay under the bf16 spread
        kernels=ATTN_KERNELS, faults="pool_attention", per_launch=ATTN_KERNELS,
        bf16_layers=N_STAGES, fp32_layers=N_STAGES),
    "stablelm-3b": dict(
        combos=[("fetch", "cuda", "cuda", "auto", "terapipe"),
                ("qship", "cuda", "paged", "auto", "mocap")],
        kernels=ATTN_KERNELS, faults="pool_attention", wave=False, fp32_layers=N_STAGES),
    "qwen2-moe-a2.7b": dict(
        combos=[("qship", "cuda", "cuda", "auto"), ("fetch", "cuda", "paged", "auto")],
        kernels=ATTN_KERNELS, faults="pool_attention", per_launch=ATTN_KERNELS,
        fp32_layers=N_STAGES),
    # bf16 at 8 of 32 layers (one a stage), for the script's time
    "granite-moe-3b-a800m": dict(
        combos=[("fetch", "cuda", "cuda", "auto"), ("qship", "cuda", "paged", "auto")],
        kernels=ATTN_KERNELS, faults="pool_attention", per_launch=ATTN_KERNELS,
        wave=False, bf16_layers=N_STAGES, fp32_layers=N_STAGES),
    # GQA group 5: K1-K3 held per launch; 40 fp32 layers are ~59 GB; the
    # bf16 runs take 8 of 40 layers (one a stage) for the script's time
    "qwen3-14b": dict(
        combos=[("qship", "cuda", "cuda", "auto"), ("fetch", "cuda", "paged", "auto"),
                ("qship", "cuda", "cuda", "int8")],
        kernels=ATTN_KERNELS, faults="pool_attention", per_launch=ATTN_KERNELS,
        bf16_layers=N_STAGES, fp32_layers=N_STAGES, wave=False),
    # the paper's four models (G 8, 12, 16, 16), 8 layers at full width
    "llama3-70b": dict(
        combos=[("qship", "cuda", "cuda", "auto"), ("fetch", "cuda", "paged", "auto"),
                ("qship", "cuda", "cuda", "int8")],
        kernels=ATTN_KERNELS, faults="pool_attention", per_launch=ATTN_KERNELS,
        bf16_layers=N_STAGES, fp32=False, requests=BATCH),
    "mistral-123b": dict(
        combos=[("qship", "cuda", "cuda", "auto"), ("fetch", "cuda", "paged", "auto")],
        kernels=ATTN_KERNELS, faults="pool_attention", per_launch=ATTN_KERNELS,
        bf16_layers=N_STAGES, fp32=False, requests=BATCH, wave=False),
    "qwen3-235b": dict(
        combos=[("qship", "cuda", "cuda", "auto"), ("fetch", "cuda", "paged", "auto")],
        kernels=ATTN_KERNELS, faults="pool_attention", per_launch=ATTN_KERNELS,
        bf16_layers=N_STAGES, fp32=False, requests=BATCH, wave=False),
    "llama3-405b": dict(
        combos=[("qship", "cuda", "cuda", "auto"), ("fetch", "cuda", "paged", "auto")],
        kernels=ATTN_KERNELS, faults="pool_attention", per_launch=ATTN_KERNELS,
        bf16_layers=N_STAGES, fp32=False, requests=BATCH, wave=False),
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
                  "qwen2-moe-a2.7b": None, "granite-moe-3b-a800m": 0.1,
                  "qwen3-14b": 0.1, "llama3-70b": 0.1, "mistral-123b": 0.1,
                  # 128 experts, top 8: router flips as in qwen2-moe-a2.7b
                  "qwen3-235b": None, "llama3-405b": 0.1,
                  "llava-next-34b": 0.1, "whisper-small": 0.1}
BF16_POOL_PAIR_TOL = 1e-3
FP32_LOGIT_TOL = {"qwen3-8b": 1e-3, "zamba2-7b": 1e-3, "mamba2-130m": 1e-4,
                  # granite-3-2b's logits move ~5e-4 of max|logit| when K2
                  # drops a slot (its summation-order spread: ~3e-7)
                  "granite-3-2b": 1e-5, "stablelm-3b": 1e-3, "qwen2-moe-a2.7b": 1e-3,
                  "granite-moe-3b-a800m": 1e-3, "qwen3-14b": 1e-3, "whisper-small": 1e-3}


def depth(cfg, layers):
    """``cfg`` cut to ``layers`` layers at full width (None: as it is). The
    hybrid keeps its groups' shape and is cut to ``layers`` - 1 groups plus
    its tail, one group a stage at ``layers`` = N_STAGES."""
    import dataclasses
    from repro_torch.configs import replace
    if layers is None:
        return cfg
    if cfg.family != "hybrid":
        return replace(cfg, num_layers=layers)
    h = dataclasses.replace(cfg.hybrid, num_groups=layers - 1)
    return replace(cfg, hybrid=h, num_layers=h.total_layers)


@contextlib.contextmanager
def swapped(owner, name: str, value):
    """``owner.name`` is ``value`` inside the block."""
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


WITNESS_TILE = 512   # the witness's query rows a block (``p32_witness``)


def p32_witness():
    """The ``torch`` backend with p kept in fp32 before PV and stored pages
    dequantized to fp32, as the kernels do: only the fp32 summation order
    differs from them. Each block runs WITNESS_TILE query rows at a time
    (every row's online-softmax state is its own), the causal self block
    over the keys a tile can see; a stored chunk's block runs on the rows
    of the groups that may read it, and not at all where no group may (the
    state after an all-masked block is exactly the state before it). So a
    chunk of 4096 queries holds one tile's fp32 scores at a time, not the
    [GB, K, G, C, C] of ``attn_update``."""
    import torch
    from repro_torch.core.attention import NEG_INF, TorchBackend, group_rows
    from repro_torch.kvstore import quant

    def update(qg, k, v, mask, scale, m, l, acc):
        """``attention.attn_update`` on fp32 k / v (so p stays fp32 before
        PV), its passes over the scores in place; ``mask`` None: every key
        is visible (``where`` on an all-True mask is the identity)."""
        s = torch.einsum("bckgd,bskd->bkgcs", qg.float(), k).mul_(scale)
        if mask is not None:
            s.masked_fill_(~mask, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(m_new < NEG_INF / 2, torch.zeros_like(m_new), m_new)
        p = s.sub_(m_safe[..., None]).exp_()
        corr = torch.exp(m - m_safe)
        return (m_new, l * corr + p.sum(dim=-1),
                acc * corr[..., None] + torch.einsum("bkgcs,bskd->bkgcd", p, v))

    def blocks(qg, k, v, rows, causal: bool, scale, st):
        """``st`` updated by one block on the rows flagged in ``rows`` [GB]
        (all where None), WITNESS_TILE query rows at a time."""
        m, l, acc = (x.clone() for x in st)
        idx = None if rows is None or bool(rows.all()) else torch.nonzero(rows).flatten()
        if idx is not None:
            qg, k, v = qg[idx], k[idx], v[idx]
        k, v = k.float(), v.float()
        r = slice(None) if idx is None else idx
        for q0 in range(0, qg.shape[1], WITNESS_TILE):
            q1 = min(q0 + WITNESS_TILE, qg.shape[1])
            n = q1 if causal else k.shape[1]
            mask = None
            if causal and q0 < n - 1:
                mask = (torch.arange(n, device=qg.device)[None, :]
                        <= torch.arange(q0, q1, device=qg.device)[:, None])
            at = (r, slice(None), slice(None), slice(q0, q1))
            m[at], l[at], acc[at] = update(qg[:, q0:q1], k[:, :n], v[:, :n], mask, scale,
                                           m[at], l[at], acc[at])
        return m, l, acc

    class P32Witness(TorchBackend):
        def self_block(self, qg, k, v, scale, st):
            return blocks(qg, k, v, None, True, scale, st)

        def chunk_block(self, qg, k, v, valid, scale, st):
            rows = group_rows(valid, qg.shape[0])
            if not bool(rows.any()):
                return st
            return blocks(qg, k, v, rows, False, scale, st)

        def chunk_block_q(self, qg, kq, vq, k_scale, v_scale, valid, scale, st):
            if not bool(group_rows(valid, qg.shape[0]).any()):
                return st                   # before the pages are decoded
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


def ssd_zero_past(real, pos: int):
    """A wrong version of ``ops.ssd`` (``real``) that only a launch of
    more than ``pos`` positions shows: every SSD chunk at or past position
    ``pos`` starts from a zero state instead of the state carried to it
    (the first ``pos`` positions one call of ``real``, then one call a
    chunk without an init_state; ``pos`` a multiple of the chunk). On a
    launch of ``pos`` positions or fewer it is ``real``."""
    import torch
    from repro_torch.kernels import ops

    def fault(x, dt, a_log, b, c, d_skip, *, chunk, init_state=None):
        t = x.shape[1]
        if t <= pos:
            return real(x, dt, a_log, b, c, d_skip, chunk=chunk, init_state=init_state)
        ck = ops.ssd_chunk(t, chunk)
        ys, st = [], init_state
        for c0, c1 in [(0, pos)] + [(c0, c0 + ck) for c0 in range(pos, t, ck)]:
            sl = slice(c0, c1)
            y, st = real(x[:, sl], dt[:, sl].contiguous(), a_log, b[:, sl], c[:, sl], d_skip,
                         chunk=ck, init_state=st if c0 == 0 else None)
            ys.append(y)
        return torch.cat(ys, dim=1), st
    return fault


PLAIN_SCORES_BYTES = 2 << 30   # a K1-K3 plain call's fp32 scores, at most (``plain_of``)
# the outputs' query axes: K1's (out, m, l, acc) or out, K2's / K3's (m, l, acc)
QUERY_DIMS = {4: (1, 2, 2, 1), 3: (2, 2, 1)}


def query_part(res, q0: int, q1: int):
    """Query rows [q0, q1) of a K1-K3 result (``QUERY_DIMS``)."""
    if not isinstance(res, tuple):
        return res[:, q0:q1]
    return tuple(x.narrow(dim, q0, q1 - q0) for x, dim in zip(res, QUERY_DIMS[len(res)]))


def query_cat(parts: list):
    """K1-K3 results of consecutive query blocks, joined."""
    import torch
    if not isinstance(parts[0], tuple):
        return torch.cat(parts, 1)
    return tuple(torch.cat(xs, dim)
                 for xs, dim in zip(zip(*parts), QUERY_DIMS[len(parts[0])]))


def query_block_call(kind: str, fn, q0: int, q1: int, args: tuple, kw: dict):
    """``fn`` (a K1-K3 wrapper or plain version) on query rows [q0, q1) of
    ``args[0]``: K1's causal offset moves with the block's first row, K2 and
    K3 see every stored key from every row."""
    kw = dict(kw)
    if kind == "chunk_attention":
        kw["causal_offset"] = kw.get("causal_offset", 0) + q0
    return fn(args[0][:, q0:q1], *args[1:], **kw)


def plain_of(kind: str):
    """The plain version of the wrapper ``ops.<kind>``, with its signature:
    for K1-K3 the wrapper itself (its checks and argument handling) with
    its CPU route taken on the card's tensors (``ops._on_card`` reading
    False), which is the plain version's call."""
    import torch
    from repro_torch.kernels import ops, ref
    if kind == "decode_attention":
        return ref.decode_attention_plain
    if kind in ATTN_KERNELS:
        wrapper = getattr(ops, kind)

        def whole(*args, **kw):
            with swapped(ops, "_on_card", lambda *ts: False):
                return wrapper(*args, **kw)

        def plain(*args, **kw):
            # in as few calls as keep each call's fp32 scores within
            # PLAIN_SCORES_BYTES: whole stage groups' rows a call (K1: rows
            # in N_STAGES groups), then blocks of query rows. Rows and query
            # rows are independent, so the split is exact: all 16 rows of a
            # pool scan at llama3-405b's 128 heads hold ~13 GB a copy, one
            # group's K2 call at C = 4096 over 6 slots ~26 GB
            q, g = args[0], N_STAGES
            if kind == "chunk_attention":
                keys = args[1].shape[1]
            elif kind == "pool_attention":
                g = args[3].shape[0] if args[3].ndim == 2 else g
                keys = args[1].shape[0] * args[1].shape[2]
            else:
                g = args[1].shape[0] if args[1].ndim == 6 else 1
                keys = torch.as_tensor(args[3]).numel() * args[1].shape[-3]
            scores = 4 * q.shape[0] * q.shape[1] * q.shape[2] * keys
            calls = 1 if q.shape[0] % g else next(
                (p for p in range(1, g + 1) if g % p == 0
                 and scores <= p * PLAIN_SCORES_BYTES), g)
            blocks = -(-scores // (calls * PLAIN_SCORES_BYTES))
            step = -(-q.shape[1] // max(blocks, 1))
            b, per = q.shape[0] // calls, g // calls
            parts = []
            for i in range(calls):
                rows, grp = slice(i * b, (i + 1) * b), slice(i * per, (i + 1) * per)
                if calls == 1:
                    a, k = args, kw
                elif kind == "chunk_attention":
                    a = tuple(x[rows] for x in args)
                    k = {n: (x[rows] if n in ("k_scale", "v_scale") and x is not None
                             else x) for n, x in kw.items()}
                elif kind == "pool_attention":
                    valid = args[3][grp] if args[3].ndim == 2 else args[3]
                    a = (q[rows], args[1][:, rows], args[2][:, rows], valid) + args[4:]
                    k = {n: (x[:, rows] if n in ("k_scale", "v_scale") and x is not None
                             else x) for n, x in kw.items()}
                else:
                    a = (q[rows], args[1][grp], args[2][grp], args[3], args[4][grp]) \
                        + args[5:]
                    k = {n: (x[grp] if n in ("k_scale", "v_scale") and x is not None
                             else x) for n, x in kw.items()}
                if step >= q.shape[1]:
                    parts.append(whole(*a, **k))
                    continue
                parts.append(query_cat([
                    query_block_call(kind, whole, q0, min(q0 + step, q.shape[1]), a, k)
                    for q0 in range(0, q.shape[1], step)]))
            if len(parts) == 1:
                return parts[0]
            if isinstance(parts[0], tuple):
                return tuple(torch.cat(p) for p in zip(*parts))
            return torch.cat(parts)
        return plain

    def ssd(x, dt, a_log, b, c, d_skip, *, chunk, init_state=None):
        return ref.ssd_plain(x, dt, a_log, b, c, d_skip,
                             chunk=ops.ssd_chunk(x.shape[1], chunk), init_state=init_state)
    return ssd


def shadowed(fn, kind: str, worst: list, by: Optional[dict] = None, label=None,
             q_block: Optional[int] = None):
    """``fn`` (the wrapper ``ops.<kind>``: K1-K5, or a planted fault) in
    its place on a model path, every call also held against the plain
    version on the same inputs: ``worst[0]`` keeps the largest error of any
    output as a multiple of its tolerance (``fault_ratio``: 2e-2 of
    max|ref| for a bf16 output, 1e-3 for an fp32 one of bf16 inputs, 1e-4
    for fp32 inputs; entries holding the empty-row sentinel m = -1e30 must
    match it and stay out of max|ref|; K5 at each (row, head)'s own
    max|ref|, 1e-2 of it in bf16, ``head_ratio``); ``by[label(*args, **kw)]`` the
    largest of each kind of call that ``label`` names. ``q_block`` (K1-K3):
    only the last ``q_block`` query rows of every row are held, the plain
    version run on those queries alone (``query_block_call``): the block
    where a causal K1 sees every key of its launch."""
    import torch
    plain = plain_of(kind)

    def call(*args, **kw):
        got = fn(*args, **kw)
        c = args[0].shape[1]
        if q_block is not None and c > q_block:
            q0 = c - q_block
            pair = (query_part(got, q0, c), query_block_call(kind, plain, q0, c, args, kw))
        else:
            pair = (got, plain(*args, **kw))
        in_dtype = "float32" if args[0].dtype == torch.float32 else "bfloat16"
        if kind == "decode_attention":
            ratio = head_ratio(*pair, in_dtype)
        else:
            pair = pair if isinstance(got, tuple) else ((pair[0],), (pair[1],))
            ratio = fault_ratio(*pair, in_dtype)
        worst[0] = max(worst[0], ratio)
        if by is not None:
            name = label(*args, **kw)
            by[name] = max(by.get(name, 0.0), ratio)
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


def device_spans(prof) -> list:
    """The device activities (kernels, copies, sets) of a torch.profiler
    session, sorted: [(start us, end us, name, category)], read from its raw
    kineto events (an export to a Chrome trace and its parse took ~10 s for
    a wave's 37k events). The category is the trace's: ``gpu_memcpy`` /
    ``gpu_memset`` by the activity's name, else ``kernel`` (torch 2.11's
    events carry no ``activity_type``); user annotations are left out."""
    from torch.autograd import DeviceType
    spans = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        name = e.name()
        cat = ("gpu_memcpy" if name.startswith("Memcpy") else
               "gpu_memset" if name.startswith("Memset") else "kernel")
        spans.append((e.start_ns() / 1e3, e.end_ns() / 1e3, name, cat))
    return sorted(spans)


def busy_window(spans: list) -> tuple:
    """(busy s, window s) of ``device_spans``: the union of the activities'
    intervals, and the first start to the last end."""
    busy, (lo, hi) = 0.0, spans[0][:2]
    for t0, t1, *_ in spans[1:]:
        if t0 > hi:
            busy, lo, hi = busy + hi - lo, t0, t1
        else:
            hi = max(hi, t1)
    busy = (busy + hi - lo) / 1e6
    return busy, (max(span[1] for span in spans) - spans[0][0]) / 1e6


def wave_split(arch: str, staged=None,
               combo=("qship", "cuda", "cuda", "auto"), cfg=None) -> dict:
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
    None); ``cfg``: its config (``arch``'s at full depth if None). Logs and
    returns the numbers."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.core import pipeline as pp
    from repro_torch.core.staging import init_staged
    from repro_torch.launch.serve import make_requests
    from repro_torch.runtime.engine import (EngineConfig, PrefillEngine,
                                            TorchExecutor)

    cfg = cfg or get_config(arch)
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
    t0 = time.perf_counter()
    spans = device_spans(prof)
    read_s = time.perf_counter() - t0
    check(bool(spans), f"{arch}: the traced wave holds no device time")
    split, by_name = categorize(spans)
    busy, window = busy_window(spans)
    # K4's launches by body: the tensor-core one, or the CUDA-core one
    k4 = {body: sum(key in span[2] for span in spans)
          for body, key in (("tensor cores", "ssd_tc_kernel"), ("cuda cores", "ssd_kernel"))}
    out = dict(split=split, busy_s=busy, window_s=window, idle_share=1.0 - busy / window,
               wave_s=untraced, traced_wave_s=traced, kernels=len(spans), card=clocks,
               k4_launches=k4)
    log(f"[wave] {arch} bf16 {'/'.join(combo)}: wave {untraced:.4f} s untraced, "
        f"{traced:.4f} s traced; {len(spans)} device activities; busy {busy:.4f} s of a "
        f"{window:.4f} s window, idle share {1.0 - busy / window:.4f}; spans read in "
        f"{read_s:.2f} s; card after it (SM clock, its max, power draw, temperature): {clocks}")
    log_split(split, by_name, busy)
    if any(k4.values()):
        log(f"  K4 launches by body: {k4}")
    return out


def categorize(spans: list) -> tuple:
    """(device seconds by WAVE_CATEGORIES label, device seconds by kernel
    name) of ``device_spans``."""
    split: dict = {}
    by_name: dict = {}
    for t0, t1, name, _ in spans:
        low = name.lower()
        label = next((lab for lab, keys in WAVE_CATEGORIES if any(k in low for k in keys)),
                     "other")
        split[label] = split.get(label, 0.0) + (t1 - t0) / 1e6
        by_name[name] = by_name.get(name, 0.0) + (t1 - t0) / 1e6
    return split, by_name


def log_split(split: dict, by_name: dict, busy: float) -> None:
    """Logs ``categorize``'s split as shares of ``busy``, then the 12
    kernels that take the most device time."""
    for label, sec in sorted(split.items(), key=lambda x: -x[1]):
        log(f"  {label}: {sec:.4f} s ({sec / busy:.1%} of the device's busy time)")
    for name, sec in sorted(by_name.items(), key=lambda x: -x[1])[:12]:
        log(f"    {sec:.4f} s  {name[:110]}")


def moe_cap(cfg) -> int:
    """An expert's slots for one (stage, row) chunk of CHUNK tokens."""
    from repro_torch.models.layers import moe_capacity
    m = cfg.moe
    return moe_capacity(CHUNK, m.top_k, m.real_experts, m.capacity_factor)


def serve_model(arch: str, results: dict) -> None:
    """One model at full width (and full depth, or ``bf16_layers`` /
    ``fp32_layers`` deep: ``depth``) through PrefillEngine + TorchExecutor;
    the model's peak device memory (``torch.cuda.max_memory_allocated``)
    is printed at the end, and its weights are freed before the next.

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
    fp32 (unless ``fp32`` is False; same geometry, weights drawn in fp32,
    ``fp32_layers`` deep where set): summation order is the only difference
    left, so every combination's argmax must equal the ``torch`` backends' on the same
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
    torch.cuda.reset_peak_memory_stats()
    full = get_config(arch)
    cfg = depth(full, spec.get("bf16_layers"))
    seq = N_CHUNKS * CHUNK
    base = RunConfig(num_chunks=N_CHUNKS, num_stages=N_STAGES, mbkr=not cfg.attn_free)
    plan = pp.build_plan(cfg, N_STAGES, seq, base)
    if cfg.num_layers != full.num_layers:
        log(f"[serve] {arch}: bf16 depth cut to {cfg.num_layers} of {full.num_layers} "
            f"layers (bf16_layers), full width")
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
    n_req = spec.get("requests", REQUESTS)

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
        """One run of n_req requests: its logits, and the MoE router's
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
        for r in make_requests(n_req, seq, model_cfg.vocab_size, seed=0):
            eng.submit(r)
        choices.clear()
        with swapped(layers_mod, "moe_route", record_choices if record and model_cfg.moe
                     else route):
            eng.run_until_drained()
        done = sorted(eng.done, key=lambda r: r.rid)
        name = f"{arch} {model_cfg.dtype} {'mbkr' if run.mbkr else 'terapipe'} " \
            f"{remote}/{attn}/{pool}/{kv}" + \
            ("" if model_cfg.family in ("dense", "moe") else f"/ssd {ssm}")
        check(len(done) == n_req, f"{name}: {len(done)} of {n_req} answered")
        logits = np.stack([r.result for r in done])
        check(logits.shape == (n_req, pad_vocab(model_cfg.vocab_size)),
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
            return same == n_req and err < FP32_LOGIT_TOL[arch]
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
        split = wave_split(arch, staged, cfg=cfg)
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
    if spec.get("fp32", True):
        cfg32 = replace(depth(full, spec.get("fp32_layers")), dtype="float32")
        if cfg32.num_layers != full.num_layers:
            log(f"  fp32 depth cut to {cfg32.num_layers} of {full.num_layers} layers "
                f"(fp32_layers), full width")
        if spec.get("fp32_requests", n_req) != n_req:
            n_req = spec["fp32_requests"]
            log(f"  fp32 runs: {n_req} requests, one wave (fp32_requests)")
        staged = weights(cfg32)
        refs = {kv: serve(cfg32, staged, "qship", "torch", "torch", kv, ssm="torch")
                for kv in kvs}
        for combo in spec["combos"]:
            hold(cfg32, serve(cfg32, staged, *combo), refs[combo[3]], "torch backends",
                 "/".join(combo))
        planted(cfg32, staged, refs["auto"], "torch backends")
        del staged
        torch.cuda.empty_cache()
    log(f"  {arch} peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated)")
    check(not failures, "; ".join(failures))


def serve_phase(results: dict) -> None:
    for arch in SERVE_MODELS:
        t0 = time.perf_counter()
        serve_model(arch, results)
        log(f"[serve] {arch} {time.perf_counter() - t0:.1f} s")


# ----------------------------------------------------------------- roofline

# the profiler's product ops (their ``flops`` with ``with_flops=True``); the
# counter's products are the same four (``roofline.op_graph``)
PRODUCT_OPS = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm")
# measured peak <= PEAK_SLACK[0] x counted peak + PEAK_SLACK[1]: the caching
# allocator rounds every block up to 512 B, and cuBLAS's workspace and a
# kernel's scratch are allocations the eager program does not make
PEAK_SLACK = (1.10, 256 * 2 ** 20)
BOUND_SLACK = 1.05                 # bound_s <= 1.05 x the wave's device busy time


def profiled_wave(prof) -> tuple:
    """(product FLOPs, device spans) of a torch.profiler session with
    ``with_flops``, read from its raw events (no parse into FunctionEvents).
    The FLOPs of the product ops count each op once (one inside another
    product op on its thread is left out); the spans are ``device_spans``."""
    products = sorted((e.start_thread_id(), e.start_ns(), -e.end_ns(), e.flops())
                      for e in prof.profiler.kineto_results.events()
                      if e.name() in PRODUCT_OPS)
    flops, outer = 0.0, {}
    for tid, t0, neg_t1, f in products:
        if tid in outer and t0 < outer[tid]:
            continue                     # nested in the product op before it
        outer[tid] = -neg_t1
        flops += f
    return flops, device_spans(prof)


def roofline_wave(seq: int = N_CHUNKS * CHUNK, batch: int = BATCH, arch: str = "qwen3-8b",
                  mode: str = "mocap"):
    """(cfg, plan, tokens as numpy, wave): the serve phase's qwen3-8b bf16
    wave (qship, ``cuda`` / ``cuda``, N 8, M 8, C 512, B 2, full depth), or
    at another ``seq`` and ``batch`` the same wave of M 8 chunks of seq / 8
    ([long]'s S 131072, B 1), or of another ``arch`` (the SSD on K4) under
    another ``mode`` ([long-ssm]'s zamba2-7b), through ``prefill_pipeline``
    as ``TorchExecutor`` runs it; ``wave(staged, tokens)`` runs it where
    ``tokens`` lie (the card, or meta)."""
    import numpy as np
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.core import pipeline as pp
    from repro_torch.launch.serve import make_requests
    cfg = get_config(arch)
    run = RunConfig(num_chunks=N_CHUNKS, num_stages=N_STAGES, mbkr=mode == "mocap",
                    remote_attn="qship", attn_backend="cuda", pool_backend="cuda",
                    ssm_backend="cuda")
    plan = pp.build_plan(cfg, N_STAGES, seq, run, mode=mode)
    toks = np.stack([r.tokens for r in make_requests(batch, seq, cfg.vocab_size, seed=0)])

    def wave(staged, tokens):
        return pp.prefill_pipeline(cfg, staged, tokens, plan, device=tokens.device)
    return cfg, plan, toks, wave


def count_roofline_wave(seq: int = N_CHUNKS * CHUNK, batch: int = BATCH,
                        arch: str = "qwen3-8b", mode: str = "mocap") -> tuple:
    """(GraphCost, seconds): ``roofline_wave(seq, batch, arch, mode)``
    counted on meta by ``roofline.op_graph.count`` (K1 / K2 / K4 charged
    their ``kernel_work``). It needs no card: ``main`` runs it in a thread
    beside the build."""
    import torch
    from repro_torch.core.staging import init_staged
    from repro_torch.roofline import op_graph
    t0 = time.perf_counter()
    cfg, plan, toks, wave = roofline_wave(seq, batch, arch, mode)
    meta = torch.device("meta")
    with torch.no_grad():
        cost = op_graph.count(wave, init_staged(cfg, plan, None, device=meta),
                              torch.empty(toks.shape, dtype=torch.int64, device=meta))
    return cost, time.perf_counter() - t0


def roofline_phase(results: dict, counted=None) -> None:
    """[roofline]: ``roofline_wave``, the serve phase's qwen3-8b bf16 wave:

    (a) counted on meta (``count_roofline_wave``; ``counted``, its result
    when ``main`` ran it beside the build, else counted here);
    (b) run on the card with the weights resident: a warm-up wave, a timed
    wave (host clock ending in a synchronize), then one wave under
    torch.profiler (``with_flops``) between ``reset_peak_memory_stats()``
    and ``max_memory_allocated()`` (less what was allocated before the
    weights), with the launch counters set to 0 just before it;
    (c) held: the counted K1 / K2 launches equal ``ops.LAUNCHES``; the
    counted products outside the kernels equal the profiler's FLOPs of
    aten::mm / bmm / addmm / baddbmm to rel 1e-6; counted peak <= measured
    peak <= 1.10 x counted + 256 MiB (PEAK_SLACK); the roofline bound (the
    larger of the compute and least-traffic terms) <= 1.05 x the traced
    wave's device busy time, since no reading may beat the chip;
    (d) printed beside the card's name and power limit: the terms,
    ``dominant``, ``useful_ratio``, the eager bytes over the HBM rate, the
    measured share bound / busy, the MFU model_flops / (989e12 x wave s)
    and the ops with the most eager bytes."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import ShapeConfig
    from repro_torch.core.staging import init_staged
    from repro_torch.kernels import ops
    from repro_torch.roofline import analysis

    card = card_line()
    cost, count_s = counted or count_roofline_wave()
    cfg, plan, toks, wave = roofline_wave()
    terms = analysis.analyze_counted(cost, cfg, ShapeConfig("serve wave", "prefill",
                                                            N_CHUNKS * CHUNK, BATCH))
    log(f"[roofline] {cfg.arch} bf16 qship/cuda/cuda N {N_STAGES} M {N_CHUNKS} C {CHUNK} "
        f"B {BATCH}, {cfg.num_layers} layers, on {card}; counted on meta in {count_s:.2f} s"
        + (" (beside the build)" if counted else ""))

    # (b) the wave on the card
    t_card = time.perf_counter()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    staged = init_staged(cfg, plan, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    tokens = torch.as_tensor(toks, device="cuda")
    with torch.no_grad():
        wave(staged, tokens)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = wave(staged, tokens)
        torch.cuda.synchronize()
        wave_s = time.perf_counter() - t0
        check(bool(torch.isfinite(logits).all()), "[roofline] non-finite logits")
        del logits
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     with_flops=True) as prof:
            logits = wave(staged, tokens)
            torch.cuda.synchronize()
        launches = {k: v for k, v in ops.LAUNCHES.items() if v}
        peak = torch.cuda.max_memory_allocated() - before
    del logits, staged, tokens
    torch.cuda.empty_cache()
    card_s = time.perf_counter() - t_card
    for name, n in launches.items():
        results[name].setdefault("launches_by_path", {})["roofline wave"] = n
    t0 = time.perf_counter()
    prof_flops, spans = profiled_wave(prof)
    check(bool(spans), "[roofline] the traced wave holds no device time")
    busy, window = busy_window(spans)
    log(f"  phase time: weights and three waves {card_s:.2f} s, the profile's FLOPs and "
        f"spans {time.perf_counter() - t0:.2f} s")

    # (d) the numbers, (c) the checks
    hbm = analysis.HW_H100["hbm_bw"]
    mfu = terms.model_flops / (analysis.HW_H100["peak_flops"] * wave_s)
    log(f"  [{card}] counted: FLOPs {cost.flops:.6e} (products outside the kernels "
        f"{cost.product_flops:.6e}, K1 / K2 {cost.kernel_flops:.6e}), model_flops "
        f"{terms.model_flops:.6e}, least traffic {cost.stream_bytes:.6e} B, eager bytes "
        f"{cost.bytes_:.6e} B, peak live {cost.peak_live_bytes / 2**30:.4f} GiB, launches "
        f"{cost.launches}")
    log(f"  [{card}] terms (HW_H100): {terms.summary()}; dominant {terms.dominant}, "
        f"useful_ratio {terms.useful_ratio:.4f}, bound_s {terms.bound_s:.6f}, "
        f"eager bytes / {hbm:.3g} B/s = {terms.bytes_dev_eager / hbm:.6f} s")
    log(f"  [{card}] measured: wave {wave_s:.4f} s (host clock, untraced), traced wave's "
        f"device busy {busy:.4f} s of a {window:.4f} s window; share bound_s / busy "
        f"{terms.bound_s / busy:.4f}; MFU model_flops / (989e12 x wave s) {mfu:.4f}; "
        f"peak {peak / 2**30:.4f} GiB (max_memory_allocated less the "
        f"{before / 2**30:.4f} GiB allocated before the weights)")
    for name, row in cost.top(8):
        log(f"    {row['bytes']:.4e} B eager, {row['calls']} calls  {name}")
    rel = abs(cost.product_flops - prof_flops) / max(prof_flops, 1.0)
    lo, hi = cost.peak_live_bytes, PEAK_SLACK[0] * cost.peak_live_bytes + PEAK_SLACK[1]
    log(f"  [{card}] checks: launches counted {cost.launches} vs ops.LAUNCHES {launches}; "
        f"product FLOPs counted {cost.product_flops:.6e} vs profiler {prof_flops:.6e} "
        f"(rel {rel:.3e}); peak counted {lo / 2**30:.4f} <= measured {peak / 2**30:.4f} <= "
        f"{hi / 2**30:.4f} GiB (the gap {(peak - lo) / 2**20:.1f} MiB: allocator rounding, "
        f"cuBLAS workspace, scratch); bound_s {terms.bound_s:.6f} <= {BOUND_SLACK} x busy "
        f"{busy:.6f}")
    check(cost.launches == launches,
          f"[roofline] counted launches {cost.launches} != ops.LAUNCHES {launches}")
    check(prof_flops > 0 and rel <= 1e-6,
          f"[roofline] product FLOPs: counted {cost.product_flops} vs profiler {prof_flops}")
    check(lo <= peak <= hi, f"[roofline] peak memory {peak} outside [{lo}, {hi}]")
    check(terms.bound_s <= BOUND_SLACK * busy,
          f"[roofline] bound_s {terms.bound_s} > {BOUND_SLACK} x busy {busy}")


# --------------------------------------------------------------------- long

class FaultSeen(Exception):
    """A planted fault broke its per-launch check: its run stops there."""


def stop_on_break(fn, worst: list):
    """``fn`` (a ``shadowed`` fault) raising FaultSeen once ``worst[0]``
    passes 1: one broken launch is all a fault has to show."""
    def call(*args, **kw):
        out = fn(*args, **kw)
        if worst[0] > 1.0:
            raise FaultSeen
        return out
    return call


def long_faults(k1, k3, k2=None, keys: Optional[int] = None, k4=None,
                pos: Optional[int] = None) -> dict:
    """The planted faults that only a launch of more than ``keys`` keys a
    chunk shows (LONG_FAULT_KEYS where None), through ``kv_len``: K1
    (``k1``) dropping every key at or past position ``keys`` of its launch,
    K2 (``k2``, where given) every key of a slot past its first ``keys``,
    K3 (``k3``) every key of a page past its first ``keys`` (one page a
    chunk); and, where ``k4`` is given, K4 starting each SSD chunk at or
    past position ``pos`` (SSD_FAULT_POS where None) from a zero state
    (``ssd_zero_past``). Kernel tag -> (name, fault)."""
    keys = LONG_FAULT_KEYS if keys is None else keys
    pos = SSD_FAULT_POS if pos is None else pos

    def k1_short(q, k, v, *, kv_len=None, **kw):
        t = k.shape[1] if kv_len is None else kv_len
        return k1(q, k, v, kv_len=min(t, keys), **kw)

    def k2_short(q, k, v, valid, *, kv_len=None, **kw):
        t = k.shape[2] if kv_len is None else kv_len
        return k2(q, k, v, valid, kv_len=min(t, keys), **kw)

    def k3_short(q, k_pages, v_pages, handles, valid, *, ppc, kv_len=None, **kw):
        t = ppc * k_pages.shape[-3] if kv_len is None else kv_len
        return k3(q, k_pages, v_pages, handles, valid, ppc=ppc,
                  kv_len=min(t, keys), **kw)
    faults = {"chunk_attention": (f"K1 drops the keys at or past {keys} of a launch",
                                  k1_short),
              "pool_attention_paged": (f"K3 drops a page's keys past its first {keys}",
                                       k3_short)}
    if k2 is not None:
        faults["pool_attention"] = (f"K2 drops a slot's keys past its first {keys}",
                                    k2_short)
    if k4 is not None:
        faults["ssd"] = (f"K4 starts each SSD chunk at or past position {pos} of a launch "
                         f"from a zero state", ssd_zero_past(k4, pos))
    return faults


def wave_launch_form(plan, cfg=None) -> dict:
    """K1, K2 and K4 launches of one wave on the ``cuda`` pool and the
    ``cuda`` SSD, of ``cfg`` (a dense model where None): per (layer, tick),
    K1 one self block and K2 one pool scan and, under MBKR with a remote
    prefix, one more (the qship creditor scan or the landed fetch stack);
    K4 one scan a Mamba2 layer (the hybrid's layers_per_stage counts
    groups of ssm_per_group Mamba2 layers and one shared-block
    application; the ssm family has no attention)."""
    per = plan.layers_per_stage * plan.num_ticks
    family = "dense" if cfg is None else cfg.family
    form = {}
    if family != "ssm":
        remote = plan.mode == "mocap" and plan.p2 < plan.num_chunks and (
            plan.remote_attn == "fetch" or len(plan.host_slots_used) > 0)
        form = {"chunk_attention": per, "pool_attention": per * (1 + int(remote))}
    if family in ("ssm", "hybrid"):
        form["ssd"] = per * (cfg.hybrid.ssm_per_group if family == "hybrid" else 1)
    return form


def pool_recorder(sizes: list):
    """``core.pipeline.alloc_kv_pool`` appending the bytes of each pool it
    allocates (payloads and scales) to ``sizes``."""
    from repro_torch.core import pipeline as pp
    alloc = pp.alloc_kv_pool

    def recorded(*args, **kw):
        pool = alloc(*args, **kw)
        sizes.append(int(nbytes(pool.k, pool.v, pool.k_scale, pool.v_scale)))
        return pool
    return recorded


def long_run(cfg, staged, combo, *, seq: int = LONG_SEQ, mode: str = "mocap",
             n_req: int = LONG_BATCH, telemetry: bool = False,
             phase: str = "[long]") -> tuple:
    """One wave of ``n_req`` requests of ``seq`` tokens of ``cfg`` through
    PrefillEngine + TorchExecutor under ``combo`` (remote_attn,
    attn_backend, pool_backend, kv_dtype) and ``mode``, the SSD on K4
    (``ssm_backend="cuda"``; RunConfig's default is the ``torch`` SSD), at
    EngineConfig's default buckets (8192, 32768, 131072): ``seq`` must be
    one of them, and the wave must run at it as LONG_M chunks of seq /
    LONG_M. Returns (the logits [n_req, Vpad] as numpy, the wave's record:
    ``dur`` and, with ``telemetry``, the stage telemetry)."""
    import numpy as np
    from repro_torch.configs import RunConfig
    from repro_torch.launch.serve import make_requests
    from repro_torch.models.layers import pad_vocab
    from repro_torch.runtime.engine import EngineConfig, PrefillEngine, TorchExecutor
    remote, attn, pool, kv = combo
    run = RunConfig(num_chunks=LONG_M, num_stages=N_STAGES, mbkr=mode == "mocap",
                    remote_attn=remote, attn_backend=attn, pool_backend=pool, kv_dtype=kv,
                    ssm_backend="cuda")
    ex = TorchExecutor(cfg, staged, run, device="cuda")
    ex.collect_telemetry = telemetry
    ec = EngineConfig(model=cfg, num_stages=N_STAGES, tp=1, num_chunks=LONG_M,
                      max_batch=n_req, partition="uniform")
    check(seq in ec.buckets, f"{phase} S {seq} is not one of the buckets {ec.buckets}")
    eng = PrefillEngine(ec, ex)
    for r in make_requests(n_req, seq, cfg.vocab_size, seed=0):
        eng.submit(r)
    eng.run_until_drained()
    who = "" if cfg.arch == "qwen3-8b" else f"{cfg.arch} B {n_req} "
    name = f"{phase} {who}{cfg.num_layers} layers S {seq} {mode} {'/'.join(combo)}"
    check(len(ex.waves) == 1 and len(eng.done) == n_req, f"{name}: not one wave of {n_req}")
    check(ex.waves[0]["seq"] == seq and ex.waves[0]["chunks"] == [seq // LONG_M] * LONG_M,
          f"{name}: the wave ran S {ex.waves[0]['seq']} as {ex.waves[0]['chunks']}")
    logits = np.stack([r.result for r in sorted(eng.done, key=lambda r: r.rid)])
    check(logits.shape == (n_req, pad_vocab(cfg.vocab_size)), f"{name}: logits {logits.shape}")
    check(bool(np.isfinite(logits).all()), f"{name}: non-finite logits")
    log(f"  {name}: argmax {logits.argmax(-1).tolist()}, wave {ex.waves[0]['dur']:.4f} s")
    return logits, ex.waves[0]


def logit_err(got, want) -> tuple:
    """(max abs error as a fraction of max|want|, argmaxes equal)."""
    import numpy as np
    return (float(np.abs(got - want).max() / np.abs(want).max()),
            int((got.argmax(-1) == want.argmax(-1)).sum()))


def long_phase(results: dict, counted=None) -> None:
    """[long]: qwen3-8b at full width, bf16, through PrefillEngine +
    TorchExecutor at EngineConfig's default buckets (``long_run``): at the
    largest, S = LONG_SEQ = 131072 (N 8, M 8, C 16384, one request a wave),
    and at S = HELD_SEQ = 32768 (C 4096).

    (b) at 8 layers (one a stage), S 131072, first (its waves warm the
    kernels): a mocap wave of LONG_COMBO (qship, K1 + K2 on the ``cuda``
    pool) with every K1 and K2 launch held against its plain version on
    every row's last LONG_Q_BLOCK queries (``shadowed(q_block=)``, worst <=
    1 of ``fault_ratio``), then a mocap wave of LONG_PAGED (K1 + K3 on pages
    of 16384) with every K1 and K3 launch held so; the two waves' logits
    within BF16_POOL_PAIR_TOL of max|logit| (``long_chunk_held``);
    (c) at 8 layers, S 32768, LONG_HELD_BATCH request: the four LONG_HELD
    combinations, each held against the P32 witness (``p32_witness``,
    tiled) on the same pages (auto, int8, fp8) at
    BF16_LOGIT_TOL["qwen3-8b"], the K2 and K3 pools to BF16_POOL_PAIR_TOL,
    every K3 launch of the paged runs held as in (b) (``long_witness_runs``);
    (d) planted faults: on (b)'s waves each of ``long_faults`` at
    LONG_FAULT_KEYS (K1) and at CHUNK_FAULT_KEYS (K1 and K2 on the cuda
    wave, K3 on the paged one), which only a launch of more keys shows, must
    break the sliced per-launch check (each run stops at its first broken
    launch, ``stop_on_break``); on (c)'s, the two of
    ``planted_faults("pool_attention")`` on the held qship/cuda/cuda/auto run
    must break the witness limit and K3's at LONG_FAULT_KEYS the sliced
    check on the held qship/cuda/paged/auto run;
    (a) full depth (36 layers, 5 a stage), S 131072, after (b) and (c): the
    mocap wave of LONG_COMBO and the terapipe wave of the same combination,
    the first waves at full depth (``long_full_depth``).
    The 8-layer weights of (b) and (c) are freed before (a)'s are drawn."""
    import torch
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.core import pipeline as pp
    from repro_torch.core.staging import init_staged

    card = card_line()
    full = get_config("qwen3-8b")
    cfg = depth(full, N_STAGES)
    failures: list = []
    t0 = time.perf_counter()
    staged = init_staged(cfg, pp.build_plan(cfg, N_STAGES, LONG_SEQ, RunConfig(
        num_chunks=LONG_M, num_stages=N_STAGES)), torch.Generator(device="cuda").manual_seed(0),
        device="cuda")
    torch.cuda.synchronize()
    log(f"[long] {full.arch} bf16 on {card}, N {N_STAGES}, M {LONG_M}, EngineConfig's "
        f"default buckets; {cfg.num_layers} layers at full width (one a stage): weights "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    long_chunk_held(cfg, staged, results, failures)
    log(f"  (b) S {LONG_SEQ} at {cfg.num_layers} layers, its faults: "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    long_witness_runs(cfg, staged, results, failures)
    log(f"  (c) S {HELD_SEQ} at {cfg.num_layers} layers, its faults: "
        f"{time.perf_counter() - t0:.1f} s")
    del staged
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    long_full_depth(full, results, failures, counted)
    log(f"  (a) S {LONG_SEQ} at {full.num_layers} layers: {time.perf_counter() - t0:.1f} s")
    check(not failures, "; ".join(failures))


def long_chunk_held(cfg, staged, results: dict, failures: list) -> None:
    """(b) of ``long_phase`` and its planted faults, on ``cfg`` (8 layers)."""
    import contextlib as cl
    from repro_torch.kernels import ops
    held = {}
    for combo in (LONG_COMBO, LONG_PAGED):
        kinds = ("chunk_attention",
                 "pool_attention" if combo[2] == "cuda" else "pool_attention_paged")
        worst = {k: [0.0] for k in kinds}
        t0 = time.perf_counter()
        ops.reset_launches()
        with cl.ExitStack() as stack:
            for k in kinds:
                stack.enter_context(swapped(ops, k, shadowed(getattr(ops, k), k, worst[k],
                                                             q_block=LONG_Q_BLOCK)))
            held[combo] = long_run(cfg, staged, combo)[0]
        launches = {k: v for k, v in ops.LAUNCHES.items() if v}
        log(f"  every launch of the wave above ({launches}) against its plain version on "
            f"every row's last {LONG_Q_BLOCK} queries: worst "
            + ", ".join(f"{k} {w[0]:.3e}" for k, w in worst.items())
            + f" of the tolerance ({time.perf_counter() - t0:.1f} s)")
        for k, w in worst.items():
            if w[0] > 1.0:
                failures.append(f"[long] S {LONG_SEQ} {k} per launch: {w[0]} of the tolerance")
            res = results.setdefault(k, {})
            res["max_err_long_chunk_slices"] = max(res.get("max_err_long_chunk_slices", 0.0),
                                                   w[0])
        for k, n in launches.items():
            results.setdefault(k, {}).setdefault("launches_by_path", {})[
                f"long S {LONG_SEQ} held {combo[2]} pool (8 layers)"] = n
    err, same = logit_err(held[LONG_COMBO], held[LONG_PAGED])
    log(f"  cuda pool (K2) against paged pool (K3) at S {LONG_SEQ}: {err:.3e} of max|logit| "
        f"(limit {BF16_POOL_PAIR_TOL}), argmax equal {same}/{len(held[LONG_COMBO])}")
    if err > BF16_POOL_PAIR_TOL:
        failures.append(f"[long] S {LONG_SEQ}: K2 and K3 pools differ by {err}")

    # (d) the faults only a long launch shows, on the waves above
    for keys, kinds in ((LONG_FAULT_KEYS, ("chunk_attention",)),
                        (CHUNK_FAULT_KEYS, ("chunk_attention", "pool_attention",
                                            "pool_attention_paged"))):
        faults = long_faults(ops.chunk_attention, ops.pool_attention_paged,
                             ops.pool_attention, keys=keys)
        for kind in kinds:
            combo = LONG_PAGED if kind == "pool_attention_paged" else LONG_COMBO
            name, fault = faults[kind]
            long_fault(name, kind, fault, lambda: long_run(cfg, staged, combo), failures,
                       results)


def long_witness_runs(cfg, staged, results: dict, failures: list) -> None:
    """(c) of ``long_phase`` and its planted faults, on ``cfg`` (8 layers)."""
    import contextlib as cl
    from repro_torch.core import attention
    from repro_torch.kernels import ops

    def held_run(combo):
        return long_run(cfg, staged, combo, seq=HELD_SEQ, n_req=LONG_HELD_BATCH)[0]

    t0 = time.perf_counter()
    with swapped(attention, "_BACKENDS", dict(attention._BACKENDS, torch=p32_witness())):
        witness = {kv: held_run(("qship", "torch", "torch", kv))
                   for kv in sorted({combo[3] for combo in LONG_HELD})}
    log(f"  (the runs above: the P32 witness, {time.perf_counter() - t0:.1f} s)")
    k3 = "pool_attention_paged"
    worst3 = [0.0]
    held = {}
    ops.reset_launches()
    for combo in LONG_HELD:
        with (swapped(ops, k3, shadowed(ops.pool_attention_paged, k3, worst3,
                                        q_block=LONG_Q_BLOCK))
              if combo[2] == "paged" else cl.nullcontext()):
            held[combo] = held_run(combo)
    for k, n in ops.LAUNCHES.items():
        if n:
            results.setdefault(k, {}).setdefault("launches_by_path", {})[
                "long held (8 layers)"] = n
    log(f"  launches of the held runs {dict(ops.LAUNCHES)}; every K3 launch against its "
        f"plain version on every row's last {LONG_Q_BLOCK} queries: worst {worst3[0]:.3e} "
        f"of the tolerance")
    results.setdefault(k3, {})["max_err_long_slices"] = worst3[0]
    if worst3[0] > 1.0:
        failures.append(f"[long] K3 per launch: {worst3[0]} of the tolerance")
    tol = BF16_LOGIT_TOL["qwen3-8b"]
    for combo, logits in held.items():
        err, same = logit_err(logits, witness[combo[3]])
        log(f"  {'/'.join(combo)} vs the witness: max abs err {err:.3e} of max|logit| "
            f"(limit {tol}), argmax equal {same}/{len(logits)}")
        if err > tol:
            failures.append(f"[long] {'/'.join(combo)}: logits err {err} vs the witness")
    err, _ = logit_err(held[LONG_COMBO], held[LONG_PAGED])
    log(f"  cuda pool (K2) against paged pool (K3): {err:.3e} of max|logit| "
        f"(limit {BF16_POOL_PAIR_TOL})")
    if err > BF16_POOL_PAIR_TOL:
        failures.append(f"[long] K2 and K3 pools differ by {err}")

    # (d) the planted K2 faults against the witness; K3's long-only fault per launch
    for fault_name, fn in planted_faults("pool_attention", ops.pool_attention).items():
        with swapped(ops, "pool_attention", fn):
            err, same = logit_err(held_run(LONG_COMBO), witness["auto"])
        log(f"  planted fault: {fault_name} ({'/'.join(LONG_COMBO)}): {err:.3e} of "
            f"max|logit| vs the witness (limit {tol}), argmax equal {same}")
        results.setdefault("pool_attention", {}).setdefault("planted", {})[
            f"long: {fault_name}"] = err / tol
        if err <= tol:
            failures.append(f"[long] planted fault '{fault_name}' passes ({err})")
    name, fault = long_faults(ops.chunk_attention, ops.pool_attention_paged)[k3]
    long_fault(name, k3, fault, lambda: held_run(LONG_PAGED), failures, results)


def long_full_depth(full, results: dict, failures: list, counted=None, *,
                    seq: int = LONG_SEQ, batch: int = LONG_BATCH, phase: str = "[long]",
                    traced=("mocap", "terapipe"), peaks: Optional[dict] = None) -> None:
    """(a) of ``long_phase``, on ``full`` (36 layers): the mocap wave of
    LONG_COMBO, then the same combination under terapipe, each under
    torch.profiler (``with_flops``) with the launch counters set to 0 just
    before it and read just after (mocap: K1 75, K2 150; terapipe: its own
    closed form, ``wave_launch_form``); its wall time (the profiler's CPU
    activity included), its peak memory (``max_memory_allocated``, reset
    before it), the bytes of the pool it allocated held exactly to the
    plan's (one page a chunk: (slots + 1) x N chunk-pages of 5 layers x 1
    row x 16384 x 8 x 128 x 2 B x (K, V): 18.79 GB under MBKR, 24.16 GB
    under terapipe), the stage telemetry, whose largest per-stage peak
    ``kv_bytes`` under MBKR must be exactly 6/8 of terapipe's (the plan's
    slot ratio), and its device time by category and idle share
    (``categorize``); the mocap wave's product FLOPs against the meta count
    of the same wave (``count_roofline_wave(LONG_SEQ, LONG_BATCH)``,
    ``counted``: counted beside the build), its bound / busy share and MFU;
    the mocap logits against terapipe's at BF16_LOGIT_TOL of max|logit|
    (two summation orders in bf16), argmax reported. Each wave's numbers
    land under ``results[kernel]["long_s<LONG_SEQ>"]`` of K1 and K2.

    The same for another model at ``seq`` and ``batch`` (``phase``
    [long-ssm]: zamba2-7b, K4 too, its launches in the closed form and its
    numbers under ``"long_ssm_s<seq>"``): only the waves in ``traced`` run
    under torch.profiler (the others untraced, the launches still counted),
    and, with ``peaks`` (mode -> the meta count of that wave, ``counted``
    the mocap one), each wave's measured peak must lie in [counted peak,
    PEAK_SLACK[0] x counted + PEAK_SLACK[1]]."""
    import contextlib as cl
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import RunConfig, ShapeConfig
    from repro_torch.core import pipeline as pp
    from repro_torch.core.staging import init_staged
    from repro_torch.kernels import ops
    from repro_torch.obs import telemetry as obs_t
    from repro_torch.roofline import analysis

    card = card_line()
    tag = phase.strip("[]")
    where = tag if phase == "[long]" else f"{tag} {full.arch}"
    plans = {mode: pp.build_plan(full, N_STAGES, seq,
                                 RunConfig(num_chunks=LONG_M, num_stages=N_STAGES,
                                           mbkr=mode == "mocap", attn_backend="cuda",
                                           pool_backend="cuda", ssm_backend="cuda"),
                                 mode=mode)
             for mode in ("mocap", "terapipe")}
    plan = plans["mocap"]
    c, lps = plan.chunk_len, plan.layers_per_stage
    check(plan.pages_per_chunk == 1 and plan.page_tokens == c,
          f"{phase} {plan.pages_per_chunk} pages of {plan.page_tokens} a chunk")
    page = lps * batch * c * full.num_kv_heads * full.resolved_head_dim * 2 * 2
    want_pool = {mode: (p.num_slots + 1) * N_STAGES * page for mode, p in plans.items()}
    log(f"{phase} {full.arch} bf16 S {seq} = M {LONG_M} x C {c}, N {N_STAGES}, "
        f"B {batch}, {full.num_layers} layers (lps {lps}), on {card}; slots mocap "
        f"{plan.num_slots} (p2 {plan.p2}) / terapipe {plans['terapipe'].num_slots}; "
        f"a chunk-page {page / 1e6:.1f} MB; pools by the plan "
        + ", ".join(f"{m} {b / 1e9:.2f} GB" for m, b in want_pool.items()))

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    staged = init_staged(full, plan, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated() - before
    log(f"  bf16 weights: {weights / 2**30:.2f} GiB in {time.perf_counter() - t0:.2f} s")

    # the counted main path: one mocap wave, one terapipe wave, each under
    # torch.profiler where ``traced`` (its device time by category; mocap's
    # product FLOPs against the meta count)
    waves, logits = {}, {}
    for mode in ("mocap", "terapipe"):
        sizes: list = []
        on = mode in traced
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        with swapped(pp, "alloc_kv_pool", pool_recorder(sizes)), (profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                with_flops=True) if on else cl.nullcontext()) as prof:
            logits[mode], wave = long_run(full, staged, LONG_COMBO, seq=seq, mode=mode,
                                          n_req=batch, telemetry=True, phase=phase)
            torch.cuda.synchronize()
        launches = {k: v for k, v in ops.LAUNCHES.items() if v}
        peak = torch.cuda.max_memory_allocated() - before
        clocks = card_clocks()
        form = wave_launch_form(plans[mode], full)
        kv_peaks = obs_t.TelemetryProfile.from_run(wave["telemetry"]).per_stage_peak(
            "kv_bytes")
        waves[mode] = dict(wave_s=wave["dur"], launches=launches, peak_gib=peak / 2**30,
                           rest_gib=(peak - weights) / 2**30, weights_gib=weights / 2**30,
                           pool_gb=sizes[0] / 1e9 if sizes else 0.0,
                           kv_peak_bytes=float(kv_peaks.max()), traced=on, card=card)
        log(f"  [{card}] {mode}: wave {wave['dur']:.4f} s (host clock, "
            f"{'traced' if on else 'untraced'}; the first wave at full depth, the kernels "
            f"warmed by (b)); launches {launches}, closed form {form}; peak "
            f"{peak / 2**30:.2f} GiB (max_memory_allocated less what was allocated before the "
            f"weights; less the weights {(peak - weights) / 2**30:.2f}); pool "
            f"{sizes[0] / 1e9 if sizes else 0:.4f} GB allocated, {want_pool[mode] / 1e9:.4f} GB "
            f"by the plan; per-stage peak kv_bytes GB "
            f"{' '.join(f'{x / 1e9:.4f}' for x in kv_peaks)}")
        if on:
            prof_flops, spans = profiled_wave(prof)
            del prof
            check(bool(spans), f"{phase} the {mode} wave holds no device time")
            busy, window = busy_window(spans)
            split, by_name = categorize(spans)
            waves[mode].update(flops=prof_flops, busy_s=busy, window_s=window,
                               idle_share=1.0 - busy / window, device_s=split)
            log(f"[wave] {full.arch} bf16 S {seq} {mode} {'/'.join(LONG_COMBO)}: "
                f"{len(spans)} device activities; busy {busy:.4f} s of a {window:.4f} s "
                f"window, idle share {1.0 - busy / window:.4f}; card after it (SM clock, its "
                f"max, power draw, temperature): {clocks}")
            log_split(split, by_name, busy)
        if peaks is not None and mode in peaks:
            cost = peaks[mode][0]
            lo = cost.peak_live_bytes
            hi = PEAK_SLACK[0] * lo + PEAK_SLACK[1]
            waves[mode]["counted_peak_gib"] = lo / 2**30
            log(f"  [{card}] {mode}: peak counted {lo / 2**30:.4f} <= measured "
                f"{peak / 2**30:.4f} <= {hi / 2**30:.4f} GiB (PEAK_SLACK; the gap "
                f"{(peak - lo) / 2**20:.1f} MiB); launches counted {cost.launches}")
            check(lo <= peak <= hi, f"{phase} {mode} peak memory {peak} outside [{lo}, {hi}]")
            check(cost.launches == launches,
                  f"{phase} {mode} counted launches {cost.launches} != {launches}")
        check(launches == form, f"{phase} {mode} launches {launches} != closed form {form}")
        check(sizes == [want_pool[mode]],
              f"{phase} {mode} pool bytes {sizes} != the plan's {want_pool[mode]}")
        for k, n in launches.items():
            results.setdefault(k, {}).setdefault("launches_by_path", {})[
                f"{where} S {seq} {mode} wave"] = n
    ratio = waves["mocap"]["kv_peak_bytes"] / waves["terapipe"]["kv_peak_bytes"]
    slots = plan.num_slots / plans["terapipe"].num_slots
    log(f"  MBKR against terapipe: largest per-stage peak kv_bytes "
        f"{waves['mocap']['kv_peak_bytes'] / 1e9:.4f} / "
        f"{waves['terapipe']['kv_peak_bytes'] / 1e9:.4f} "
        f"GB = {ratio:.6f} (the plan's slots {slots:.6f}); measured peaks differ by "
        f"{waves['terapipe']['peak_gib'] - waves['mocap']['peak_gib']:.3f} GiB, the pools by "
        f"{(want_pool['terapipe'] - want_pool['mocap']) / 1e9:.3f} GB")
    check(ratio == slots, f"{phase} per-stage peak kv_bytes ratio {ratio} != {slots}")
    err, same = logit_err(logits["mocap"], logits["terapipe"])
    tol = BF16_LOGIT_TOL[full.arch]
    log(f"  mocap against terapipe logits: max abs err {err:.3e} of max|logit| (limit {tol}; "
        f"two bf16 summation orders), argmax mocap {logits['mocap'].argmax(-1).tolist()} / "
        f"terapipe {logits['terapipe'].argmax(-1).tolist()}, equal {same}/{len(logits['mocap'])}")
    if err > tol:
        failures.append(f"{phase} S {seq}: mocap vs terapipe logits err {err}")

    # the mocap wave's roofline against its meta count
    cost, count_s = counted or count_roofline_wave(seq, batch, full.arch, "mocap")
    terms = analysis.analyze_counted(cost, full, ShapeConfig("long wave", "prefill",
                                                             seq, batch))
    wave_s, busy, prof_flops = (waves["mocap"][k] for k in ("wave_s", "busy_s", "flops"))
    mfu = terms.model_flops / (analysis.HW_H100["peak_flops"] * wave_s)
    rel = abs(cost.product_flops - prof_flops) / max(prof_flops, 1.0)
    waves["mocap"].update(share=terms.bound_s / busy, mfu=mfu, bound_s=terms.bound_s,
                          counted_peak_gib=cost.peak_live_bytes / 2**30)
    log(f"  [{card}] roofline of the long wave (counted on meta in {count_s:.1f} s): FLOPs "
        f"{cost.flops:.6e} (products {cost.product_flops:.6e}, "
        f"{' / '.join(v for k, v in KERNEL_IDS.items() if k in cost.launches)} "
        f"{cost.kernel_flops:.6e}), model_flops {terms.model_flops:.6e}, bound_s "
        f"{terms.bound_s:.4f} ({terms.dominant}), counted peak "
        f"{cost.peak_live_bytes / 2**30:.2f} GiB, launches {cost.launches}; profiler product "
        f"FLOPs {prof_flops:.6e} (rel {rel:.3e}); share bound_s / busy "
        f"{terms.bound_s / busy:.4f}; MFU model_flops / (989e12 x {wave_s:.4f} s) {mfu:.4f}")
    check(cost.launches == waves["mocap"]["launches"],
          f"{phase} counted launches {cost.launches} != {waves['mocap']['launches']}")
    check(prof_flops > 0 and rel <= 1e-6,
          f"{phase} product FLOPs: counted {cost.product_flops} vs profiler {prof_flops}")
    check(terms.bound_s <= BOUND_SLACK * busy,
          f"{phase} bound_s {terms.bound_s} > {BOUND_SLACK} x busy {busy}")
    for k in waves["mocap"]["launches"]:
        results.setdefault(k, {})[f"{tag.replace('-', '_')}_s{seq}"] = {
            "mocap vs terapipe logits err": err, **waves}
    del staged
    torch.cuda.empty_cache()


def long_fault(name: str, kind: str, fault, run, failures: list, results: dict,
               phase: str = "[long]") -> None:
    """``fault`` in the place of ``ops.<kind>`` under the sliced per-launch
    check (K4: every launch held whole); ``run`` stops at its first launch
    that breaks it, which must come. Its reading lands under
    ``results[kind]["planted"]``."""
    from repro_torch.kernels import ops
    worst, calls = [0.0], [0]

    def counted(*args, **kw):
        calls[0] += 1
        return fault(*args, **kw)
    t0 = time.perf_counter()
    try:
        q_block = None if kind == "ssd" else LONG_Q_BLOCK
        with swapped(ops, kind, stop_on_break(shadowed(counted, kind, worst,
                                                       q_block=q_block), worst)):
            run()
    except FaultSeen:
        pass
    log(f"  planted fault: {name}: worst {worst[0]:.3e} of the tolerance, at launch "
        f"{calls[0]} ({time.perf_counter() - t0:.1f} s)")
    results.setdefault(kind, {}).setdefault("planted", {})[
        f"{phase[1:-1]}: {name}"] = worst[0]
    if worst[0] <= 1.0:
        failures.append(f"{phase} planted fault '{name}' passes ({worst[0]})")


# ----------------------------------------------------------------- long-ssm

def long_ssm_phase(results: dict, counts: Optional[dict] = None) -> None:
    """[long-ssm]: the Mamba2 families at full width, bf16, through
    PrefillEngine + TorchExecutor at EngineConfig's default buckets
    (``long_run``, the SSD on K4) at S = HELD_SEQ = 32768 (N 8, M 8, C
    4096), where K4 runs 16 SSD chunks of 256 in one launch and K1-K3 see
    4096-token chunks at zamba2-7b's shared block (32 heads of 112, MHA).

    (b) zamba2-7b at one hybrid group a stage (45 layers), SSM_HELD_BATCH
    request, mocap, first (its waves warm the kernels): a qship/cuda/cuda
    wave with every K1 and K2 launch held against its plain version on
    every row's last LONG_Q_BLOCK queries and every K4 launch held whole
    (``shadowed``), then a qship/cuda/paged wave with every K1 and K3
    launch held so; the two waves' logits within BF16_POOL_PAIR_TOL of
    max|logit| (``long_ssm_held``);
    (c) on (b)'s waves the planted faults only a long launch shows
    (``long_faults``): K1, K2 and K3 dropping the keys past
    LONG_FAULT_KEYS, K4 starting each SSD chunk at or past position
    SSD_FAULT_POS from a zero state; each must break its per-launch check, its run stopping at
    the first broken launch;
    (a) zamba2-7b at full depth (81 layers, 2 groups a stage), a wave of
    SSM_LONG_BATCH requests, the mocap wave under torch.profiler and the
    terapipe wave untraced (``long_full_depth``): launches against the
    closed form (K1 30, K2 60 / 30, K4 150), the pools' bytes exactly the
    plan's (13.15 / 16.91 GB), the per-stage peak kv_bytes ratio exactly
    6/8, each peak within PEAK_SLACK of its meta count (``counts``: mode ->
    ``count_roofline_wave`` of that wave, counted beside the build), the
    mocap wave's product FLOPs against its count, its device time by
    category and idle share, mocap's logits against terapipe's;
    (d) mamba2-130m at full depth (24 layers, 3 a stage), SSM_LONG_BATCH
    requests, terapipe: one wave with every K4 launch held whole (K4 45
    launches, the closed form), then the K4 fault of (c) on it
    (``long_ssm_mamba``).
    The weights of (b) are freed before (a)'s are drawn, (a)'s before
    (d)'s."""
    import torch
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.core import pipeline as pp
    from repro_torch.core.staging import init_staged

    card = card_line()
    full = get_config("zamba2-7b")
    cfg = depth(full, N_STAGES)
    failures: list = []
    t0 = time.perf_counter()
    staged = init_staged(cfg, pp.build_plan(cfg, N_STAGES, HELD_SEQ, RunConfig(
        num_chunks=LONG_M, num_stages=N_STAGES)), torch.Generator(device="cuda").manual_seed(0),
        device="cuda")
    torch.cuda.synchronize()
    log(f"[long-ssm] {full.arch} bf16 on {card}, N {N_STAGES}, M {LONG_M}, S {HELD_SEQ}, "
        f"EngineConfig's default buckets; {cfg.num_layers} layers at full width (one hybrid "
        f"group a stage): weights {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    long_ssm_held(cfg, staged, results, failures)
    log(f"  (b), (c) S {HELD_SEQ} at {cfg.num_layers} layers, its faults: "
        f"{time.perf_counter() - t0:.1f} s")
    del staged
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    counts = counts or {mode: count_roofline_wave(HELD_SEQ, SSM_LONG_BATCH, full.arch, mode)
                        for mode in ("mocap", "terapipe")}
    long_full_depth(full, results, failures, counts["mocap"], seq=HELD_SEQ,
                    batch=SSM_LONG_BATCH, phase="[long-ssm]", traced=("mocap",), peaks=counts)
    log(f"  (a) S {HELD_SEQ} at {full.num_layers} layers: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    long_ssm_mamba(results, failures)
    log(f"  (d) mamba2-130m S {HELD_SEQ}: {time.perf_counter() - t0:.1f} s")
    check(not failures, "; ".join(failures))


def long_ssm_held(cfg, staged, results: dict, failures: list) -> None:
    """(b) and (c) of ``long_ssm_phase``, on ``cfg`` (zamba2-7b, one hybrid
    group a stage)."""
    import contextlib as cl
    from repro_torch.kernels import ops

    def run(combo):
        return long_run(cfg, staged, combo, seq=HELD_SEQ, n_req=SSM_HELD_BATCH,
                        phase="[long-ssm]")

    held = {}
    for combo in (LONG_COMBO, LONG_PAGED):
        kinds = (("chunk_attention", "pool_attention", "ssd") if combo[2] == "cuda"
                 else ("chunk_attention", "pool_attention_paged"))
        worst = {k: [0.0] for k in kinds}
        t0 = time.perf_counter()
        ops.reset_launches()
        with cl.ExitStack() as stack:
            for k in kinds:
                q_block = None if k == "ssd" else LONG_Q_BLOCK
                stack.enter_context(swapped(ops, k, shadowed(getattr(ops, k), k, worst[k],
                                                             q_block=q_block)))
            held[combo] = run(combo)[0]
        launches = {k: v for k, v in ops.LAUNCHES.items() if v}
        log(f"  every launch of the wave above ({launches}) against its plain version (K1-K3 "
            f"on every row's last {LONG_Q_BLOCK} queries, K4 whole): worst "
            + ", ".join(f"{k} {w[0]:.3e}" for k, w in worst.items())
            + f" of the tolerance ({time.perf_counter() - t0:.1f} s)")
        for k, w in worst.items():
            if w[0] > 1.0:
                failures.append(f"[long-ssm] {k} per launch: {w[0]} of the tolerance")
            res = results.setdefault(k, {})
            res["max_err_long_ssm"] = max(res.get("max_err_long_ssm", 0.0), w[0])
        for k, n in launches.items():
            results.setdefault(k, {}).setdefault("launches_by_path", {})[
                f"long-ssm {cfg.arch} S {HELD_SEQ} held {combo[2]} pool "
                f"({cfg.num_layers} layers)"] = n
    err, same = logit_err(held[LONG_COMBO], held[LONG_PAGED])
    log(f"  cuda pool (K2) against paged pool (K3): {err:.3e} of max|logit| (limit "
        f"{BF16_POOL_PAIR_TOL}), argmax equal {same}/{len(held[LONG_COMBO])}")
    if err > BF16_POOL_PAIR_TOL:
        failures.append(f"[long-ssm] K2 and K3 pools differ by {err}")

    # (c) the faults only a long launch shows, on the waves above
    faults = long_faults(ops.chunk_attention, ops.pool_attention_paged, ops.pool_attention,
                         k4=ops.ssd)
    for kind in ("chunk_attention", "pool_attention", "pool_attention_paged", "ssd"):
        combo = LONG_PAGED if kind == "pool_attention_paged" else LONG_COMBO
        name, fault = faults[kind]
        long_fault(name, kind, fault, lambda: run(combo), failures, results,
                   phase="[long-ssm]")


def long_ssm_mamba(results: dict, failures: list) -> None:
    """(d) of ``long_ssm_phase``: mamba2-130m at full depth, terapipe."""
    import torch
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.core import pipeline as pp
    from repro_torch.core.staging import init_staged
    from repro_torch.kernels import ops

    cfg = get_config("mamba2-130m")
    plan = pp.build_plan(cfg, N_STAGES, HELD_SEQ, RunConfig(
        num_chunks=LONG_M, num_stages=N_STAGES, mbkr=False, ssm_backend="cuda"),
        mode="terapipe")
    staged = init_staged(cfg, plan, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")

    def run():
        return long_run(cfg, staged, LONG_COMBO, seq=HELD_SEQ, mode="terapipe",
                        n_req=SSM_LONG_BATCH, phase="[long-ssm]")

    worst = [0.0]
    t0 = time.perf_counter()
    ops.reset_launches()
    with swapped(ops, "ssd", shadowed(ops.ssd, "ssd", worst)):
        run()
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    form = wave_launch_form(plan, cfg)
    log(f"  {cfg.arch} lps {plan.layers_per_stage}: launches {launches}, closed form {form}; "
        f"every K4 launch against its plain version: worst {worst[0]:.3e} of the tolerance "
        f"({time.perf_counter() - t0:.1f} s)")
    check(launches == form, f"[long-ssm] {cfg.arch} launches {launches} != closed form {form}")
    if worst[0] > 1.0:
        failures.append(f"[long-ssm] {cfg.arch} ssd per launch: {worst[0]} of the tolerance")
    res = results.setdefault("ssd", {})
    res["max_err_long_ssm"] = max(res.get("max_err_long_ssm", 0.0), worst[0])
    res.setdefault("launches_by_path", {})[
        f"long-ssm {cfg.arch} S {HELD_SEQ} terapipe wave"] = launches["ssd"]
    name, fault = long_faults(ops.chunk_attention, ops.pool_attention_paged,
                              k4=ops.ssd)["ssd"]
    long_fault(f"{name} ({cfg.arch})", "ssd", fault, run, failures, results,
               phase="[long-ssm]")
    del staged
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- frontends

# the two families fed from outside the token stream, through
# ``prefill_pipeline(embeds=)`` (``TorchExecutor`` passes no embeddings, as
# the reference's executor): arch -> ``layers`` (None: full depth), the
# pipeline (N, M, C), fp32 runs or not. llava-next-34b: 8 layers at full
# width (60 are ~67 GB of bf16), S = 4096 = its 2880 patch embeddings then
# 1216 tokens, so chunk 5 (positions 2560-3071) straddles the front.
# whisper-small: full width and depth, 1500 frames into the encoder, a
# decoder prompt of 448 tokens (its published context) as 8 chunks of 56
# (N 4, M 7, C 64 has p2 = M - 1: no chunk would read a remote one; at
# N 8, M 8 chunk 7 reads chunk 6 at the pair)
FRONTEND_MODELS = {"llava-next-34b": dict(layers=N_STAGES, pipe=(N_STAGES, N_CHUNKS, CHUNK),
                                          fp32=False),
                   "whisper-small": dict(layers=None, pipe=(N_STAGES, 8, WHISPER_C),
                                         fp32=True)}
FRONTEND_COMBOS = (("qship", "cuda", "cuda"), ("fetch", "cuda", "paged"))


def frontend_model(arch: str, results: dict) -> None:
    """One frontend model at full width (``FRONTEND_MODELS``' depth), B = 2
    rows, random weights and seeded frontend embeddings (0.02 x a standard
    normal), through ``prefill_pipeline(embeds=)``.

    bf16, the model's main path: the launch counters are set to 0 just
    before FRONTEND_COMBOS and read just after; K1, K2 and K3 must each
    have launched. Each combination's logits are held against the
    ``torch`` backends with p in fp32 (``p32_witness``) within
    BF16_LOGIT_TOL of max|logit|. Then every K1, K2 and K3 launch of each
    combination is held against its plain version on its own inputs
    (``shadowed``; K1's calls told apart as the causal self block, the
    decoder's cross-attention and the encoder), which the real kernels
    must pass and each planted K2 fault (``planted_faults``) and, for
    whisper-small, each planted non-causal K1 fault
    (``full_attention_faults``) must break. One more qship/cuda wave runs
    through ``obs.profile.measure_prefill(embeds=)``: its tick spans and
    per-kernel times. fp32 (whisper-small): every combination's argmax
    equal to the ``torch`` backends' and its logits within
    FP32_LOGIT_TOL of max|logit|."""
    import numpy as np
    import torch
    from repro_torch.configs import RunConfig, get_config, replace
    from repro_torch.core import attention
    from repro_torch.core import pipeline as pp
    from repro_torch.core.staging import init_staged
    from repro_torch.kernels import ops
    from repro_torch.models.layers import pad_vocab
    from repro_torch.obs.profile import measure_prefill

    spec = FRONTEND_MODELS[arch]
    n, m, c = spec["pipe"]
    seq = m * c
    full = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    failures = []

    def setup(dtype: str):
        cfg = replace(depth(full, spec["layers"]), dtype=dtype)
        t0 = time.perf_counter()
        gen = torch.Generator(device="cuda").manual_seed(0)
        plan = pp.build_plan(cfg, n, seq, RunConfig(num_chunks=m, num_stages=n))
        staged = init_staged(cfg, plan, gen, device="cuda")
        f = cfg.frontend.num_embeds
        front = (torch.randn((BATCH, f, cfg.d_model), generator=gen, device="cuda")
                 * 0.02).to(staged["embed"].dtype)
        n_tok = seq - (f if cfg.family == "vlm" else 0)
        toks = torch.randint(0, cfg.vocab_size, (BATCH, n_tok), generator=gen, device="cuda")
        torch.cuda.synchronize()
        log(f"[frontends] {arch} {dtype} d={cfg.d_model} layers={cfg.num_layers} of "
            f"{full.num_layers} heads={cfg.num_heads}/{cfg.num_kv_heads} "
            f"hd={cfg.resolved_head_dim} front {cfg.frontend.kind} x {f}, {n_tok} tokens, "
            f"N={n} M={m} C={c} lps={plan.layers_per_stage} p2={plan.p2}: weights "
            f"{time.perf_counter() - t0:.2f} s, "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
        check(plan.p2 < m - 1, f"{arch}: the plan has no remote chunk to attend to")
        return cfg, staged, front, toks

    def plan_of(cfg, remote, attn, pool):
        return pp.build_plan(cfg, n, seq, RunConfig(
            num_chunks=m, num_stages=n, remote_attn=remote, attn_backend=attn,
            pool_backend=pool))

    def wave(cfg, staged, front, toks, remote, attn, pool):
        t0 = time.perf_counter()
        out = pp.prefill_pipeline(cfg, staged, toks, plan_of(cfg, remote, attn, pool),
                                  device="cuda", embeds=front)
        logits = out.float().cpu().numpy()
        name = f"{arch} {cfg.dtype} {remote}/{attn}/{pool}"
        check(logits.shape == (BATCH, pad_vocab(cfg.vocab_size)),
              f"{name}: logits shape {logits.shape}")
        check(bool(np.isfinite(logits).all()), f"{name}: non-finite logits")
        log(f"  {name}: argmax {logits.argmax(-1).tolist()}, wall "
            f"{time.perf_counter() - t0:.4f} s")
        return logits

    def err_of(got, want, what: str) -> float:
        err = float(np.abs(got - want).max() / np.abs(want).max())
        same = int((got.argmax(-1) == want.argmax(-1)).sum())
        log(f"    vs {what}: max abs err {err:.3e} of max|logit|, argmax equal "
            f"{same}/{len(want)}")
        return err, same

    def label(q, k, *_, causal_offset=0, **__):
        if k.ndim != 4:                  # K2's slot stack, K3's page store
            return "K2 / K3"
        if causal_offset < k.shape[1]:
            return "K1 self"
        return "K1 encoder" if q.shape[1] == k.shape[1] else "K1 cross"

    # ---- bf16, the main path
    cfg, staged, front, toks = setup("bfloat16")
    run = (cfg, staged, front, toks)
    with swapped(attention, "_BACKENDS", dict(attention._BACKENDS, torch=p32_witness())):
        witness = wave(*run, "qship", "torch", "torch")
    ops.reset_launches()
    bf16 = {combo: wave(*run, *combo) for combo in FRONTEND_COMBOS}
    launches = dict(ops.LAUNCHES)
    log(f"  launches on the {arch} main path: {launches}")
    for name in ATTN_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched on the {arch} main path")
        results[name].setdefault("launches_by_path", {})[arch] = launches[name]
    for combo, logits in bf16.items():
        log(f"  bf16 {'/'.join(combo)}")
        err, _ = err_of(logits, witness, "witness")
        if err > BF16_LOGIT_TOL[arch]:
            failures.append(f"{arch} bf16 {'/'.join(combo)}: {err} of max|logit|")
    _, prof = measure_prefill(cfg, staged, toks, plan_of(cfg, *FRONTEND_COMBOS[0]),
                              device="cuda", embeds=front, warmup=0, timed_kernels=True)
    log(f"  measure_prefill (qship/cuda): wave {prof.tick_s.max(0).sum():.4f} s of tick "
        f"spans, kernel tags (s) { {k: round(v, 4) for k, v in prof.kernel_s.items()} }")
    faults = [(f, "pool_attention", fn) for f, fn in
              planted_faults("pool_attention", ops.pool_attention).items()]
    if cfg.family == "encdec":
        faults += [(f, "chunk_attention", fn) for f, fn in
                   full_attention_faults(ops.chunk_attention).items()]
    runs = [("none (the kernels themselves)", None, None, combo) for combo in FRONTEND_COMBOS]
    runs += [(f, kind, fn, FRONTEND_COMBOS[0]) for f, kind, fn in faults]
    for fault, kind, fn, combo in runs:
        worst, by = [0.0], {}
        with contextlib.ExitStack() as stack:
            for k in ATTN_KERNELS:
                real = fn if k == kind else getattr(ops, k)
                stack.enter_context(swapped(ops, k, shadowed(real, k, worst, by, label)))
            wave(*run, *combo)
        log(f"  per launch, planted fault: {fault} ({'/'.join(combo)}): every K1-K3 launch "
            f"vs its plain version: worst {worst[0]:.3e} of its tolerance "
            f"{ {k: round(v, 4) for k, v in by.items()} }")
        if (worst[0] > 1.0) != (kind is not None):
            failures.append(f"{arch} bf16 per-launch check, planted fault '{fault}': "
                            f"{worst[0]} of the tolerance")
        if kind is not None:
            results[kind].setdefault("planted", {})[f"{arch} per launch: {fault}"] = worst[0]
    del staged, front, toks, run, witness, bf16
    torch.cuda.empty_cache()

    # ---- fp32: the argmax of every row, every combination
    if spec["fp32"]:
        cfg, staged, front, toks = setup("float32")
        run = (cfg, staged, front, toks)
        ref_logits = wave(*run, "qship", "torch", "torch")
        for combo in FRONTEND_COMBOS:
            log(f"  fp32 {'/'.join(combo)}")
            err, same = err_of(wave(*run, *combo), ref_logits, "torch backends")
            if same != BATCH or err >= FP32_LOGIT_TOL[arch]:
                failures.append(f"{arch} fp32 {'/'.join(combo)}: argmax equal {same}, "
                                f"logits err {err}")
        del staged, front, toks, run
        torch.cuda.empty_cache()
    log(f"  {arch} peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated)")
    check(not failures, "; ".join(failures))


def frontend_phase(results: dict) -> None:
    for arch in FRONTEND_MODELS:
        t0 = time.perf_counter()
        frontend_model(arch, results)
        log(f"[frontends] {arch} {time.perf_counter() - t0:.1f} s")


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


def full_attention_faults(real):
    """Wrong versions of ``ops.chunk_attention`` (K1) in its non-causal
    calls (``ops.full_attention``: a causal offset at or past the last key;
    the other calls pass through): one that masks the keys causally from
    offset 0, one that drops the last 64 keys, and one that drops the keys
    past the last whole 64-key tile (28 of 1500)."""
    def causal(q, k, v, *, causal_offset=0, **kw):
        full = causal_offset >= k.shape[1]
        return real(q, k, v, causal_offset=0 if full else causal_offset, **kw)

    def dropping(n_of):
        def fault(q, k, v, *, causal_offset=0, **kw):
            if causal_offset >= k.shape[1]:
                kw["kv_len"] = k.shape[1] - n_of(k.shape[1])
            return real(q, k, v, causal_offset=causal_offset, **kw)
        return fault

    return {"K1 masks the non-causal attention causally": causal,
            "K1 drops the last 64 keys of the non-causal attention": dropping(lambda t: 64),
            "K1 drops the partial last key tile of the non-causal attention":
                dropping(lambda t: t % 64 or 64)}


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
    is printed under its profile's name. Then fp32 at one layer a stage,
    where summation order moves the logits by ~1e-5 of max|logit|: GPipe on
    K1 against MOCAP on the ``torch`` backends, every request's argmax equal
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

    # ---- fp32 (one layer a stage): GPipe on K1 against MOCAP on the torch backends
    cfg32 = replace(depth(cfg, n), dtype="float32")
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


# ---------------------------------------------------------------------- tp

# the manual tensor-parallel lowering on the card (``tp_phase``), every run
# at the serve geometry (N = M = 8, C = 512, S = 4096), random weights from
# seed 0, through PrefillEngine + TorchExecutor(layout=): (a) qwen3-8b at
# full width and depth, tp 2 on the plain TP axis, 4 requests in waves of 2;
# (b) qwen3-14b cut to 8 layers (one a stage) in the kv_split view at tp 16
# = (kv 8, qg 2), its 40 query heads padded to 48 (each shard 1 kv head
# and 3 query heads: G 3 at D 128), one wave of 2; (c) qwen2-moe-a2.7b cut
# to 8 layers with expert parallelism at tp 8 = (kv 8, qg 1), its 60
# routed experts padded to 64 (8 a shard), the shared experts f-sharded,
# one wave of 2
TP_COMBOS = (("qship", "cuda", "cuda"), ("fetch", "cuda", "paged"))
TP_FP32_TOL = 1e-5                 # (a) fp32, one layer a stage: tp 2 vs tp 1
TP_NUMBERS: dict = {}              # the phase's numbers, printed as one JSON line


def tp_serve(cfg, staged, layout, combo, n_req: int, tag: str):
    """``n_req`` requests (seed 0) through PrefillEngine + TorchExecutor
    at ``layout``'s tp under ``combo`` (remote, attn, pool): (logits,
    each wave's wall seconds)."""
    import numpy as np
    from repro_torch.configs import RunConfig
    from repro_torch.launch.serve import make_requests
    from repro_torch.models.layers import pad_vocab
    from repro_torch.runtime.engine import EngineConfig, PrefillEngine, TorchExecutor
    seq = N_CHUNKS * CHUNK
    run = RunConfig(num_chunks=N_CHUNKS, num_stages=N_STAGES, remote_attn=combo[0],
                    attn_backend=combo[1], pool_backend=combo[2], tp_lowering="auto")
    ex = TorchExecutor(cfg, staged, run, device="cuda", layout=layout)
    eng = PrefillEngine(EngineConfig(model=cfg, num_stages=N_STAGES, tp=layout.tp,
                                     num_chunks=N_CHUNKS, max_batch=BATCH, buckets=(seq,),
                                     partition="uniform"), ex)
    for r in make_requests(n_req, seq, cfg.vocab_size, seed=0):
        eng.submit(r)
    eng.run_until_drained()
    done = sorted(eng.done, key=lambda r: r.rid)
    name = f"{tag} {cfg.dtype} tp {layout.tp} {'/'.join(combo)}"
    check(len(done) == n_req, f"{name}: {len(done)} of {n_req} answered")
    logits = np.stack([r.result for r in done])
    check(logits.shape == (n_req, pad_vocab(cfg.vocab_size)), f"{name}: logits shape")
    check(bool(np.isfinite(logits).all()), f"{name}: non-finite logits")
    walls = [w["dur"] for w in ex.waves]
    log(f"  {name}: argmax {logits.argmax(-1).tolist()}, wave wall s "
        f"{[round(w, 4) for w in walls]}")
    return logits, walls


def tp_against(got, want, what: str, spread=None) -> tuple:
    """Logged: max abs err of max|logit|, argmax equal, the top-2 margins of
    ``want``. With ``spread`` (a bf16 spread the same run measured between
    two summation orders of tp 1), the requests whose margin exceeds it,
    whose argmax must then be equal. Returns (err, argmax equal, held
    requests whose argmax differs)."""
    import numpy as np
    err = float(np.abs(got - want).max() / np.abs(want).max())
    top2 = np.sort(want, axis=-1)[:, -2:]
    margin = (top2[:, 1] - top2[:, 0]) / np.abs(want).max()
    same = got.argmax(-1) == want.argmax(-1)
    held = margin > spread if spread is not None else np.ones(len(want), bool)
    bad = [int(i) for i in np.flatnonzero(held & ~same)]
    log(f"    vs {what}: max abs err {err:.3e} of max|logit|, argmax equal "
        f"{int(same.sum())}/{len(want)}, top-2 margins "
        f"{[round(float(x), 5) for x in margin]}"
        + ("" if spread is None else f", held (margin > spread {spread:.3e}) "
           f"{[int(i) for i in np.flatnonzero(held)]}, differing among them {bad}"))
    return err, int(same.sum()), bad


def tp_weights(cfg, plan):
    import torch
    from repro_torch.core.staging import init_staged
    t0 = time.perf_counter()
    staged = init_staged(cfg, plan, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    torch.cuda.synchronize()
    log(f"  {cfg.dtype} weights, {cfg.num_layers} layers: {time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    return staged


def tp_shard(cfg, plan, staged, layout):
    """``staged`` in ``layout``'s manual TP layout (``shard_params``): the
    plan, and the params (the tp 1 copies of the sharded groups freed)."""
    import torch
    from repro_torch.core.staging import manual_tp_plan, shard_params
    t0 = time.perf_counter()
    mtp = manual_tp_plan(cfg, plan, layout)
    out = shard_params(cfg, staged, mtp)
    staged.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"  {mtp}: shard_params {time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    return mtp, out


def tp_main_path(results: dict, path: str, fn, kernels=ATTN_KERNELS):
    """``fn()`` as the path's main path: the launch counters set to 0 just
    before it and read just after; each of ``kernels`` must have
    launched."""
    from repro_torch.kernels import ops
    ops.reset_launches()
    out = fn()
    launches = dict(ops.LAUNCHES)
    log(f"  launches on the {path} main path: {launches}")
    for name in kernels:
        check(launches[name] > 0, f"kernel {name} was not launched on the {path} main path")
        results[name].setdefault("launches_by_path", {})[path] = launches[name]
    return out


def tp_dense(results: dict, failures: list) -> None:
    """(a) qwen3-8b at full width and depth (36 layers), bf16, N 8 x tp 2
    on the plain TP axis (8 / 4 heads and 6144 of 12288 FFN columns a
    shard), qship/``cuda`` and fetch/``paged``, 4 requests in waves of 2,
    against the tp 1 runs of the same weights and prompts: within
    BF16_LOGIT_TOL of max|logit|, and the argmax equal for every request
    whose tp 1 top-2 margin exceeds the bf16 spread this run measures
    between the two tp 1 combinations (two summation orders). Each wave's
    wall time at tp 1 and tp 2, the ``tp`` ledger bytes of one direct
    ``prefill_pipeline`` wave beside their closed form (per active (stage,
    phase) and layer, two psums of 2(k-1)/k x the [B, C, d] partial on
    each of the k chips), the peak memory. Then fp32 at one layer a stage:
    tp 2 within TP_FP32_TOL of tp 1, every argmax equal."""
    import numpy as np
    import torch
    from repro_torch.configs import RunConfig, get_config, replace
    from repro_torch.core import pipeline as pp
    from repro_torch.core.staging import TPLayout
    from repro_torch.launch.serve import make_requests
    arch, path = "qwen3-8b", "tp qwen3-8b"
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(arch)
    seq = N_CHUNKS * CHUNK
    base = RunConfig(num_chunks=N_CHUNKS, num_stages=N_STAGES, tp_lowering="auto")
    plan = pp.build_plan(cfg, N_STAGES, seq, base)
    layout = TPLayout(2)
    log(f"[tp] (a) {arch} d={cfg.d_model} layers={cfg.num_layers} heads={cfg.num_heads}/"
        f"{cfg.num_kv_heads} d_ff={cfg.d_ff} N={N_STAGES} x tp {layout.tp} M={N_CHUNKS} "
        f"C={CHUNK} lps={plan.layers_per_stage} tp_lowering={plan.tp_lowering}")
    staged = tp_weights(cfg, plan)
    tp1 = {combo: tp_serve(cfg, staged, TPLayout(1), combo, REQUESTS, arch)
           for combo in TP_COMBOS}
    spread, _, _ = tp_against(tp1[TP_COMBOS[1]][0], tp1[TP_COMBOS[0]][0],
                              "tp 1 qship/cuda (the bf16 spread of two summation orders)")
    mtp, staged2 = tp_shard(cfg, plan, staged, layout)
    check(mtp.attn and mtp.kv_div == 2 and mtp.ffn, f"{arch} tp 2: {mtp}")
    tp2 = tp_main_path(results, path, lambda: {
        combo: tp_serve(cfg, staged2, layout, combo, REQUESTS, arch) for combo in TP_COMBOS})
    for combo in TP_COMBOS:
        (got, w2), (want, w1) = tp2[combo], tp1[combo]
        log(f"  bf16 {'/'.join(combo)}: wave wall s tp 1 {[round(w, 4) for w in w1]}, "
            f"tp 2 {[round(w, 4) for w in w2]} (x{np.mean(w2[1:]) / np.mean(w1[1:]):.3f} "
            f"on the waves after the first)")
        err, _, bad = tp_against(got, want, "tp 1", spread)
        if err > BF16_LOGIT_TOL[arch] or bad:
            failures.append(f"{path} bf16 {'/'.join(combo)}: err {err}, held argmax "
                            f"differ for {bad}")
        TP_NUMBERS[f"{path} {'/'.join(combo)}"] = dict(
            wave_s_tp1=w1, wave_s_tp2=w2, err=err)
    # the tp ledger key of one wave against its closed form
    toks = np.stack([r.tokens for r in make_requests(BATCH, seq, cfg.vocab_size, seed=0)])
    run = RunConfig(num_chunks=N_CHUNKS, num_stages=N_STAGES, remote_attn="qship",
                    attn_backend="cuda", pool_backend="cuda")
    _, led = pp.prefill_pipeline(cfg, staged2, toks, pp.build_plan(cfg, N_STAGES, seq, run),
                                 device="cuda", return_ledger=True, layout=layout)
    k = layout.tp
    closed = (N_STAGES * N_CHUNKS * plan.layers_per_stage * 2 * 2.0 * (k - 1) / k
              * BATCH * CHUNK * cfg.d_model * 2 * k)
    log(f"  ledger of one wave (2 rows): tp {led['tp']:.6e} B, closed form 2(k-1)/k "
        f"{closed:.6e} B; ring {led['ring']:.6e}, spill {led['spill']:.6e}, qship_q "
        f"{led['qship_q']:.6e}, qship_state {led['qship_state']:.6e}")
    check(abs(led["tp"] - closed) <= 1e-9 * closed, f"{path}: tp ledger {led['tp']} vs {closed}")
    TP_NUMBERS[f"{path} ledger"] = dict(tp=led["tp"], closed_form=closed)
    del staged2
    torch.cuda.empty_cache()
    log(f"  {path} bf16 peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB (torch.cuda.max_memory_allocated)")

    # fp32, one layer a stage
    cfg32 = replace(depth(cfg, N_STAGES), dtype="float32")
    plan32 = pp.build_plan(cfg32, N_STAGES, seq, base)
    staged = tp_weights(cfg32, plan32)
    ref32 = {c: tp_serve(cfg32, staged, TPLayout(1), c, REQUESTS, arch)[0] for c in TP_COMBOS}
    _, staged2 = tp_shard(cfg32, plan32, staged, layout)
    for combo in TP_COMBOS:
        err, same, _ = tp_against(tp_serve(cfg32, staged2, layout, combo, REQUESTS, arch)[0],
                                  ref32[combo], "tp 1")
        if err >= TP_FP32_TOL or same != REQUESTS:
            failures.append(f"{path} fp32 {'/'.join(combo)}: err {err}, argmax equal {same}")
    del staged2
    torch.cuda.empty_cache()


def tp_kv_split(results: dict, failures: list) -> None:
    """(b) qwen3-14b (40 / 8 heads of 128) cut to 8 layers, bf16, the
    kv_split view at tp 16 = (kv 8, qg 2): ``pad_q_heads`` pads 40 -> 48
    query heads (g 5 -> 6, exact: zero ``wq`` columns and ``wo`` rows), so
    each shard runs 1 kv head and 3 query heads, K1-K3 at G 3, D 128 over
    8 x 16 x 2 = 256 rows; one wave of 2 under qship/``cuda`` and
    fetch/``paged`` (the main path), against the unpadded tp 1 wave within
    BF16_LOGIT_TOL. Then every K1, K2 and K3 launch of both combinations is
    held against its plain version on its own inputs (``shadowed``), which
    the real kernels must pass and each planted K2 fault must break."""
    import torch
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.core import pipeline as pp
    from repro_torch.core.staging import TPLayout
    from repro_torch.kernels import ops
    arch, path = "qwen3-14b", "tp qwen3-14b kv_split"
    torch.cuda.reset_peak_memory_stats()
    cfg = depth(get_config(arch), N_STAGES)
    seq = N_CHUNKS * CHUNK
    base = RunConfig(num_chunks=N_CHUNKS, num_stages=N_STAGES)
    kv, qg, g_pad = pp.kv_split_axes(cfg, 16)
    layout = TPLayout(16, kv=kv)
    log(f"[tp] (b) {arch} {cfg.num_layers} layers of {get_config(arch).num_layers}, "
        f"heads {cfg.num_heads}/{cfg.num_kv_heads}, kv_split tp 16 = (kv {kv}, qg {qg}), "
        f"g {cfg.num_heads // cfg.num_kv_heads} -> {g_pad}")
    staged = tp_weights(cfg, pp.build_plan(cfg, N_STAGES, seq, base))
    want = tp_serve(cfg, staged, TPLayout(1), TP_COMBOS[0], BATCH, arch)[0]
    cfg_p, staged = pp.pad_q_heads(cfg, staged, g_pad)
    plan_p = pp.build_plan(cfg_p, N_STAGES, seq, base)
    mtp, staged = tp_shard(cfg_p, plan_p, staged, layout)
    local_h, local_kv = cfg_p.num_heads // mtp.tp, cfg_p.num_kv_heads // mtp.kv_div
    log(f"  each shard: {local_kv} kv head, {local_h} query heads (G {local_h // local_kv}), "
        f"D {cfg_p.resolved_head_dim}; K1-K3 rows {N_STAGES * mtp.tp * BATCH}")
    check(mtp.attn and (local_kv, local_h) == (1, 3), f"{path}: {mtp}")
    runs = tp_main_path(results, path, lambda: {
        combo: tp_serve(cfg_p, staged, layout, combo, BATCH, arch) for combo in TP_COMBOS})
    for combo, (got, walls) in runs.items():
        err, _, _ = tp_against(got, want, "tp 1 (unpadded)")
        if err > BF16_LOGIT_TOL[arch]:
            failures.append(f"{path} {'/'.join(combo)}: err {err}")
        TP_NUMBERS[f"{path} {'/'.join(combo)}"] = dict(wave_s=walls, err=err)
    label = lambda q, k, *_, **__: ("K2 / K3" if k.ndim != 4 else "K1")
    faults = [(f, fn) for f, fn in planted_faults("pool_attention", ops.pool_attention).items()]
    for fault, fn, combo in ([("none (the kernels themselves)", None, c) for c in TP_COMBOS]
                             + [(f, fn, TP_COMBOS[0]) for f, fn in faults]):
        worst, by = [0.0], {}
        with contextlib.ExitStack() as stack:
            for k in ATTN_KERNELS:
                real = fn if (fn is not None and k == "pool_attention") else getattr(ops, k)
                stack.enter_context(swapped(ops, k, shadowed(real, k, worst, by, label)))
            tp_serve(cfg_p, staged, layout, combo, BATCH, arch)
        log(f"  per launch, planted fault: {fault} ({'/'.join(combo)}): every K1-K3 launch "
            f"vs its plain version at G 3: worst {worst[0]:.3e} of its tolerance "
            f"{ {k: round(v, 4) for k, v in by.items()} }")
        if (worst[0] > 1.0) != (fn is not None):
            failures.append(f"{path} per-launch check, planted fault '{fault}': "
                            f"{worst[0]} of the tolerance")
        if fn is not None:
            results["pool_attention"].setdefault("planted", {})[
                f"{path} per launch: {fault}"] = worst[0]
    del staged
    torch.cuda.empty_cache()
    log(f"  {path} peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated)")


def tp_expert_parallel(results: dict, failures: list) -> None:
    """(c) qwen2-moe-a2.7b (16 / 16 heads, 60 experts top-4 + 4 shared)
    cut to 8 layers, expert parallelism at tp 8 = (kv 8, qg 1):
    ``pad_experts`` pads 60 -> 64 routed experts (masked in the router:
    never routable), 8 a shard; the shared experts f-sharded; routing
    computed once, each shard's partial combine summed over the tp axis.
    bf16, one wave of 2 under qship/``cuda`` (the main path: K1, K2), against the
    tp 1 wave of the unpadded weights: the logits' error, the argmax and
    the router's (token, slot) choices that differ, reported (BF16_LOGIT_TOL
    holds no limit for this model: its router flips experts near ties
    under any change of summation order), and the argmax held where the
    tp 1 margin exceeds the spread of that wave against tp 1 fetch/paged.
    fp32 (the same 8 layers): every argmax equal to tp 1's and the logits
    within FP32_LOGIT_TOL."""
    import numpy as np
    import torch
    from repro_torch.configs import RunConfig, get_config, replace
    from repro_torch.core import pipeline as pp
    from repro_torch.core.staging import TPLayout
    from repro_torch.models import layers as layers_mod
    arch, path = "qwen2-moe-a2.7b", "tp qwen2-moe-a2.7b ep"
    torch.cuda.reset_peak_memory_stats()
    full = get_config(arch)
    seq = N_CHUNKS * CHUNK
    base = RunConfig(num_chunks=N_CHUNKS, num_stages=N_STAGES)
    layout = TPLayout(8, kv=8)
    e_pad = -(-full.moe.num_experts // layout.tp) * layout.tp
    route = layers_mod.moe_route
    choices: list = []

    def record(*args, **kw):
        w, picked = route(*args, **kw)
        choices.append(picked.to(torch.uint8))
        return w, picked

    def recorded(fn):
        choices.clear()
        with swapped(layers_mod, "moe_route", record):
            out = fn()
        return out, list(choices)

    for dtype in ("bfloat16", "float32"):
        cfg = replace(depth(full, N_STAGES), dtype=dtype)
        log(f"[tp] (c) {arch} {dtype}, {cfg.num_layers} layers of {full.num_layers}, "
            f"experts {cfg.moe.num_experts} -> {e_pad}, EP at tp {layout.tp} = "
            f"(kv {layout.kv}, qg {layout.qg})")
        staged = tp_weights(cfg, pp.build_plan(cfg, N_STAGES, seq, base))
        (want, _), picked1 = recorded(
            lambda: tp_serve(cfg, staged, TPLayout(1), TP_COMBOS[0], BATCH, arch))
        spread = None
        if dtype == "bfloat16":
            other = tp_serve(cfg, staged, TPLayout(1), TP_COMBOS[1], BATCH, arch)[0]
            spread, _, _ = tp_against(other, want, "tp 1 qship/cuda (the bf16 spread)")
        cfg_e, staged = pp.pad_experts(cfg, staged, e_pad)
        mtp, staged = tp_shard(cfg_e, pp.build_plan(cfg_e, N_STAGES, seq, base), staged,
                               layout)
        check(mtp.moe_ep and mtp.shared_moe and mtp.attn and mtp.kv_div == 8,
              f"{path}: {mtp}")
        if dtype == "bfloat16":
            got = tp_main_path(results, path, lambda: tp_serve(
                cfg_e, staged, layout, TP_COMBOS[0], BATCH, arch),
                kernels=ATTN_KERNELS[:2])[0]
        (got2, _), picked8 = recorded(
            lambda: tp_serve(cfg_e, staged, layout, TP_COMBOS[0], BATCH, arch))
        if dtype == "bfloat16":
            check(np.array_equal(got, got2), f"{path}: two EP runs differ")
        n = sum(int((a != b).sum()) for a, b in zip(picked8, picked1))
        total = sum(a.numel() for a in picked1)
        check(len(picked8) == len(picked1) and all(int(a.max()) < cfg.moe.num_experts
                                                   for a in picked8),
              f"{path}: a padded expert was routed, or the routing calls differ")
        log(f"    router choices differing from tp 1: {n} of {total} (token, slot)")
        err, same, bad = tp_against(got2, want, "tp 1", spread)
        if dtype == "float32" and (err >= FP32_LOGIT_TOL[arch] or same != BATCH):
            failures.append(f"{path} fp32: err {err}, argmax equal {same}")
        if dtype == "bfloat16" and bad:
            failures.append(f"{path} bf16: held argmax differ for {bad}")
        TP_NUMBERS[f"{path} {dtype}"] = dict(err=err, router_flips=n,
                                                              router_choices=total)
        del staged
        torch.cuda.empty_cache()
    log(f"  {path} peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated)")


def tp_phase(results: dict) -> None:
    """The manual TP lowering's three runs (see TP_COMBOS' comment), the
    card's name and power limit beside their numbers; fails if any check
    of the three failed."""
    log(f"[tp] {card_line()}")
    failures: list = []
    for fn in (tp_dense, tp_kv_split, tp_expert_parallel):
        t0 = time.perf_counter()
        fn(results, failures)
        log(f"[tp] {fn.__name__} {time.perf_counter() - t0:.1f} s")
    log(f"[tp] numbers {json.dumps(TP_NUMBERS)}")
    check(not failures, "; ".join(failures))


# ------------------------------------------------------------------ prefix

PREFIX_K = 6               # shared chunks: min(p2, M - 1) at N = M = 8
PREFIX_REQUESTS = 6
PREFIX_COMBOS = (("qship", "cuda", "auto"), ("fetch", "paged", "auto"),
                 ("qship", "cuda", "int8"))
PREFIX_WITNESS_RATIO = 10.0   # the unseeded garbage run against the bf16 spread


def prefix_phase(results: dict) -> None:
    """Cross-request prefix KV reuse on qwen3-8b at full width and depth
    (36 layers), bf16, the serve geometry (N = M = 8, C = 512, S = 4096,
    p2 = 6, so k <= 6: 3072 shared tokens), random weights from seed 0.

    - Pipeline leg, for qship/``cuda``, fetch/``paged`` and qship/``cuda``
      on int8 pages: ``prefill_pipeline`` on 2 requests, once plain and
      once with ``return_kv=True`` (the logits of the two must be
      bit-identical: two unseeded runs); then the same requests with the
      first k·C tokens replaced by a garbage token, ``prefix_chunks = k``
      and that pool as the seed, every K1-K3 launch held against its plain
      version (``shadowed``): the logits must be bit-identical to the
      unseeded run's, the ``prefix_hit`` ledger bytes equal to
      ``prefix_saved_model``, and the seed unchanged. The witness: the same
      garbage with ``prefix_chunks = 0`` must move the logits by more than
      PREFIX_WITNESS_RATIO x the bf16 spread (the p32 witness backend
      against the kernels on the unseeded requests, as in ``serve_model``).
    - Engine leg: ``ContinuousEngine`` + ``TorchExecutor`` (qship/``cuda``,
      ``max_batch`` 2) on PREFIX_REQUESTS requests sharing their first k
      chunks, ``prefix_cache`` "off" and "on": the first wave cold and every
      later one seeded with k; each request's logits bit-identical between
      off and on; ``prefix_hits`` >= 4 and equal to the analytic executor's
      scheduler on the same stream. Prints the untraced wave walls and the
      seed / snapshot copy seconds and GB/s.
    - Cold tier: a ``HostOffloadStager`` round trip of one stage's pool
      (every page, k and v), byte-equal, with the measured D2H / H2D rates
      beside a plain pinned-memory copy of the same bytes.

    The K1-K3 launches of the pipeline and engine legs go into the kernels
    line under "prefix"."""
    import numpy as np
    import torch
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.core import attention
    from repro_torch.core import costmodel as cm
    from repro_torch.core import pipeline as pp
    from repro_torch.core.staging import init_staged
    from repro_torch.kernels import ops
    from repro_torch.kvstore.pages import POOL_FIELDS as fields
    from repro_torch.kvstore.pages import PagedPool
    from repro_torch.kvstore.tiers import HostOffloadStager
    from repro_torch.launch.serve import make_requests
    from repro_torch.obs.telemetry import prefix_saved_model
    from repro_torch.runtime.engine import (ContinuousEngine, EngineConfig,
                                            SimExecutor, TorchExecutor)

    arch, k = "qwen3-8b", PREFIX_K
    seq, n, m = N_CHUNKS * CHUNK, N_STAGES, N_CHUNKS
    cfg = get_config(arch)

    def run_cfg(remote, pool, kv, attn="cuda"):
        return RunConfig(num_chunks=m, num_stages=n, remote_attn=remote,
                         attn_backend=attn, pool_backend=pool, kv_dtype=kv)

    plan0 = pp.build_plan(cfg, n, seq, run_cfg("qship", "cuda", "auto"))
    check(plan0.p2 == k and min(plan0.p2, m - 1) == k, f"p2 {plan0.p2}, expected {k}")
    staged = init_staged(cfg, plan0, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    toks = np.stack([r.tokens for r in make_requests(BATCH, seq, cfg.vocab_size, seed=0)])
    garb = toks.copy()
    garb[:, :k * CHUNK] = 7
    log(f"[prefix] {arch} bf16, {cfg.num_layers} layers, N={n} M={m} C={CHUNK} "
        f"p2={plan0.p2}: k = {k} ({k * CHUNK} shared tokens), {BATCH} requests a wave")

    def call(plan, tk, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pp.prefill_pipeline(cfg, staged, tk, plan, device="cuda", **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def frac(got, want) -> float:
        return float((got - want).abs().max() / want.abs().max())

    def pool_gb(pool) -> float:
        return sum(x.numel() * x.element_size() for x in (getattr(pool, f) for f in fields)
                   if x is not None) / 1e9

    # the bf16 spread: the p32 witness backend against the kernels
    with swapped(attention, "_BACKENDS", dict(attention._BACKENDS, torch=p32_witness())):
        wit, _ = call(pp.build_plan(cfg, n, seq, run_cfg("qship", "torch", "auto", "torch")),
                      toks)
    ops.reset_launches()
    failures = []
    spread = None
    last_kv = first_kv = None
    for remote, pool, kv in PREFIX_COMBOS:
        name = f"{remote}/{pool}/{kv}"
        plan = pp.build_plan(cfg, n, seq, run_cfg(remote, pool, kv))
        base0, t_plain = call(plan, toks)
        (base, kvp), t_kv = call(plan, toks, return_kv=True)
        if spread is None:
            spread = frac(base, wit)
            log(f"  bf16 spread (p32 witness vs the kernels, unseeded): {spread:.3e} "
                "of max|logit|")
        seed = PagedPool(*(None if getattr(kvp, f) is None else getattr(kvp, f).clone()
                           for f in fields))
        worst = [0.0]
        with contextlib.ExitStack() as stack:
            for kind in ATTN_KERNELS:
                stack.enter_context(swapped(ops, kind, shadowed(getattr(ops, kind), kind,
                                                               worst)))
            (seeded, led), t_seed = call(plan, garb, prefix_chunks=k, prefix_pool=kvp,
                                         return_ledger=True)
        unseeded_garb, t_garb = call(plan, garb, prefix_chunks=0, prefix_pool=kvp)
        model = prefix_saved_model(plan, plan.layers_per_stage, BATCH, CHUNK,
                                   cfg.num_kv_heads, cfg.resolved_head_dim, k)
        same_runs = torch.equal(base0, base)
        bit = torch.equal(seeded, base)
        kept = all(getattr(seed, f) is None or torch.equal(getattr(seed, f), getattr(kvp, f))
                   for f in fields)
        moved = frac(unseeded_garb, base)
        ratio = moved / max(spread, 1e-30)
        log(f"  {name}: two unseeded runs bit-identical {same_runs}; seeded (garbage "
            f"hit region, k={k}) bit-identical {bit}, max abs diff "
            f"{float((seeded - base).abs().max()):.3e}; every K1-K3 launch vs its plain "
            f"version: worst {worst[0]:.3e} of its tolerance; prefix_hit "
            f"{led['prefix_hit']:.0f} B, model {model['ledger_bytes']:.0f} B; seed "
            f"unchanged {kept}; witness (garbage, k=0) moves the logits {moved:.3e} of "
            f"max|logit| = {ratio:.1f}x the bf16 spread")
        log(f"    walls s: plain {t_plain:.4f}, return_kv {t_kv:.4f}, seeded (shadowed) "
            f"{t_seed:.4f}, witness {t_garb:.4f}; pool {pool_gb(kvp):.3f} GB")
        if not (same_runs and bit and kept and worst[0] <= 1.0
                and led["prefix_hit"] == model["ledger_bytes"] > 0
                and ratio > PREFIX_WITNESS_RATIO):
            failures.append(f"prefix {name}: unseeded runs equal {same_runs}, seeded "
                            f"bit-identical {bit}, seed kept {kept}, per-launch worst "
                            f"{worst[0]}, prefix_hit {led['prefix_hit']} vs "
                            f"{model['ledger_bytes']}, witness {ratio}x the spread")
        last_kv = (plan, kvp)
        if first_kv is None:
            first_kv = kvp
        del seed, seeded, base0, base, unseeded_garb
    del wit

    # ---- engine leg: ContinuousEngine + TorchExecutor, off and on
    run = run_cfg("qship", "cuda", "auto")
    reqs = lambda: make_requests(PREFIX_REQUESTS, seq, cfg.vocab_size, seed=0,
                                 shared_prefix=k * CHUNK)

    def engine(mode, executor):
        ec = EngineConfig(model=cfg, num_stages=n, tp=1, num_chunks=m, max_batch=BATCH,
                          buckets=(seq,), partition="uniform", prefix_cache=mode)
        eng = ContinuousEngine(ec, executor)
        for r in reqs():
            eng.submit(r)
        eng.run_until_drained()
        return eng

    served = {}
    for mode in ("off", "on"):
        ex = TorchExecutor(cfg, staged, run, device="cuda")
        eng = engine(mode, ex)
        check(len(eng.done) == PREFIX_REQUESTS, f"prefix engine {mode}: {len(eng.done)} done")
        served[mode] = (eng, ex, {r.rid: r.result for r in eng.done})
    eng, ex, on = served["on"]
    off = served["off"][2]
    ks = [w["prefix_chunks"] for w in ex.waves]
    same = [rid for rid in on if np.array_equal(on[rid], off[rid])]
    stats = eng.prefix_stats()
    sim = engine("on", SimExecutor(cfg, cm.TPU_V5E)).prefix_stats()
    gbs = lambda b, s: b / s / 1e9 if s else float("nan")
    log(f"  engine (ContinuousEngine + TorchExecutor, qship/cuda, {PREFIX_REQUESTS} "
        f"requests sharing {k} chunks, max_batch {BATCH}): seeded k per wave {ks}; logits "
        f"off vs on bit-identical for {len(same)}/{len(on)} requests; prefix_hits "
        f"{stats['prefix_hits']} (the analytic executor's scheduler: "
        f"{sim['prefix_hits']}); stats {stats}")
    log(f"    untraced wave walls s, off {[round(w['dur'], 4) for w in served['off'][1].waves]}"
        f", on {[round(w['dur'], 4) for w in ex.waves]}; card: {card_clocks()}")
    for i, w in enumerate(ex.waves):
        log(f"    on wave {i}: seed H2D {w.get('seed_h2d_s', 0.0):.4f} s for "
            f"{w.get('seed_bytes', 0.0) / 1e9:.3f} GB "
            f"({gbs(w.get('seed_bytes', 0.0), w.get('seed_h2d_s', 0.0)):.2f} GB/s, "
            f"includes the stack on the card); snapshot D2H {w['snap_d2h_s']:.4f} s for "
            f"{w['snap_bytes'] / 1e9:.3f} GB ({gbs(w['snap_bytes'], w['snap_d2h_s']):.2f} "
            "GB/s, includes the pinned allocation)")
    # the executor's snapshot again, once its first pinned blocks are freed:
    # the rate once the seed cache is full and evicted snapshots recycle
    snap_bytes = 0.0
    for rep in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        snaps = [ex._snapshot(first_kv, i) for i in range(BATCH)]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        snap_bytes = sum(x.numel() * x.element_size() for e in snaps for x in e.values()
                         if x is not None)
        log(f"    snapshot of a wave's {BATCH} requests again (#{rep}; pinned blocks "
            f"recycled from #1 on): {dt:.4f} s for {snap_bytes / 1e9:.3f} GB "
            f"({gbs(snap_bytes, dt):.2f} GB/s)")
        del snaps
    if not (ks == [0] + [k] * (len(ks) - 1) and len(same) == len(on)
            and stats["prefix_hits"] >= 4 and stats["prefix_hits"] == sim["prefix_hits"]):
        failures.append(f"prefix engine: k per wave {ks}, bit-identical {len(same)}/"
                        f"{len(on)}, hits {stats['prefix_hits']} (sim {sim['prefix_hits']})")
    launches = dict(ops.LAUNCHES)
    log(f"  launches on the prefix path (pipeline and engine legs): {launches}")
    for name in ATTN_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched on the prefix path")
        results[name].setdefault("launches_by_path", {})["prefix"] = launches[name]
    del served, eng, ex

    # ---- cold tier: one stage's pool to pinned host memory and back
    plan, kvp = last_kv
    stage = [getattr(kvp, f)[0] for f in fields if getattr(kvp, f) is not None]
    want = [x.clone() for x in stage]
    nbytes_ = sum(x.numel() * x.element_size() for x in stage)
    stager = HostOffloadStager(device="cuda")
    ids = list(range(stage[0].shape[0]))
    trips = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, x in enumerate(stage):
            stager.offload(f"pool{i}", x, ids)
        t1 = time.perf_counter()
        zeroed = all(int(torch.count_nonzero(x.view(torch.uint8) if x.element_size() == 1
                                             else x)) == 0 for x in stage)
        t2 = time.perf_counter()
        for i, x in enumerate(stage):
            stager.restore(f"pool{i}", x)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        trips.append((t1 - t0, t3 - t2, zeroed))
    equal = all(torch.equal(x.view(torch.uint8), w.view(torch.uint8))
                for x, w in zip(stage, want))
    dev = torch.empty(nbytes_, dtype=torch.uint8, device="cuda")
    host = torch.empty(nbytes_, dtype=torch.uint8, pin_memory=True)
    d2h = time_ms(lambda: host.copy_(dev, non_blocking=True), iters=5, warmup=1)
    h2d = time_ms(lambda: dev.copy_(host, non_blocking=True), iters=5, warmup=1)
    log(f"  cold tier: HostOffloadStager round trip of stage 0's pool ({plan.codec.name}, "
        f"{len(ids)} pages x {len(stage)} tensors, {nbytes_ / 1e9:.4f} GB): byte-equal "
        f"{equal}; offload (gather + D2H + zero) / restore (H2D + scatter) GB/s "
        + ", ".join(f"{gbs(nbytes_, a):.2f} / {gbs(nbytes_, b):.2f}" for a, b, _ in trips)
        + f"; zeroed between {all(z for _, _, z in trips)}; plain pinned copy of the same "
        f"bytes: D2H {gbs(nbytes_, d2h / 1e3):.2f} GB/s, H2D {gbs(nbytes_, h2d / 1e3):.2f} GB/s")
    if not (equal and all(z for _, _, z in trips)):
        failures.append(f"cold tier: byte-equal {equal}, zeroed {[z for _, _, z in trips]}")
    del staged, last_kv, first_kv, kvp, stage, want, dev, host, stager
    torch.cuda.empty_cache()
    check(not failures, "; ".join(failures))


# ------------------------------------------------------------------ decode

# one entry per model decoded: ``k5``, its K5 launches a bf16 decode step,
# one per attention layer (qwen3-8b 36 layers, zamba2-7b 13 applications of
# the shared block, mamba2-130m none, qwen3-14b 40 at GQA group 5,
# qwen2-moe-a2.7b 24 at G 1, whisper-small 12 self- and 12
# cross-attentions); as in SERVE_MODELS, ``bf16_layers`` and
# ``fp32_layers`` where a bridge is cut (``depth``): qwen3-14b's 40 fp32
# layers are ~59 GB, qwen2-moe-a2.7b's fp32 bridge takes its serve's 8
# layers; the K5 shapes of granite-3-2b (D 64, G 4), granite-moe-3b-a800m
# (D 64, G 3), stablelm-3b (D 80, G 1), llava-next-34b (D 128, G 7) and
# the paper's four (G 8, 12, 16 over 4 kv heads, 16 over 8) are held per
# launch, which depth does not change, at 8 layers (the paper's four:
# their serve's cut; in fp32 qwen3-235b's 128 experts are ~10 GB a layer
# and llama3-405b's d 16384 ~13 GB, so those two take 2); ``front``: the
# prompt starts with the model's stub frontend embeddings (llava-next-34b's
# 2880 patches in front of the tokens, whisper-small's 1500 frames into its
# encoder); ``prompt``: the prompt's tokens (whisper-small: its published
# 448-token context, DEC_STEPS of it decoded); ``logit_faults`` False:
# the planted K5 faults need break only the per-launch check in fp32
# (granite-3-2b's logits hardly see attention, as in the serve phase: the
# dropped key moves them ~1e-4 of max|logit|)
CUT = dict(bf16_layers=N_STAGES, fp32_layers=N_STAGES)
DECODE_MODELS = {"qwen3-8b": dict(k5=36), "zamba2-7b": dict(k5=13),
                 "mamba2-130m": dict(k5=0), "qwen3-14b": dict(k5=40, fp32_layers=N_STAGES),
                 "qwen2-moe-a2.7b": dict(k5=24, fp32_layers=N_STAGES),
                 "granite-3-2b": dict(k5=N_STAGES, logit_faults=False, **CUT),
                 "granite-moe-3b-a800m": dict(k5=N_STAGES, **CUT),
                 "stablelm-3b": dict(k5=N_STAGES, **CUT),
                 "llava-next-34b": dict(k5=N_STAGES, front=True, **CUT),
                 "llama3-70b": dict(k5=N_STAGES, **CUT),
                 "mistral-123b": dict(k5=N_STAGES, **CUT),
                 "qwen3-235b": dict(k5=N_STAGES, bf16_layers=N_STAGES, fp32_layers=2),
                 "llama3-405b": dict(k5=N_STAGES, bf16_layers=N_STAGES, fp32_layers=2),
                 "whisper-small": dict(k5=24, front=True, prompt=448 - 8)}
DEC_BATCH, DEC_PROMPT, DEC_PAD, DEC_STEPS = 2, 512, 8, 8
# fractions of max|logit|: fp32 decode against forward on the longer
# sequence (the fp32 serve limit); bf16 decode against bf16 forward on the
# longer sequence and against the same decode with K5's plain version (the
# bf16 serve limit)
DEC_FP32_TOL, DEC_BF16_TOL = 1e-3, 0.1
# long-context decode: 4 rows at ragged positions between 8k and 32k - 16 in
# a 32768-token cache, 16 steps; per model its depth (``depth``: zamba2-7b
# keeps 7 groups and its tail, so 7 shared-block applications) and K5
# launches a step
LONG_CAP, LONG_STEPS = 32768, 16
LONG_POS = (8192, 15001, 24577, LONG_CAP - LONG_STEPS)
LONG_DECODE = {"qwen3-8b": dict(layers=N_STAGES, k5=N_STAGES),
               "zamba2-7b": dict(layers=N_STAGES, k5=N_STAGES - 1),
               "qwen3-235b": dict(layers=N_STAGES, k5=N_STAGES)}


OBS_POISON_STAGE = 3       # the stage whose weights the health check sets to NaN
OBS_TAGS = ("chunk_attention", "pool_attention")   # the qship/cuda path's kernels


def activities_by_call(*fns) -> tuple:
    """Device activities (kernels, copies, sets) that torch.profiler sees
    in one call of each of ``fns``, by (category, name), from one session.

    A session can lose device activities at its edges: after the earlier
    phases, a session opened for one pipeline call lost 62 of that call's
    first activities (the token copy, the pools' fills) while the session
    before it lost none, and a session can also lose its last activities;
    idle host time at the window's start did not bring them back. So the
    session runs ``fns[0]`` once more first, as a primer, and ``fns[-1]``
    once more last, as a tail, which take any such loss, and ends the
    primer and every counted call with a marker kernel
    (``torch.cuda._sleep``): a call's activities are those between its
    marker and the one before. Returns the primer's and the tail's
    counts, then one Counter a call."""
    import collections
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in (fns[0],) + fns:
            fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        fns[-1]()
        torch.cuda.synchronize()
    acts = [(t0, cat, name) for t0, _, name, cat in device_spans(prof)]
    marks = [i for i, (_, _, name) in enumerate(acts) if "spin_kernel" in name]
    check(len(marks) == len(fns) + 1,
          f"obs: {len(marks)} marker kernels in the trace, not {len(fns) + 1}")
    return (marks[0], len(acts) - 1 - marks[-1],
            [collections.Counter((cat, name) for _, cat, name in acts[lo + 1:hi])
             for lo, hi in zip(marks, marks[1:])])


def obs_phase(results: dict) -> None:
    """The device half of observability on qwen3-8b at full width and depth
    (36 layers), bf16, the serve geometry (N = M = 8, C = 512, B = 2),
    qship/``cuda``, random weights from seed 0:

    - telemetry on against off (``prefill_pipeline(return_telemetry=
      True)``): bit-identical logits, equal ``ops.LAUNCHES``, equal device
      activities by (category, name) in one torch.profiler session over a
      call of each (``activities_by_call``); the
      occupancy equal to ``analytic_occupancy`` and its peak to the plan's
      ``num_slots``; events x ``per_event_wire_bytes`` equal to the ledger;
      the stages' logical ``launches`` equal to N x the K1 + K2 launches;
      the untraced wave wall time (``TorchExecutor``) with telemetry off,
      on, on, off;
    - the MBKR imbalance: each stage's peak ``kv_bytes`` under MBKR against
      terapipe (the terapipe peak M chunks, MBKR's p2 = 6);
    - measured spans (``collect_measured``, CUDA events): every tick's span
      positive and their sum within 0.9-1.01x of the wave's untraced wall
      time; ``measure_prefill``'s loop total within 10 % of that sum and
      the per-tag totals of its ``timed_launches`` frame covering that loop
      (0.9-1.01x), printed beside ``wave_split``'s K1 / K2 device time;
    - health: armed on the healthy weights, no alert and bit-identical
      logits, the wave time disarmed, armed, armed, disarmed; then stage
      OBS_POISON_STAGE's weights set to NaN: ``nonfinite`` alerts whose
      first (stage, tick) is that stage's first active tick, none before;
    - calibration: the cost model fitted from ``hgx-b200`` to the last
      measured wave's spans (an effective "8 stages on one H100" profile,
      written to ``build/obs_calibrated.json``): its L2 residual no more
      than the nominal one (1.5x where a rate was clamped), the span MAPE
      nominal -> calibrated, and ``lbcp.plan_partition``'s chunks for S =
      4096, N = 8 under both profiles;
    - the serve CLI once (``launch.serve.main``, in this process, its own
      weights): torch executor, continuous scheduler, ``--trace-out
      --metrics-out --health --calibrate``, every output under ``build/``:
      the trace loads as Chrome JSON with its engine, measured and health
      rows and ``kv_resident_bytes`` tracks, the metrics parse.

    The K1 / K2 launches of the telemetry-on pipeline call and of the serve
    run go into the kernels line under "obs" and "obs serve"."""
    import numpy as np
    import torch
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.core import costmodel as cm
    from repro_torch.core import lbcp, mbkr
    from repro_torch.core import pipeline as pp
    from repro_torch.core.staging import init_staged
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch.serve import make_requests
    from repro_torch.obs import calibrate as cal
    from repro_torch.obs import telemetry as obs_t
    from repro_torch.obs.health import HealthMonitor
    from repro_torch.obs.profile import measure_prefill
    from repro_torch.runtime.engine import EngineConfig, PrefillEngine, TorchExecutor

    arch = "qwen3-8b"
    seq, n, m = N_CHUNKS * CHUNK, N_STAGES, N_CHUNKS
    cfg = get_config(arch)
    run = RunConfig(num_chunks=m, num_stages=n, remote_attn="qship",
                    attn_backend="cuda", pool_backend="cuda")
    plan = pp.build_plan(cfg, n, seq, run)
    staged = init_staged(cfg, plan, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    toks = np.stack([r.tokens for r in make_requests(BATCH, seq, cfg.vocab_size, seed=0)])
    log(f"[obs] {arch} bf16, {cfg.num_layers} layers, N={n} M={m} C={CHUNK} "
        f"p2={plan.p2} slots={plan.num_slots}, {BATCH} requests a wave, qship/cuda")

    def call(p=plan, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pp.prefill_pipeline(cfg, staged, toks, p, device="cuda", **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def waves(n_req: int, **obs) -> list:
        """``n_req`` requests through PrefillEngine + TorchExecutor in waves of
        BATCH with ``configure_obs(**obs)``; returns the executor's waves."""
        ex = TorchExecutor(cfg, staged, run, device="cuda")
        eng = PrefillEngine(EngineConfig(model=cfg, num_stages=n, tp=1, num_chunks=m,
                                         max_batch=BATCH, buckets=(seq,),
                                         partition="uniform"), ex)
        eng.configure_obs(**obs)
        for r in make_requests(n_req, seq, cfg.vocab_size, seed=0):
            eng.submit(r)
        eng.run_until_drained()
        check(len(ex.waves) == n_req // BATCH, f"obs: {len(ex.waves)} waves")
        return ex.waves

    # ---- telemetry on against off
    call()                                                   # warm-up
    ops.reset_launches()
    (base, led0), _ = call(return_ledger=True)
    off_launches = dict(ops.LAUNCHES)
    ops.reset_launches()
    (logits, led, tel), _ = call(return_ledger=True, return_telemetry=True)
    on_launches = dict(ops.LAUNCHES)
    check(torch.equal(logits, base), "obs: telemetry changed the logits")
    check(on_launches == off_launches, f"obs: launches {on_launches} vs {off_launches}")
    check(led == led0, "obs: telemetry changed the ledger")
    for name in OBS_TAGS:
        check(on_launches[name] > 0, f"obs: {name} never launched")
        results[name].setdefault("launches_by_path", {})["obs"] = on_launches[name]
    k_primer, k_tail, (acts_off, acts_on) = activities_by_call(
        lambda: call(), lambda: call(return_telemetry=True))
    k_off, k_on = sum(acts_off.values()), sum(acts_on.values())
    differ = {key: acts_on[key] - acts_off[key] for key in set(acts_on) | set(acts_off)
              if acts_on[key] != acts_off[key]}
    check(not differ, f"obs: {k_on} device activities with telemetry, {k_off} without; "
                      f"on - off by (category, name): {sorted(differ.items())[:6]}")
    prof = obs_t.TelemetryProfile.from_run(tel)
    own, hosted = obs_t.analytic_occupancy(m, n, plan.p2)
    check(np.array_equal(prof.data["own_chunks"], own)
          and np.array_equal(prof.data["hosted_chunks"], hosted),
          "obs: occupancy differs from analytic_occupancy")
    check(prof.peak() == plan.num_slots, f"obs: peak {prof.peak()} vs {plan.num_slots}")
    pe = obs_t.per_event_wire_bytes(plan, cfg, BATCH)
    tot = prof.totals()
    wire = {"spill": (tot["spill_events"] * pe["spill"], led["spill"]),
            "qship": (tot["qship_events"] * pe["qship"], led["qship_q"] + led["qship_state"])}
    for key, (got, want) in wire.items():
        check(want > 0 and abs(got - want) <= 1e-9 * want,
              f"obs: {key} events x per-event {got} vs ledger {want}")
    logical = tel["launches"][:, -1].sum()
    check(logical == n * sum(on_launches[t] for t in OBS_TAGS),
          f"obs: logical launches {logical} vs N x {on_launches}")
    times = {}
    for flag in (False, True, True, False):
        times.setdefault(flag, []).extend(w["dur"] for w in waves(BATCH, telemetry=flag))
    log(f"  telemetry on vs off: logits bit-identical, LAUNCHES equal {on_launches}, "
        f"device activities {k_on} = {k_off} (the session's primer / tail calls "
        f"{k_primer} / {k_tail}); occupancy = analytic, peak {prof.peak():.0f} = "
        f"num_slots; spill {wire['spill'][1]:.0f} B, qship "
        f"{wire['qship'][1]:.0f} B = events x per-event; logical launches {logical:.0f} "
        f"= {n} x {sum(on_launches[t] for t in OBS_TAGS)}")
    log(f"  untraced wave s, telemetry off {times[False][0]:.4f} / {times[False][1]:.4f}, "
        f"on {times[True][0]:.4f} / {times[True][1]:.4f} "
        f"({(np.mean(times[True]) / np.mean(times[False]) - 1) * 100:+.2f} %)")

    # ---- the MBKR imbalance on the card
    plan_t = pp.build_plan(cfg, n, seq, RunConfig(num_chunks=m, num_stages=n, mbkr=False,
                                                   attn_backend="cuda", pool_backend="cuda"),
                           mode="terapipe")
    (_, tel_t), _ = call(plan_t, return_telemetry=True)
    prof_t = obs_t.TelemetryProfile.from_run(tel_t)
    cb = obs_t.chunk_stored_bytes(plan, plan.layers_per_stage, BATCH, CHUNK,
                                  cfg.num_kv_heads, cfg.resolved_head_dim)
    pk, pk_t = prof.per_stage_peak("kv_bytes"), prof_t.per_stage_peak("kv_bytes")
    check(prof_t.peak() == m and prof.peak() == plan.p2 == 6,
          f"obs: peaks terapipe {prof_t.peak()}, MBKR {prof.peak()} (p2 {plan.p2})")
    check(np.allclose(pk, plan.p2 * cb) and np.allclose(pk_t, m * cb),
          "obs: per-stage peak kv_bytes off the chunk price")
    log(f"  MBKR vs terapipe, each stage's peak kv_bytes GB (chunk {cb / 1e9:.4f} GB): "
        f"MBKR {' '.join(f'{v / 1e9:.4f}' for v in pk)}; terapipe "
        f"{' '.join(f'{v / 1e9:.4f}' for v in pk_t)}; skew {prof.skew():.3f} / "
        f"{prof_t.skew():.3f}")

    # ---- measured spans
    meas_waves = waves(2 * BATCH, measured=True)
    w = meas_waves[-1]
    tick_s = w["measured"].max(axis=0)
    span_sum = float(tick_s.sum())
    check(w["measured"].shape == (n, m + n - 1) and bool((tick_s > 0).all()),
          f"obs: tick spans {tick_s} (every tick must have a positive span)")
    check(0.9 * w["dur"] <= span_sum <= 1.01 * w["dur"],
          f"obs: tick spans {span_sum} s against the wave's {w['dur']} s")
    log(f"  tick spans (CUDA events) sum {span_sum:.4f} s against the wave's untraced "
        f"wall {w['dur']:.4f} s ({span_sum / w['dur'] * 100:.1f} %); first wave "
        f"{float(meas_waves[0]['measured'].max(axis=0).sum()):.4f} / "
        f"{meas_waves[0]['dur']:.4f} s; per tick s "
        f"{' '.join(f'{v:.4f}' for v in w['measured'].max(axis=0))}")
    logits_k, meas_k = measure_prefill(cfg, staged, toks, plan, device="cuda", warmup=0,
                                       timed_kernels=True)
    check(torch.equal(logits_k, base), "obs: the timed frame changed the logits")
    # the same call's loop timed by measure_prefill agrees with the engine's
    # tick spans, and the timed frame's tags cover that loop
    tag_sum = sum(meas_k.kernel_s.values())
    check(0.9 * span_sum <= meas_k.total() <= 1.1 * span_sum
          and 0.9 * meas_k.total() <= tag_sum <= 1.01 * meas_k.total(),
          f"obs: measure_prefill total {meas_k.total()} s, tags {tag_sum} s, "
          f"against the tick spans' {span_sum} s")
    split = wave_split(arch, staged=staged)["split"]
    log(f"  timed frame per tag s (each gap charged to the next launch's tag): "
        f"{ {k: round(v, 4) for k, v in meas_k.kernel_s.items()} }, sum "
        f"{sum(meas_k.kernel_s.values()):.4f} of the loop's {meas_k.total():.4f}; "
        f"wave_split's device time K1 {split.get('K1 chunk_attention', 0.0):.4f}, "
        f"K2 {split.get('K2 pool_attention', 0.0):.4f}")

    # ---- health
    mon = HealthMonitor()
    armed, _ = call(health=mon)
    check(torch.equal(armed, base) and mon.alerts == [],
          f"obs: armed health on healthy weights: {mon.summary()}")
    cost = {}
    for flag in (False, True, True, False):
        kw = {"health": HealthMonitor()} if flag else {}
        cost.setdefault(flag, []).append(call(**kw)[1])
    # one tick's count alone (CUDA events), beside the four-pass isfinite form
    x_tick = torch.randn(n, BATCH, CHUNK, cfg.d_model, device="cuda", dtype=torch.bfloat16)
    count_ms = time_ms(lambda: pp.nonfinite_per_stage(x_tick))
    isfinite_ms = time_ms(lambda: torch.isfinite(x_tick).logical_not_().reshape(n, -1).sum(1))
    del x_tick
    lay = staged["stage_layers"]
    saved = {k: w_[OBS_POISON_STAGE].clone() for k, w_ in lay.items() if w_.is_floating_point()}
    for k in saved:
        lay[k][OBS_POISON_STAGE] = float("nan")
    bad = HealthMonitor()
    try:
        call(health=bad)
    finally:
        for k, v in saved.items():
            lay[k][OBS_POISON_STAGE] = v
    cells = sorted((a.tick, a.stage) for a in bad.alerts)
    check(bool(cells) and {a.kind for a in bad.alerts} == {"nonfinite"}
          and cells[0] == (OBS_POISON_STAGE, OBS_POISON_STAGE)
          and all(t >= OBS_POISON_STAGE for t, _ in cells),
          f"obs: poisoned stage {OBS_POISON_STAGE}: alerts at {cells[:4]}")
    log(f"  health: armed on healthy weights no alert, logits bit-identical; call s "
        f"disarmed {cost[False][0]:.4f} / {cost[False][1]:.4f}, armed {cost[True][0]:.4f} / "
        f"{cost[True][1]:.4f} ({(np.mean(cost[True]) - np.mean(cost[False])) * 1e3:+.2f} ms); "
        f"one tick's count {count_ms:.4f} ms (isfinite form {isfinite_ms:.4f}) x "
        f"{plan.num_ticks} ticks; "
        f"stage {OBS_POISON_STAGE} NaN: {len(cells)} nonfinite alerts, first (stage, tick) "
        f"({cells[0][1]}, {cells[0][0]}), stages {sorted({s for _, s in cells})}")

    # ---- calibration
    sm = cm.StageModel.build(cfg, n, 1)
    chunks = list(w["chunks"])
    mplan = mbkr.plan(m, n)
    fit = cal.fit_profile(sm, chunks, w["measured"], cm.GPU_HGX, mbkr_plan=mplan,
                          name="h100-8stages")
    x, y, _ = cal.design_matrix(sm, chunks, cm.GPU_HGX, w["measured"], mbkr_plan=mplan)
    r_cal = float(np.linalg.norm(fit.residual_s))
    r_nom = float(np.linalg.norm(y - x @ fit.theta_nominal))
    clamped = fit.theta == fit.theta_nominal
    check(r_cal <= r_nom * (1.5 if clamped.any() else 1 + 1e-9),
          f"obs: calibrated L2 residual {r_cal} vs nominal {r_nom} (clamped {clamped})")
    path = cal.save_profile(str(ROOT / "build" / "obs_calibrated.json"), fit.profile,
                            fit=fit, meta={"arch": arch, "seq": seq, "num_stages": n,
                                           "one_card": True, "card": card_line(),
                                           "source": "chip_smoke.obs_phase"})
    check(cal.load_profile(path)[0] == fit.profile, "obs: the profile JSON does not round-trip")
    nom_chunks = lbcp.plan_partition(cfg, seq, m, n, cm.GPU_HGX, sa_iters=60).chunks
    cal_chunks = lbcp.plan_partition(cfg, seq, m, n, path, sa_iters=60).chunks
    eff = cm.profile_to_dict(fit.profile)
    log(f"  calibration hgx-b200 -> {fit.profile.name} ({len(fit.rows)} spans): MAPE "
        f"{fit.mape_nominal:.4f} -> {fit.mape_calibrated:.4f}, L2 residual {r_nom:.4f} -> "
        f"{r_cal:.4f} s, clamped {clamped.tolist()}; effective gemm_eff "
        f"{eff['gemm_eff']:.4g} attn_eff {eff['attn_eff']:.4g} hbm_bw {eff['hbm_bw']:.4g} "
        f"link_bw {eff['link_bw']:.4g} (of {cm.GPU_HGX.flops:.3g} FLOP/s nominal) -> {path}")
    log(f"  plan_partition S={seq} N={n}: hgx-b200 {nom_chunks}, calibrated {cal_chunks}")

    # ---- the serve CLI, once
    del staged, lay, saved
    torch.cuda.empty_cache()
    out = ROOT / "build"
    argv = ["--executor", "torch", "--scheduler", "continuous", "--requests",
            str(2 * BATCH), "--max-batch", str(BATCH), "--seq", str(seq),
            "--num-chunks", str(m), "--num-stages", str(n), "--trace-out",
            str(out / "obs_serve_trace.json"), "--metrics-out",
            str(out / "obs_serve_metrics.prom"), "--health", "--calibrate",
            str(out / "obs_serve_cal.json")]
    log(f"  serve: python -m repro_torch.launch.serve {' '.join(argv)}")
    ops.reset_launches()
    rc = serve.main(argv)
    serve_launches = dict(ops.LAUNCHES)
    check(rc == 0, f"obs: serve returned {rc}")
    for name in OBS_TAGS:
        check(serve_launches[name] > 0, f"obs serve: {name} never launched")
        results[name]["launches_by_path"]["obs serve"] = serve_launches[name]
    evs = json.loads((out / "obs_serve_trace.json").read_text())["traceEvents"]
    rows = {e["pid"] for e in evs if e["ph"] == "M"}
    tracks = {e["name"] for e in evs if e["ph"] == "C"}
    check({"engine", "measured", "health"} <= rows and "kv_resident_bytes" in tracks,
          f"obs serve: trace rows {sorted(map(str, rows))}, tracks {sorted(tracks)}")
    prom = (out / "obs_serve_metrics.prom").read_text().splitlines()
    samples = [ln for ln in prom if ln and not ln.startswith("#")]
    try:
        values = {ln.split()[0]: float(ln.split()[1]) for ln in samples if len(ln.split()) == 2}
    except ValueError as e:
        raise SmokeFailure(f"obs serve: the metrics do not parse: {e}") from e
    check(bool(values) and len(values) == len(samples)
          and values.get("repro_completed") == 2 * BATCH,
          f"obs serve: metrics {len(values)} of {len(samples)} samples parse")
    blob = json.loads((out / "obs_serve_cal.json").read_text())
    check(blob["meta"]["one_card"] is True, "obs serve: the profile's meta")
    log(f"  serve: trace {len(evs)} events, rows {sorted(map(str, rows))}, counter tracks "
        f"{sorted(tracks)}; metrics {len(values)} samples; calibrated profile "
        f"{blob['profile']['name']} (MAPE {blob['fit']['mape_nominal']:.4f} -> "
        f"{blob['fit']['mape_calibrated']:.4f})")


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


@contextlib.contextmanager
def router_picks(on: bool, picks: list, rows: int):
    """Inside the block, where ``on``, appends each MoE router call's
    choices ([rows, tokens, k] uint8) to ``picks``."""
    import torch
    from repro_torch.models import layers as layers_mod
    route = layers_mod.moe_route

    def record(*args, **kw):
        weights, picked = route(*args, **kw)
        picks.append(picked.reshape(rows, -1, picked.shape[-1]).to(torch.uint8))
        return weights, picked
    with swapped(layers_mod, "moe_route", record if on else route):
        yield


@contextlib.contextmanager
def router_replay(picks: list):
    """Inside the block, the i-th MoE router call takes the i-th choices of
    ``picks`` (another run's, recorded by ``router_picks``) and weighs them
    by its own router logits (the softmax over the k chosen), so that two
    runs whose attention differs compare with the same experts."""
    import torch
    from repro_torch.models import layers as layers_mod
    calls = iter(picks)

    def replay(x, router, *, top_k, num_real=0):
        chosen = next(calls).reshape(*x.shape[:-1], top_k).long()
        vals = torch.matmul(x.float(), router.float()).gather(-1, chosen)
        u = torch.exp(vals - vals.amax(dim=-1, keepdim=True))
        return u / u.sum(dim=-1, keepdim=True), chosen
    with swapped(layers_mod, "moe_route", replay):
        yield


def decode_flips(steps: list, whole: list, n_steps: int) -> str:
    """How many (token, slot) router choices of a decode differ from a
    forward's over the same tokens: step t's call at MoE layer i against
    the forward's layer i at the step's position (the last ``n_steps``);
    nothing where neither recorded."""
    if not steps and not whole:
        return ""
    check(len(steps) == n_steps * len(whole), f"{len(steps)} decode router calls against "
          f"{len(whole)} forward layers x {n_steps} steps")
    n = sum(int((steps[t * len(whole) + i][:, 0] != w[:, w.shape[1] - n_steps + t]).sum())
            for t in range(n_steps) for i, w in enumerate(whole))
    return f"; router choices differing {n} of {sum(x.numel() for x in steps)} (token, slot)"


def decode_bridge(arch: str, dtype: str, results: dict) -> list:
    """The prefill->decode bridge of one model at full width and depth
    (``bf16_layers`` / ``fp32_layers`` deep where DECODE_MODELS sets them)
    (``tests/test_models.py::test_decode_continues_prefill`` at the card's
    size): B = 2 rows, a 512-token prompt through ``Model.forward(
    return_cache=True)``, the KV axis padded by 8, 8 ``Model.decode_step``s
    fed with seeded tokens.
    bf16, the decode main path: the launch counts are set to 0 just before
    the K5 run and read just after (exactly 8 x DECODE_MODELS' ``k5``); the logits are
    held within DEC_BF16_TOL of max|logit| against bf16 ``forward`` on the
    prompt and the fed tokens (this holds the bf16 Mamba2 decode) and, where
    the model has attention, against the same decode with
    ``ref.decode_attention_plain`` in K5's place.
    Models with attention also run the bf16 decode with every K5 launch
    held against its plain version (``shadowed``), within its
    tolerance (the planted faults' ratios there reported).
    fp32: every step's logits against ``forward`` on the prompt and the fed
    tokens at that position, within DEC_FP32_TOL of max|logit|; then each
    planted K5 fault (``decode_faults``) must break that limit and, with
    every K5 launch held against its plain version on its own inputs
    (``shadowed``), the per-launch check by 10x or more, where the real
    kernel stays within it; for whisper-small each fault also breaks the
    per-launch check of the cross-attention's launches (kv_len = F) alone.
    ``front`` models decode after their frontend embeddings (seeded, 0.02 x
    a standard normal). An MoE model's forward runs at a capacity that
    drops no token (a decode step's dispatch drops none either), so that
    the two see the same experts; the router choices that differ between
    the fp32 decode and forward are reported (a flipped choice near a tie
    is no kernel fault, and the limit holds regardless). Where
    ``BF16_LOGIT_TOL`` holds no limit for the model (router flips in
    bf16), the bf16 logits are reported and the per-launch check carries
    K5. Each dtype's median step time (the K5 run; fp32: the first run)
    and peak memory are printed. Returns the failures."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config, replace
    from repro_torch.kernels import ops, ref
    from repro_torch.models.api import build_model

    spec = DECODE_MODELS[arch]
    layers = spec.get("bf16_layers" if dtype == "bfloat16" else "fp32_layers")
    cfg = replace(depth(get_config(arch), layers), dtype=dtype)
    if cfg.moe is not None:     # every expert can take every token
        import dataclasses
        cfg = replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.real_experts / cfg.moe.top_k))
    model = build_model(cfg)
    per_step = spec["k5"]
    prompt = spec.get("prompt", DEC_PROMPT)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    if layers is not None:
        log(f"[decode] {arch} {dtype}: depth cut to {cfg.num_layers} layers, full width")
    toks = torch.randint(0, cfg.vocab_size, (DEC_BATCH, prompt + DEC_STEPS),
                         generator=gen, device="cuda")
    kw = {}
    if spec.get("front"):
        kw["embeds"] = (torch.randn((DEC_BATCH, cfg.frontend.num_embeds, cfg.d_model),
                                    generator=gen, device="cuda") * 0.02).to(params["embed"].dtype)
    _, prefill = model.forward(params, toks[:, :prompt], return_cache=True, **kw)
    if "k" in prefill:
        pad = (0, 0, 0, 0, 0, DEC_PAD)
        prefill = {**prefill, "k": F.pad(prefill["k"], pad), "v": F.pad(prefill["v"], pad)}
    torch.cuda.synchronize()
    log(f"[decode] {arch} {dtype}: weights + {prompt}-token prefill"
        + (f" after {cfg.frontend.num_embeds} frontend embeddings" if kw else "")
        + f" {time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    def fresh():
        return {k: v.clone() for k, v in prefill.items()}

    def run(cache):
        return decode_run(model, params, cache, toks[:, prompt:])

    failures = []
    name = f"{arch} {dtype} bridge"
    whole: list = []      # the forward's router choices (fp32 MoE)
    with router_picks(cfg.moe is not None and dtype == "float32", whole, DEC_BATCH):
        want = model.forward(params, toks, **kw)[:, -DEC_STEPS:].transpose(0, 1)

    def finish(walls):
        """Logs and records the step time and peak memory of this bridge."""
        step_ms = 1e3 * statistics.median(walls)
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"  {name}: step median {step_ms:.3f} ms, peak memory {peak:.2f} GiB")
        results.setdefault("decode_attention", {}).setdefault("bridges", {})[
            f"{arch} {dtype}"] = dict(layers=cfg.num_layers, step_ms=step_ms, peak_gib=peak)
    cross = prefill.get("xk")      # whisper-small's cross K/V: its K5 launches' own kind
    by_call = (lambda q, k, v, kv_len, **_: "cross" if cross is not None
               and k.shape[1] == cross.shape[2] else "self")

    def held(fn, worst: list, by: dict):
        """A run of the decode with every K5 launch (``fn``) held against
        its plain version."""
        with swapped(ops, "decode_attention",
                     shadowed(fn, "decode_attention", worst, by, by_call)):
            got, _ = run(fresh())
        return got
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
        held_logits = BF16_LOGIT_TOL[arch] is not None
        for what, ref_logits in refs.items():
            err = frac(got, ref_logits)
            log(f"  {name}: logits vs {what} {err:.3e} of max|logit| "
                + (f"(limit {DEC_BF16_TOL})" if held_logits else
                   "(reported: the router flips experts near ties in bf16)")
                + f", argmax equal "
                f"{int((got.argmax(-1) == ref_logits.argmax(-1)).sum())}/{got[..., 0].numel()}")
            if held_logits and not err <= DEC_BF16_TOL:
                failures.append(f"{name}: {err} of max|logit| against {what}")
        if per_step:
            runs = [("none (the kernel itself)", ops.decode_attention, False)] + \
                [(f, fn, True) for f, fn in decode_faults(ops.decode_attention).items()]
            for fault, fn, is_fault in runs:
                worst, by = [0.0], {}
                held(fn, worst, by)
                log(f"  {name}, every K5 launch vs its plain version, "
                    f"{'planted fault: ' + fault + ' (reported)' if is_fault else fault}: "
                    f"worst {worst[0]:.3e} of its tolerance "
                    f"{ {k: round(v, 4) for k, v in by.items()} }")
                results["decode_attention"].setdefault("planted", {})[
                    f"{arch} bf16 bridge: {fault}"] = dict(per_launch=worst[0], **by)
                if not is_fault and worst[0] > 1.0:
                    failures.append(f"{name}: K5 off its plain version by {worst[0]} "
                                    "of the tolerance")
        finish(walls)
        return failures

    steps: list = []
    with router_picks(cfg.moe is not None, steps, DEC_BATCH):
        got, walls = run(fresh())
    err = frac(got, want)
    log(f"  {name}: logits vs forward on {DEC_PROMPT + DEC_STEPS} tokens {err:.3e} of "
        f"max|logit| (limit {DEC_FP32_TOL}), per step "
        f"{[f'{frac(g, w):.2e}' for g, w in zip(got, want)]}, argmax equal "
        f"{int((got.argmax(-1) == want.argmax(-1)).sum())}/{got[..., 0].numel()}"
        + decode_flips(steps, whole, DEC_STEPS))
    if not err < DEC_FP32_TOL:
        failures.append(f"{name}: {err} of max|logit| against forward")
    finish(walls)
    if per_step == 0:
        return failures
    runs = [("none (the kernel itself)", ops.decode_attention, False)] + \
        [(f, fn, True) for f, fn in decode_faults(ops.decode_attention).items()]
    for fault, fn, is_fault in runs:
        worst, by = [0.0], {}
        got = held(fn, worst, by)
        err = frac(got, want)
        log(f"  planted fault: {fault}: logits {err:.3e} of max|logit|; every K5 launch "
            f"vs its plain version: worst {worst[0]:.3e} of its tolerance "
            f"{ {k: round(v, 4) for k, v in by.items()} }")
        results.setdefault("decode_attention", {}).setdefault("planted", {})[
            f"{arch} fp32 bridge: {fault}"] = dict(logits=err, per_launch=worst[0], **by)
        missed = err < DEC_FP32_TOL and spec.get("logit_faults", True)
        if is_fault and (missed or worst[0] < 10.0
                         or (cross is not None and by.get("cross", 0.0) <= 1.0)):
            failures.append(f"{name}: planted fault '{fault}' not caught "
                            f"(logits {err}, per launch {worst[0]}, {by})")
        if not is_fault and worst[0] > 1.0:
            failures.append(f"{name}: K5 off its plain version by {worst[0]} of the tolerance")
    return failures


def decode_long(arch: str, results: dict) -> list:
    """Long-context decode in bf16 at full width, ``LONG_DECODE``'s depth:
    4 rows at the ragged positions LONG_POS of a 32768-token cache whose
    K/V come from a seeded generator (SSM state zero), 16 steps. Every run
    starts from the same state: the k/v at and past each row's start
    position are rewritten before they are read, so rewinding ``pos`` (and
    zeroing the SSM state)
    restores it without a second copy of the cache. Runs: K5 (step times,
    launches exactly 16 x per step), its plain version in its place (step
    times; logits within DEC_BF16_TOL of K5's), K5 with every launch held
    against the plain version on its own inputs (within its tolerance),
    and the planted faults under the same per-launch check, which each must
    break by 10x or more (on an H100, "kv_len - 1" read 15.76x and 44.04x
    of the tolerance for qwen3-8b and zamba2-7b at full depth, at the whole
    output's max|ref|; now each (row, head)'s own, ``head_ratio``). For an
    MoE model the plain run takes the held K5 run's router choices
    (``router_replay``): unpinned, on an H100 680 of qwen3-235b's 4096
    (token, slot) choices flipped and the logits differed by 0.74 of
    max|logit|. Returns the failures."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.models.api import build_model

    spec = LONG_DECODE[arch]
    cfg = depth(get_config(arch), spec["layers"])
    model = build_model(cfg)
    per_step = spec["k5"]
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
    log(f"[decode] {arch} long context, {cfg.num_layers} layers: {len(LONG_POS)} rows at "
        f"{list(LONG_POS)} of {LONG_CAP}, {LONG_STEPS} steps; set-up "
        f"{time.perf_counter() - t0:.2f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")

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
    check(n == per_step * LONG_STEPS, f"{name}: {n} K5 launches, expected "
          f"{per_step * LONG_STEPS}")
    moe = cfg.moe is not None
    held: dict = {}
    picks: list = []      # the MoE router's choices of the held K5 run
    runs = [("none (the kernel itself)", ops.decode_attention, False)] + \
        [(f, fn, True) for f, fn in decode_faults(ops.decode_attention).items()]
    for fault, fn, is_fault in runs:
        worst = [0.0]
        with swapped(ops, "decode_attention", shadowed(fn, "decode_attention", worst)), \
                router_picks(moe and not is_fault, picks, len(LONG_POS)):
            decode_run(model, params, rewound(), toks)
        log(f"  {name}, planted fault: {fault}: every K5 launch vs its plain version: "
            f"worst {worst[0]:.3e} of its tolerance")
        held[fault] = worst[0]
        if is_fault and worst[0] < 10.0:
            failures.append(f"{name}: planted fault '{fault}' not caught "
                            f"(per launch {worst[0]})")
        if not is_fault and worst[0] > 1.0:
            failures.append(f"{name}: K5 off its plain version by {worst[0]} of the tolerance")
    # the plain version in K5's place; an MoE model's router takes the held
    # K5 run's choices (in bf16 it flips experts near ties under any change
    # of summation order), so that the logits differ by K5 alone
    with swapped(ops, "decode_attention", ref.decode_attention_plain), \
            (router_replay(picks) if moe else contextlib.nullcontext()):
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
        f"of max|logit| (limit {DEC_BF16_TOL}"
        + (f"; the plain run routed as the held K5 run, {len(picks)} router calls"
           if moe else "")
        + f"); {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB peak")
    results.setdefault("decode_attention", {}).setdefault("long_context", {})[arch] = dict(
        layers=cfg.num_layers, launches=n, step_ms=step_ms, plain_step_ms=plain_step_ms,
        k5_ms=k5_ms, k5_plain_ms=k5_plain_ms, k5_ms_per_step=per_step * k5_ms,
        logits_vs_plain=err, **held)
    if not err <= DEC_BF16_TOL:
        failures.append(f"{name}: logits {err} of max|logit| against the plain version")
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
    for arch in LONG_DECODE:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        failures += decode_long(arch, results)
        torch.cuda.empty_cache()
        log(f"[decode] {arch} long context {time.perf_counter() - t0:.1f} s")
    check(not failures, "; ".join(failures))


# -------------------------------------------------------------------- fleet

FLEET_ARCH, FLEET_REQUESTS, FLEET_RATE, FLEET_SLO_MS = "qwen3-8b", 8, 2.0, 4000.0
FLEET_DRAIN_REQUESTS = 6


def fleet_phase(results: dict) -> None:
    """The fleet (``repro_torch.fleet``, ``launch.options``) on qwen3-8b at
    full width and depth in bf16, S = 4096.

    Through the serve CLI (``launch.serve.main``, in this process; its
    stdout is captured and logged): ``--scheduler continuous --policy edf
    --cells 2 --router jsf --arrival-rate 2 --slo-ms 4000 --max-batch 2
    --requests 8 --seq 4096``, a ``--fleet-spec`` that gives cell1 int8
    pages, ``--options-out``, a trace and the fleet metrics; then a replay
    through ``--options-in`` alone. K1 and K2 must launch in the first run
    (its counts, from 0). Held: every request completes exactly once; both
    cells admit work; each request's argmax equals the same request's
    served by a single ``ContinuousEngine`` cell of the same pages and
    seed, fed the same submissions (the fleet runs the chosen cell dry
    after each placement, so each wave is one request); the replay gives
    the same placements and argmaxes; the merged trace keeps each cell's
    rows apart (one ``engine`` process row per cell).

    Then through ``FleetFabric`` directly, two cells on the same weights:
    the first wave served, three more requests placed without running,
    the cell holding them drained: it completes exactly those, admits
    nothing after (a submit raises, the router never picks it), and the
    last requests go to the other cell."""
    import gc
    import io
    import numpy as np
    import torch
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.core import costmodel as cm
    from repro_torch.core import pipeline as pp
    from repro_torch.core.staging import init_staged
    from repro_torch.fleet import FleetFabric, FleetRouter
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.runtime.engine import ContinuousEngine, EngineConfig, TorchExecutor

    seq = N_CHUNKS * CHUNK
    out = ROOT / "build"
    out.mkdir(parents=True, exist_ok=True)
    spec = out / "fleet_spec.json"
    spec.write_text(json.dumps({"router": "jsf", "cells": [{}, {"kv_dtype": "int8"}]}))
    opts, trace = out / "fleet_options.json", out / "fleet_trace.json"
    argv = ["--arch", FLEET_ARCH, "--scheduler", "continuous", "--policy", "edf",
            "--cells", "2", "--router", "jsf", "--arrival-rate", str(FLEET_RATE),
            "--slo-ms", str(FLEET_SLO_MS), "--max-batch", str(BATCH), "--requests",
            str(FLEET_REQUESTS), "--seq", str(seq), "--fleet-spec", str(spec),
            "--options-out", str(opts), "--trace-out", str(trace), "--metrics-out",
            str(out / "fleet_metrics.json")]

    def cli(args):
        log(f"  serve: python -m repro_torch.launch.serve {' '.join(args)}")
        buf = io.StringIO()
        ops.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = serve.main(args)
        launches, wall = dict(ops.LAUNCHES), time.perf_counter() - t0
        text = buf.getvalue()
        for line in text.splitlines():
            log(f"    {line}")
        check(rc == 0, f"fleet: serve returned {rc}")
        rows = re.findall(r"^request (\d+): cell (cell\d+), argmax (\d+)$", text, re.M)
        rids = sorted(int(r) for r, _, _ in rows)
        check(rids == list(range(FLEET_REQUESTS)),
              f"fleet: requests completed {rids}, not each of {FLEET_REQUESTS} once")
        gc.collect()
        torch.cuda.empty_cache()
        log(f"  serve: {wall:.1f} s, launches {launches}")
        return ({int(r): c for r, c, _ in rows}, {int(r): int(a) for r, _, a in rows},
                launches)

    placed, argmax, launches = cli(argv)
    for name in ("chunk_attention", "pool_attention"):
        check(launches[name] > 0, f"fleet serve: {name} never launched")
        results[name]["launches_by_path"]["fleet serve"] = launches[name]
    check(set(placed.values()) == {"cell0", "cell1"},
          f"fleet: not both cells admitted work: {placed}")
    pids = {str(e["pid"]) for e in json.loads(trace.read_text())["traceEvents"]}
    check({p for p in pids if p.endswith("/engine")} == {"cell0/engine", "cell1/engine"}
          and all(p.split("/")[0] in ("cell0", "cell1") for p in pids),
          f"fleet: trace rows {sorted(pids)}")
    log(f"  fleet: placements {placed}; argmax {argmax}; trace rows {sorted(pids)}")
    replay = cli(["--options-in", str(opts)])
    check(replay[:2] == (placed, argmax),
          f"fleet: the --options-in replay gave {replay[:2]}, not {(placed, argmax)}")

    # ---- single cells: each cell's requests, the same pages and seed
    cfg = get_config(FLEET_ARCH)
    run0 = RunConfig(num_chunks=N_CHUNKS, num_stages=N_STAGES)
    staged = init_staged(cfg, pp.build_plan(cfg, N_STAGES, seq, run0),
                         torch.Generator(device="cuda").manual_seed(0), device="cuda")

    def cell(kv):
        run = RunConfig(num_chunks=N_CHUNKS, num_stages=N_STAGES, remote_attn="qship",
                        attn_backend="cuda", pool_backend="auto", ssm_backend="cuda",
                        kv_dtype=kv)
        ec = EngineConfig(model=cfg, hw=cm.resolve_profile("tpu-v5e"), num_stages=N_STAGES,
                          tp=1, num_chunks=N_CHUNKS, max_batch=BATCH, buckets=(seq,),
                          partition="uniform", kv_dtype=kv, policy="edf",
                          slo=FLEET_SLO_MS / 1e3)
        return ContinuousEngine(ec, TorchExecutor(cfg, staged, run, device="cuda"))

    def reqs(n):
        return serve.make_requests(n, seq, cfg.vocab_size, 0, arrival_rate=FLEET_RATE)

    single = {}
    for name, kv in (("cell0", "auto"), ("cell1", "int8")):
        eng = cell(kv)
        for r in reqs(FLEET_REQUESTS):
            if placed[r.rid] == name:
                eng.submit(r)
                eng.run_until_drained()
        single.update({r.rid: int(np.argmax(r.result)) for r in eng.poll()})
        del eng
    log(f"  single cells (same pages, seed and submissions): argmax {single}")
    check(single == argmax, f"fleet: argmax {argmax} against single cells' {single}")

    # ---- drain one cell after the first wave
    fab = FleetFabric({"cell0": cell("auto"), "cell1": cell("auto")}, FleetRouter("jsf"))
    stream = reqs(FLEET_DRAIN_REQUESTS)
    fab.submit(stream[0])                         # the first wave runs
    for r in stream[1:4]:
        fab.submit(r, pump=False)                 # placed, in flight
    pending = {c: sorted(r for r, p in fab.placements.items() if p == c and r > 0)
               for c in ("cell0", "cell1")}
    victim = max(pending, key=lambda c: len(pending[c]))
    done = fab.drain_cell(victim)
    check(sorted(r.rid for r in done) == pending[victim]
          and all(r.result is not None and np.isfinite(r.result).all() for r in done),
          f"fleet drain: {victim} completed {[r.rid for r in done]}, in flight "
          f"{pending[victim]}")
    refused = False
    try:
        fab.retired[victim].submit(stream[-1])
    except RuntimeError:
        refused = True
    check(refused, f"fleet drain: the drained {victim} admitted a request")
    after = [fab.submit(r).cell for r in stream[4:]]
    fab.pump()
    got = sorted(r.rid for r in fab.completed)
    check(victim not in after and got == list(range(FLEET_DRAIN_REQUESTS)),
          f"fleet drain: later placements {after}, completed {got}")
    m = fab.metrics()
    log(f"  drain: {victim} drained with {pending[victim]} in flight, completed them; "
        f"later requests to {after}; per cell {m['per_cell']}")
    del fab, done, staged              # the engines hold the weights in cycles
    gc.collect()
    torch.cuda.empty_cache()


# ------------------------------------------------------------------- build

# ------------------------------------------------------------------- train

# card against CPU: one fp32 step of each family's smoke config
TRAIN_FAMILIES = ("qwen3-8b", "qwen2-moe-a2.7b", "mamba2-130m", "zamba2-7b",
                  "llava-next-34b", "whisper-small")
# qwen3-8b at full width cut to TRAIN_LAYERS layers, bf16: batch x seq tokens
# a step in TRAIN_ACCUM microbatches, remat on, TRAIN_STEPS steps, warmup 1,
# at TRAIN_LR: with warmup 1 the first AdamW step moves every weight by about
# the LR, and at the default 3e-4 a 4096-wide product's output moves by ~1
# (the loss rose 12.74 -> 25.35 in 4 steps on the card)
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_ACCUM, TRAIN_STEPS = 8, 2, 4096, 2, 4
TRAIN_LR = 1e-5
# the train CLI: stablelm-3b at the 100m preset, a checkpoint every
# TRAIN_CLI_EVERY of TRAIN_CLI_STEPS steps, then --resume from the first
TRAIN_CLI_STEPS, TRAIN_CLI_EVERY = 40, 20
TRAIN_NUMBERS: dict = {}


def train_batch(cfg, device, rows: int, seq: int, seed: int) -> dict:
    """One batch of the seeded synthetic stream on ``device`` (and, for the
    vlm and encdec, stub embeddings from a CPU generator)."""
    import torch
    from repro_torch.data import SyntheticLM
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in SyntheticLM(cfg.vocab_size, seq, rows, seed=seed).next_batch().items()}
    if cfg.frontend.kind != "none" or cfg.family == "encdec":
        nf = cfg.frontend.num_embeds or 16
        gen = torch.Generator().manual_seed(seed)
        batch["embeds"] = (torch.randn((rows, nf, cfg.d_model), generator=gen) * 0.02).to(device)
    return batch


def train_grads(model, params, batch, rows=slice(None)):
    """(loss, gradient leaves in ``optim.leaves`` order) of ``Model.loss``
    at ``params`` on ``batch``'s ``rows``, as the train step takes them."""
    import torch
    from repro_torch.train.optim import leaves, tree_map
    tree = tree_map(lambda p: p.detach().clone().requires_grad_(True), params)
    kw = {"embeds": batch["embeds"][rows]} if "embeds" in batch else {}
    loss = model.loss(tree, batch["tokens"][rows], batch["labels"][rows], **kw)
    return loss.detach(), torch.autograd.grad(loss, leaves(tree))


def step_errors(params, want_params, grads, want_grads, lr: float) -> tuple:
    """(worst gradient error over its leaf's max|g|, worst parameter error
    over its limit, elements whose gradients may differ in sign) of one
    step against another. A first AdamW step moves an element by lr * u,
    u = g / (|g| + eps); two gradients dg apart give u's at most
    min(2, 2 |dg| / |g_want|) apart, so an element's limit is 2e-5 + lr
    times that: 2e-5 where the gradients agree, up to 2 lr + 2e-5 where
    their signs may differ (|g_want| < |dg|; counted)."""
    import torch
    from repro_torch.train.optim import leaves
    g_err, p_over, flips = 0.0, 0.0, 0
    for p, wp, g, wg in zip(leaves(params), leaves(want_params), grads, want_grads):
        p, wp, g, wg = (t.detach().float().cpu() for t in (p, wp, g, wg))
        dg = (g - wg).abs()
        g_err = max(g_err, (dg.max() / wg.abs().max().clamp(min=1e-30)).item())
        limit = 2e-5 + lr * torch.clamp(2 * dg / wg.abs().clamp(min=1e-30), max=2.0)
        p_over = max(p_over, ((p - wp).abs() / limit).max().item())
        flips += int((wg.abs() < dg).sum())
    return g_err, p_over, flips


def train_card_vs_cpu(failures: list) -> None:
    """(a) each family's fp32 smoke config: loss, every gradient leaf and
    the params after one step on the card against the same on the CPU."""
    import copy
    import torch
    from repro_torch.configs import get_smoke_config, replace
    from repro_torch.models.api import build_model
    from repro_torch.train import AdamWConfig, init_train_state, make_train_step
    from repro_torch.train.optim import tree_map
    opt = AdamWConfig(warmup_steps=0, total_steps=10)
    for arch in TRAIN_FAMILIES:
        cfg = replace(get_smoke_config(arch), dtype="float32")
        model = build_model(cfg)
        cpu = init_train_state(model, torch.Generator().manual_seed(0), device="cpu")
        card = tree_map(lambda t: t.cuda(), cpu)
        b_cpu = train_batch(cfg, "cpu", 4, 32, seed=5)
        b_card = {k: v.cuda() for k, v in b_cpu.items()}
        loss, grads = train_grads(model, cpu["params"], b_cpu)
        c_loss, c_grads = train_grads(model, card["params"], b_card)
        step = make_train_step(model, opt)
        s_cpu, m_cpu = step(copy.deepcopy(cpu), b_cpu)
        s_card, m_card = step(card, b_card)
        rel = abs(m_card["loss"].item() - m_cpu["loss"].item()) / abs(m_cpu["loss"].item())
        g_err, p_over, flips = step_errors(s_card["params"], s_cpu["params"], c_grads, grads,
                                           m_cpu["lr"].item())
        ok = rel <= 1e-5 and g_err <= 1e-4 and p_over <= 1.0 and torch.isfinite(c_loss)
        TRAIN_NUMBERS.setdefault("card_vs_cpu", {})[arch] = dict(
            loss_rel=rel, grad_err=g_err, param_over_limit=p_over, sign_may_differ=flips)
        log(f"  (a) {arch}: fp32 step, card vs CPU: loss {m_card['loss'].item():.6f} rel err "
            f"{rel:.2e} (limit 1e-5), worst gradient leaf {g_err:.2e} of its max|g| (1e-4), "
            f"params {p_over:.3f} of their limit, {flips} elements whose gradient sign may "
            f"differ"
            + ("" if ok else "  FAILED"))
        if not ok:
            failures.append(f"train (a) {arch}: card vs CPU")


def train_grad_accum(failures: list) -> None:
    """(b) grad_accum 4 against 1 on the card (qwen3-8b smoke, fp32, 8 rows)."""
    import copy
    import torch
    from repro_torch.configs import get_smoke_config, replace
    from repro_torch.models.api import build_model
    from repro_torch.train import AdamWConfig, init_train_state, make_train_step
    cfg = replace(get_smoke_config("qwen3-8b"), dtype="float32")
    model = build_model(cfg)
    state = init_train_state(model, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    batch = train_batch(cfg, "cuda", 8, 32, seed=5)
    opt = AdamWConfig(warmup_steps=0, total_steps=10)
    _, g1 = train_grads(model, state["params"], batch)
    g4 = None
    for i in range(4):
        _, g = train_grads(model, state["params"], batch, slice(2 * i, 2 * i + 2))
        g4 = [x.float() for x in g] if g4 is None else [a + x.float() for a, x in zip(g4, g)]
    g4 = [a / 4 for a in g4]
    s1, m1 = make_train_step(model, opt, grad_accum=1)(copy.deepcopy(state), batch)
    s4, m4 = make_train_step(model, opt, grad_accum=4)(state, batch)
    rel = abs(m4["loss"].item() - m1["loss"].item()) / abs(m1["loss"].item())
    g_err, p_over, flips = step_errors(s4["params"], s1["params"], g4, g1, m1["lr"].item())
    ok = rel <= 1e-5 and p_over <= 1.0
    TRAIN_NUMBERS["grad_accum"] = dict(loss_rel=rel, grad_err=g_err, param_over_limit=p_over,
                                       sign_may_differ=flips)
    log(f"  (b) grad_accum 4 vs 1 on the card: loss rel err {rel:.2e} (limit 1e-5), "
        f"gradients {g_err:.2e} of max|g|, params {p_over:.3f} of their limit, {flips} "
        f"elements whose gradient sign may differ" + ("" if ok else "  FAILED"))
    if not ok:
        failures.append("train (b): grad_accum 4 vs 1")


def train_full_width(failures: list) -> None:
    """(c) qwen3-8b at full width, TRAIN_LAYERS layers, bf16: TRAIN_STEPS
    steps of TRAIN_BATCH x TRAIN_SEQ tokens in TRAIN_ACCUM microbatches,
    remat on. Step 0's loss within 0.5 of what random weights give and
    within 2e-2 of an fp32 forward of the same weights; every loss and
    grad norm finite; step time, tokens/s and peak memory printed beside
    the card's name and limit. Random weights give logits of variance
    s2 = d * 0.02^2 (the final norm's unit RMS times the head's std
    0.02), whose cross-entropy is ln V + s2 / 2 (12.75 at d 4096, V
    151936), not ln V (11.93)."""
    import math
    import torch
    from repro_torch.configs import get_config, replace
    from repro_torch.models.api import build_model
    from repro_torch.data import SyntheticLM
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step
    from repro_torch.train.optim import leaves, tree_map
    cfg = depth(get_config("qwen3-8b"), TRAIN_LAYERS)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    n_params = sum(p.numel() for p in leaves(params))
    data = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in data.next_batch().items()}
               for _ in range(TRAIN_STEPS)]
    with torch.no_grad():            # an fp32 forward of the same weights, a row at a time
        p32 = tree_map(lambda t: t.float(), params)
        m32 = build_model(replace(cfg, dtype="float32"))
        ref = sum(m32.loss(p32, batches[0]["tokens"][i:i + 1], batches[0]["labels"][i:i + 1],
                           remat=False).item() for i in range(TRAIN_BATCH)) / TRAIN_BATCH
        del p32
    torch.cuda.empty_cache()
    state = {"params": params, "opt": adamw_init(params)}
    step = make_train_step(model, AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                                              total_steps=TRAIN_STEPS),
                           grad_accum=TRAIN_ACCUM, remat=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses, norms = [], [], []
    for b in batches:
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steady = statistics.mean(times[1:])
    ln_v = math.log(cfg.vocab_size)
    expect = ln_v + cfg.d_model * 0.02 ** 2 / 2
    rel = abs(losses[0] - ref) / ref
    ok = (abs(losses[0] - expect) <= 0.5 and rel <= 2e-2
          and all(math.isfinite(x) for x in losses + norms))
    TRAIN_NUMBERS["full_width"] = dict(
        params=n_params, layers=TRAIN_LAYERS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        grad_accum=TRAIN_ACCUM, step_s=times, steady_step_s=steady,
        tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / steady, peak_gib=peak, losses=losses,
        grad_norms=norms, fp32_loss0=ref, expected_loss0=expect, lr=TRAIN_LR, card=card_line())
    log(f"  (c) qwen3-8b full width, {TRAIN_LAYERS} layers ({n_params / 1e9:.3f} B params), "
        f"bf16, {TRAIN_BATCH} x {TRAIN_SEQ} tokens a step in {TRAIN_ACCUM} microbatches, "
        f"remat: losses {[round(x, 4) for x in losses]}, grad norms "
        f"{[round(x, 4) for x in norms]} (lr {TRAIN_LR}); step 0 loss {losses[0]:.4f} "
        f"(random weights: ln V + s2 / 2 = {expect:.4f}, limit 0.5; ln V {ln_v:.4f}), fp32 "
        f"forward {ref:.4f}: rel {rel:.2e} (limit 2e-2)" + ("" if ok else "  FAILED"))
    log(f"  (c) step time {times[0]:.3f} s (first), {steady:.3f} s (mean of steps 1-"
        f"{TRAIN_STEPS - 1}), {TRAIN_BATCH * TRAIN_SEQ / steady:,.0f} tokens/s, peak memory "
        f"{peak:.2f} GiB on {card_line()}")
    del state, batches
    torch.cuda.empty_cache()
    if not ok:
        failures.append("train (c): full width")


class TrainCli:
    """(d) ``python -m repro_torch.launch.train --arch stablelm-3b --preset
    100m`` as a subprocess on the card: TRAIN_CLI_STEPS steps with a
    checkpoint every TRAIN_CLI_EVERY; as soon as the first checkpoint is
    written, a second subprocess ``--resume``s from a copy of it, beside
    the first. ``start`` spawns the first (a fresh process spends ~20 s
    importing torch, torch._dynamo and warming up before its GPU work, so
    the caller overlaps that with its own); ``finish`` restores that
    checkpoint, waits for both and holds: the loss falls (last 5 below the first 5 minus 0.3, as
    ``tests/test_train.py``), the first checkpoint restored on the card
    and saved again gives the same files, and the resumed run's losses
    equal the uninterrupted run's to 1e-5 relative. Each line the two
    print is logged with its time since the first started."""

    def __init__(self):
        import os
        import tempfile
        (ROOT / "build").mkdir(exist_ok=True)
        self.work = Path(tempfile.mkdtemp(prefix="train_cli_", dir=ROOT / "build"))
        self.env = dict(os.environ, PYTHONPATH=str(SRC), PYTHONUNBUFFERED="1")
        self.argv = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "stablelm-3b",
                     "--preset", "100m", "--steps", str(TRAIN_CLI_STEPS), "--ckpt-every",
                     str(TRAIN_CLI_EVERY), "--log-every", "10"]
        self.first = self.work / "full" / f"step_{TRAIN_CLI_EVERY:08d}"
        self.lines: list = []
        self.procs: list = []
        self.threads: list = []
        self.t0 = time.perf_counter()

    def _spawn(self, name: str, extra: list) -> None:
        import threading
        proc = subprocess.Popen(self.argv + extra, env=self.env, text=True,
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)

        def pump():
            for line in proc.stdout:
                self.lines.append(f"    {time.perf_counter() - self.t0:6.2f} s {name}: "
                                  f"{line.rstrip()}")
        self.procs.append(proc)
        self.threads.append(threading.Thread(target=pump, daemon=True))
        self.threads[-1].start()

    def _resume_when_ready(self) -> None:
        import shutil
        while (not self.first.exists() and self.procs[0].poll() is None
               and time.perf_counter() - self.t0 < 300):
            time.sleep(0.05)
        if self.first.exists():
            self.lines.append(f"    {time.perf_counter() - self.t0:6.2f} s checkpoint "
                              f"{TRAIN_CLI_EVERY} written")
            shutil.copytree(self.first, self.work / "half" / self.first.name)
            self._spawn("resumed", ["--ckpt-dir", str(self.work / "half"), "--resume",
                                    "--metrics-out", str(self.work / "half.jsonl")])

    def start(self) -> None:
        import threading
        log(f"  (d) {' '.join(self.argv[1:])} --ckpt-dir ...; then --resume from step "
            f"{TRAIN_CLI_EVERY}")
        self.t0 = time.perf_counter()
        self._spawn("run", ["--ckpt-dir", str(self.work / "full"), "--metrics-out",
                            str(self.work / "full.jsonl")])
        self.watcher = threading.Thread(target=self._resume_when_ready, daemon=True)
        self.watcher.start()

    def _kill(self) -> None:
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    def stop(self) -> None:
        """Kills the CLI processes still running (when the script ends
        early) and removes their directory."""
        import shutil
        self._kill()
        shutil.rmtree(self.work, ignore_errors=True)

    def finish(self, failures: list) -> None:
        from repro_torch.runtime import restore_checkpoint, save_checkpoint
        try:
            self.watcher.join(timeout=330)
            # the first checkpoint restored on the card and saved again
            t1 = time.perf_counter()
            same = False
            if self.first.exists():
                tree, extra = restore_checkpoint(str(self.work / "full"), TRAIN_CLI_EVERY,
                                                 device="cuda")
                again = Path(save_checkpoint(str(self.work / "again"), TRAIN_CLI_EVERY,
                                             tree, extra=extra))
                manifest = lambda d: json.load(open(d / "manifest.json"))
                same = manifest(self.first) == manifest(again)
                del tree
            t_restore = time.perf_counter() - t1
            for proc in self.procs:
                proc.wait(timeout=600)
            for thread in self.threads:
                thread.join(timeout=60)
        finally:
            self._kill()
            log("\n".join(self.lines))
        check(len(self.procs) == 2, f"the train CLI wrote no checkpoint at step {TRAIN_CLI_EVERY}")
        for name, proc in zip(("run", "resumed run"), self.procs):
            check(proc.returncode == 0, f"train CLI {name} exited {proc.returncode}")
        read = lambda f: [json.loads(x) for x in open(f)]
        full, half = read(self.work / "full.jsonl"), read(self.work / "half.jsonl")
        losses = [r["loss"] for r in full]
        drop = statistics.mean(losses[:5]) - statistics.mean(losses[-5:])
        resumed = [abs(a["loss"] - b["loss"]) / abs(a["loss"])
                   for a, b in zip(full[TRAIN_CLI_EVERY:], half)]
        ok = (drop > 0.3 and same and len(half) == TRAIN_CLI_STEPS - TRAIN_CLI_EVERY
              and max(resumed) <= 1e-5)
        TRAIN_NUMBERS["cli"] = dict(loss_first5=statistics.mean(losses[:5]),
                                    loss_last5=statistics.mean(losses[-5:]),
                                    resumed_max_rel=max(resumed), restore_bit_exact=same)
        log(f"  (d) loss {statistics.mean(losses[:5]):.4f} (first 5) -> "
            f"{statistics.mean(losses[-5:]):.4f} (last 5): drop {drop:.4f} (needs > 0.3); "
            f"checkpoint {TRAIN_CLI_EVERY} restored on the card and saved again "
            f"({t_restore:.1f} s): "
            f"{'the same files (every sha256)' if same else 'DIFFERENT files'}; resumed run's "
            f"{len(half)} losses vs the uninterrupted run's: max rel err {max(resumed):.2e} "
            f"(limit 1e-5)" + ("" if ok else "  FAILED"))
        if not ok:
            failures.append("train (d): the CLI")


def train_phase(results: dict, cli: "TrainCli") -> None:
    """Training on the card (``repro_torch.train``): (a) each family's fp32
    smoke step against the CPU's, (b) grad accumulation, (c) qwen3-8b at
    full width cut to 8 layers in bf16, (d) the train CLI with a
    checkpoint and ``--resume``, whose processes ``main`` started beside
    the build (``cli.start()``: a fresh process spends ~20 s importing
    torch and torch._dynamo and warming up on the host, and the build
    leaves the card idle), here collected and held, (e) no kernel
    launched over the whole phase (the training
    path holds none, as the reference's: its attention is
    ``flash_attention_xla``, its SSD the torch scan), recorded as each
    kernel's ``launches_by_path["train"]`` = 0."""
    from repro_torch.kernels import ops
    log(f"[train] {card_line()}")
    failures: list = []
    ops.reset_launches()
    for name, fn in (("card vs CPU", train_card_vs_cpu), ("grad accum", train_grad_accum),
                     ("full width", train_full_width), ("CLI", cli.finish)):
        t0 = time.perf_counter()
        fn(failures)
        log(f"[train] {name} {time.perf_counter() - t0:.1f} s")
    launches = dict(ops.LAUNCHES)
    log(f"  (e) kernel launches over the phase: {launches}")
    for name in results:
        results[name].setdefault("launches_by_path", {})["train"] = launches[name]
    log(f"[train] numbers {json.dumps(TRAIN_NUMBERS)}")
    check(not any(launches.values()), f"the training path launched kernels: {launches}")
    check(not failures, "; ".join(failures))


# the tensor-core body (K1-K3) and K5: (mangled template argument, name) of
# their element types
TC_KV_TYPES = (("13__nv_bfloat16", "bf16"), ("a", "int8"), ("13__nv_fp8_e4m3", "fp8"),
               ("f", "fp32"))
TC_WALKS = {"ChunkWalk": "K1", "StackWalk": "K2", "PagedWalk": "K3"}


# K5 instances that must not spill: (head dim, groups; None: every group)
K5_NO_SPILL = ((128, None), (16, (12, 16)))


def build_phase() -> None:
    """Compiles every library (``-Xptxas -v``) and prints, per library, the
    largest register count and spill of its kernels and, for each instance
    of the tensor-core bodies (K1-K3, K4) and of K5, its own registers and
    spills. Each K5 instance's head slices must be
    ``ops.decode_head_slices``' and the instances of ``K5_NO_SPILL`` (bf16
    and fp32) must spill nothing."""
    from repro_torch.kernels import build, ops
    t0 = time.perf_counter()
    start_fault_builds()                # beside the real build; waited for at first use
    build.build_all(verbose=True)
    log(f"[build] nvcc {time.perf_counter() - t0:.1f} s -> {build.build_dir()}")
    log(f"  nvcc wall time a library (s): "
        f"{ {n: round(t, 1) for n, t in sorted(build.SECONDS.items())} }")
    bad = []
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
                dk, group, heads, slices = map(int, re.findall(r"Li(\d+)E", args)[:4])
                what = (f"K5 G {group}, {heads} kv head(s) a unit, {group // slices} "
                        f"query head(s) a thread")
                if slices != ops.decode_head_slices(group):
                    bad.append(f"K5 G {group}: {slices} head slices, ops.decode_head_slices "
                               f"says {ops.decode_head_slices(group)}")
                spilled = spill is None or spill.group(1) != "0" or spill.group(2) != "0"
                if spilled and any(dk == d0 and (gs is None or group in gs)
                                   for d0, gs in K5_NO_SPILL):
                    bad.append(f"K5 G {group} at D {dk}: {usage}")
            else:
                continue
            kv = next((n for m, n in TC_KV_TYPES if args.startswith(m)), args[:24])
            d = re.search(r"Li(\d+)E", args).group(1)
            log(f"    {what}, {kv} K/V, D {d}: {usage}")
    check(not bad, "; ".join(bad))


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
    cli = TrainCli()
    counter = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    try:
        log(card_line())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        log(f"torch {torch.__version__} cuda {torch.version.cuda} "
            f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

        cli.start()      # the train phase's CLI runs (d) beside the build (GPU idle)
        # meta, no card, beside the build: the roofline wave, then [long]'s
        # and [long-ssm]'s zamba2-7b waves
        counts = [counter.submit(count_roofline_wave),
                  counter.submit(count_roofline_wave, LONG_SEQ, LONG_BATCH)] + [
            counter.submit(count_roofline_wave, HELD_SEQ, SSM_LONG_BATCH, "zamba2-7b", mode)
            for mode in ("mocap", "terapipe")]
        build_phase()
        t0 = time.perf_counter()
        counted, counted_long, *counted_ssm = (f.result() for f in counts)  # before any timed phase
        counted_ssm = dict(zip(("mocap", "terapipe"), counted_ssm))
        log(f"[roofline] the meta counts ({counted[1]:.1f} s and, S {LONG_SEQ} B "
            f"{LONG_BATCH}, {counted_long[1]:.1f} s, beside the build) joined "
            f"{time.perf_counter() - t0:.1f} s after it; zamba2-7b S {HELD_SEQ} B "
            f"{SSM_LONG_BATCH}: " + ", ".join(f"{m} {c[1]:.1f} s" for m, c in counted_ssm.items()))

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
        long_phase(results, counted_long)
        log(f"[long] {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        long_ssm_phase(results, counted_ssm)
        log(f"[long-ssm] {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        roofline_phase(results, counted)
        log(f"[roofline] {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        frontend_phase(results)
        log(f"[frontends] {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        decode_phase(results)
        log(f"[decode] {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        baselines_phase(results)
        log(f"[baselines + continuous] {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        prefix_phase(results)
        log(f"[prefix] {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        obs_phase(results)
        log(f"[obs] {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        fleet_phase(results)
        log(f"[fleet] {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        tp_phase(results)
        log(f"[tp] {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        train_phase(results, cli)
        log(f"[train] {time.perf_counter() - t0:.1f} s")
        torch.cuda.synchronize()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        cli.stop()
        counter.shutdown(wait=True)

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
