"""Serving on the port: ``PrefillEngine`` and ``ContinuousEngine`` +
``TorchExecutor`` on the CPU, and the serve CLI in a subprocess (the
torch executor on the CPU, and the analytic ``--executor sim``)."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import RunConfig, get_smoke_config, replace
from repro_torch.core import pipeline as pp
from repro_torch.core.staging import init_staged
from repro_torch.launch.serve import make_requests
from repro_torch.runtime.engine import (ContinuousEngine, EngineConfig,
                                        PrefillEngine, Request, TorchExecutor,
                                        bucket_of)

ROOT = os.path.join(os.path.dirname(__file__), "..")
SEQ, M, N = 128, 8, 8


@pytest.mark.parametrize("remote,pool", [("qship", "paged"), ("fetch", "cuda")])
def test_engine_answers_requests_like_direct_pipeline(remote, pool):
    cfg = replace(get_smoke_config("qwen3-8b"), dtype="float32")
    run = RunConfig(num_chunks=M, num_stages=N, remote_attn=remote,
                    attn_backend="cuda", pool_backend=pool)
    plan = pp.build_plan(cfg, N, SEQ, run)
    staged = init_staged(cfg, plan, torch.Generator().manual_seed(0), device="cpu")
    ex = TorchExecutor(cfg, staged, run, device="cpu")
    eng = PrefillEngine(EngineConfig(model=cfg, num_stages=N, tp=1, num_chunks=M,
                                     max_batch=2, buckets=(SEQ,),
                                     partition="uniform"), ex)
    reqs = make_requests(4, SEQ, cfg.vocab_size, seed=3)
    reqs[3] = Request(rid=3, arrival=0.0, seq_len=100,
                      tokens=reqs[3].tokens[:100])      # padded to the bucket
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    assert len(eng.done) == 4 and len(ex.waves) == 2
    assert [len(w["rids"]) for w in ex.waves] == [2, 2]
    assert eng.metrics()["completed"] == 4
    assert len(eng.poll()) == 4 and eng.poll() == []
    by_rid = {r.rid: r for r in eng.done}
    for wave in ex.waves:                  # the same batch, called directly
        toks = np.stack([np.pad(by_rid[i].tokens, (0, SEQ - by_rid[i].seq_len))
                         for i in wave["rids"]])
        direct = pp.prefill_pipeline(cfg, staged, toks, plan, device="cpu").numpy()
        for i, row in zip(wave["rids"], direct):
            np.testing.assert_array_equal(by_rid[i].result, row)
            assert by_rid[i].state == "done" and np.isfinite(row).all()


def test_continuous_engine_waves_answer_like_direct_pipeline():
    """Poisson arrivals under EDF with an SLO over two buckets: every
    request is answered with the logits of a direct ``prefill_pipeline``
    call on its wave, and the waves are the scheduler's admission order cut
    into runs of one bucket, at most ``max_batch`` long."""
    cfg = replace(get_smoke_config("qwen3-8b"), dtype="float32")
    run = RunConfig(num_chunks=M, num_stages=N, remote_attn="qship",
                    attn_backend="cuda", pool_backend="cuda")
    staged = init_staged(cfg, pp.build_plan(cfg, N, SEQ, run),
                         torch.Generator().manual_seed(0), device="cpu")
    ex = TorchExecutor(cfg, staged, run, device="cpu")
    ec = EngineConfig(model=cfg, num_stages=N, tp=1, num_chunks=M, max_batch=2,
                      buckets=(64, SEQ), partition="uniform", policy="edf", slo=0.5)
    eng = ContinuousEngine(ec, ex)
    reqs = make_requests(7, SEQ, cfg.vocab_size, seed=4, arrival_rate=200.0)
    for r, n in zip(reqs, (128, 50, 128, 128, 60, 100, 128)):
        r.seq_len, r.tokens = n, r.tokens[:n]
        eng.submit(r)
    eng.run_until_drained()
    order = [r.rid for r in eng.done]
    assert sorted(order) == list(range(7)) and eng.metrics()["completed"] == 7
    assert all(r.deadline == r.arrival + 0.5 for r in eng.done)
    by_rid = {r.rid: r for r in eng.done}
    waves, cur = [], []
    for rid in order:       # the expected waves, from the admission order
        if cur and (by_rid[rid].bucket != by_rid[cur[0]].bucket or len(cur) == 2):
            waves.append(cur)
            cur = []
        cur.append(rid)
    waves.append(cur)
    assert [w["rids"] for w in ex.waves] == waves
    assert any(len(w) == 2 for w in waves) and {by_rid[w[0]].bucket for w in waves} == {64, SEQ}
    for wave in ex.waves:
        seq = wave["seq"]
        plan = pp.build_plan(cfg, N, seq, run)
        toks = np.stack([np.pad(by_rid[i].tokens, (0, seq - by_rid[i].seq_len))
                         for i in wave["rids"]])
        direct = pp.prefill_pipeline(cfg, staged, toks, plan, device="cpu").numpy()
        for i, row in zip(wave["rids"], direct):
            np.testing.assert_array_equal(by_rid[i].result, row)
            assert by_rid[i].bucket == seq and np.isfinite(row).all()


def test_bucket_of():
    assert bucket_of((64, 128), 10) == 64
    assert bucket_of((64, 128), 100) == 128
    assert bucket_of((64, 128), 500) == 128


def test_executor_refuses_tp_and_ragged_chunks():
    cfg = replace(get_smoke_config("qwen3-8b"), dtype="float32")
    run = RunConfig(num_chunks=M, num_stages=N)
    staged = init_staged(cfg, pp.build_plan(cfg, N, SEQ, run),
                         torch.Generator().manual_seed(0), device="cpu")
    ex = TorchExecutor(cfg, staged, run, device="cpu")
    req = make_requests(1, SEQ, cfg.vocab_size, seed=0)
    with pytest.raises(ValueError):
        ex.run(req, [16] * M, N, tp=2)
    with pytest.raises(ValueError):
        ex.run(req, [8, 24] + [16] * (M - 2), N, tp=1)


def test_serve_cli_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--smoke", "--device", "cpu",
           "--requests", "4", "--seq", "128", "--num-chunks", "8", "--num-stages", "8",
           "--remote-attn", "fetch", "--attn-backend", "cuda", "--pool-backend", "paged",
           "--kv-dtype", "int8"]
    r = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert sum(line.startswith("request ") for line in r.stdout.splitlines()) == 4
    assert "wave wall s:" in r.stdout


def test_serve_cli_continuous_on_cpu():
    """``--scheduler continuous --policy edf`` with Poisson arrivals and an
    SLO: every request answered, the analytic clock printed under its
    profile's name, two waves of two in admission order."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--smoke", "--device", "cpu",
           "--requests", "4", "--seq", "128", "--num-chunks", "8", "--num-stages", "8",
           "--scheduler", "continuous", "--policy", "edf", "--arrival-rate", "50",
           "--slo-ms", "200", "--max-batch", "2"]
    r = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    lines = r.stdout.splitlines()
    assert sum(line.startswith("request ") and "measured completion" in line
               for line in lines) == 4
    assert len(next(x for x in lines if x.startswith("wave wall s:")).split()) == 5
    assert "[edf] completed 4 (rejected 0)" in r.stdout
    assert "analytic (tpu-v5e)" in r.stdout and "SLO" in r.stdout


def test_serve_cli_sim_executor():
    """``--executor sim``: the analytic executor at N 16, tp 16, M 16 with
    LBCP plans, batch and continuous, with the same numbers as the
    reference's serve on the same options."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    common = ["--executor", "sim", "--requests", "10", "--seq", "20000"]
    for extra in ([], ["--scheduler", "continuous", "--policy", "sjf",
                       "--arrival-rate", "4", "--slo-ms", "3000"]):
        out = {}
        for mod in ("repro_torch.launch.serve", "repro.launch.serve"):
            r = subprocess.run([sys.executable, "-m", mod, *common, *extra],
                               capture_output=True, text=True, env=env, timeout=300)
            assert r.returncode == 0, r.stdout + r.stderr
            out[mod] = r.stdout
        line = next(x for x in out["repro_torch.launch.serve"].splitlines()
                    if "completed 10" in x)
        ref = next(x for x in out["repro.launch.serve"].splitlines() if "completed 10" in x)
        # the same numbers in the same order, but the wall time (the second)
        nums = lambda s: [x for i, x in enumerate(re.findall(
            r"\d+\.?\d*", re.sub(r"\([^)]*\)", "", s))) if i != 1]
        assert nums(line) == nums(ref), (line, ref)
