"""Serving on the port: ``PrefillEngine`` + ``TorchExecutor`` on the CPU,
and the serve CLI in a subprocess."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import RunConfig, get_smoke_config, replace
from repro_torch.core import pipeline as pp
from repro_torch.core.staging import init_staged
from repro_torch.launch.serve import make_requests
from repro_torch.runtime.engine import (EngineConfig, PrefillEngine, Request,
                                        TorchExecutor, bucket_of)

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
    eng = PrefillEngine(EngineConfig(model=cfg, num_stages=N, num_chunks=M,
                                     max_batch=2, buckets=(SEQ,)), ex)
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
