"""The port's cost model, LBCP planner and event simulator
(``repro_torch.core.costmodel``, ``core.lbcp``, ``sim``) against the JAX
package's (``repro.core.costmodel``, ``repro.core.lbcp``, ``repro.sim``),
each side from its own configs and profiles.

These are float64 numpy on the host, so the same inputs must give the same
chunk lists and the same floats: lists compare equal, floats at rtol 1e-12.
The reference modules need no device and are imported in-process."""
import itertools
import json

import numpy as np
import pytest

from repro.configs.base import get_config as ref_config
from repro.core import costmodel as ref_cm
from repro.core import lbcp as ref_lbcp
from repro.core import mbkr as ref_mbkr
from repro import sim as ref_sim
from repro_torch.configs import get_config
from repro_torch.core import costmodel as cm
from repro_torch.core import lbcp, mbkr
from repro_torch import sim

ARCHS = ("qwen3-8b", "zamba2-7b", "mamba2-130m")
BUCKETS = (4096, 32768, 131072)
STAGES = (4, 8, 16)
CHUNKS = (4, 8, 16)
PROFILES = ("wsc-gr24", "hgx-b200", "tpu-v5e")
GRID = list(itertools.product(BUCKETS, STAGES, CHUNKS))
# plan_partition's annealing over the whole grid x profiles takes minutes:
# a fixed sample of (arch, profile, bucket, N, M), every value of every
# axis at least twice
PLAN_SAMPLE = [
    ("qwen3-8b", "wsc-gr24", 4096, 8, 8), ("qwen3-8b", "tpu-v5e", 131072, 16, 16),
    ("qwen3-8b", "hgx-b200", 32768, 4, 16), ("zamba2-7b", "wsc-gr24", 32768, 16, 4),
    ("zamba2-7b", "tpu-v5e", 4096, 4, 8), ("zamba2-7b", "hgx-b200", 131072, 8, 16),
    ("mamba2-130m", "wsc-gr24", 131072, 4, 4), ("mamba2-130m", "hgx-b200", 4096, 16, 8),
    ("mamba2-130m", "tpu-v5e", 32768, 8, 16), ("qwen3-8b", "tpu-v5e", 32768, 16, 4),
    # one sample of each of qwen3-14b and the paper's four models
    ("qwen3-14b", "hgx-b200", 32768, 8, 8), ("llama3-70b", "wsc-gr24", 131072, 16, 16),
    ("mistral-123b", "tpu-v5e", 32768, 16, 8), ("qwen3-235b", "hgx-b200", 65536, 16, 16),
    ("llama3-405b", "wsc-gr24", 131072, 16, 8),
]


def close(got, want):
    np.testing.assert_allclose(np.asarray(got, float), np.asarray(want, float),
                               rtol=1e-12, atol=0)


def pair(arch, profile, n, tp=1):
    """(port, reference) stage models and profiles."""
    return ((cm.StageModel.build(get_config(arch), n, tp), cm.PROFILES[profile]),
            (ref_cm.StageModel.build(ref_config(arch), n, tp), ref_cm.PROFILES[profile]))


def test_profiles_are_the_reference_data():
    assert set(cm.PROFILES) == set(ref_cm.PROFILES) == set(PROFILES)
    for name, hw in cm.PROFILES.items():
        assert cm.profile_to_dict(hw) == ref_cm.profile_to_dict(ref_cm.PROFILES[name])
    assert cm.TPU_V5E == cm.PROFILES["tpu-v5e"]


def test_profile_resolution_and_theta(tmp_path):
    """A name, an instance or a JSON path resolve to the same profile, and
    the theta pair agrees with the reference's."""
    hw = cm.PROFILES["hgx-b200"]
    path = tmp_path / "hw.json"
    path.write_text(json.dumps({"profile": cm.profile_to_dict(hw)}))
    assert cm.resolve_profile("hgx-b200") is hw and cm.resolve_profile(hw) is hw
    assert cm.resolve_profile(str(path)) == hw
    for tp in (1, 16):
        theta = cm.profile_theta(hw, tp)
        close(theta, ref_cm.profile_theta(ref_cm.PROFILES["hgx-b200"], tp))
        back = cm.profile_from_theta(hw, theta * 1.5, tp)
        want = ref_cm.profile_from_theta(ref_cm.PROFILES["hgx-b200"], theta * 1.5, tp)
        assert cm.profile_to_dict(back) == ref_cm.profile_to_dict(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_analytics_match_reference(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    assert cfg.param_count() == rcfg.param_count()
    assert cm.layer_linear_flops_per_token(cfg) == ref_cm.layer_linear_flops_per_token(rcfg)
    assert cm.kv_bytes_per_token_layer(cfg) == ref_cm.kv_bytes_per_token_layer(rcfg)
    assert cm.attn_layers(cfg) == ref_cm.attn_layers(rcfg)
    for c, p in ((512, 0), (4096, 28672)):
        assert cm.attn_flops(cfg, c, p) == ref_cm.attn_flops(rcfg, c, p)


@pytest.mark.parametrize("arch,profile", list(itertools.product(ARCHS, PROFILES)))
def test_chunk_costs_and_schedules_match_reference(arch, profile):
    """chunk_cost_arrays, evaluate_prefill and evaluate_e2e over every
    bucket x N x M, uniform chunks, with and without MBKR."""
    for bucket, n, m in GRID:
        (sm, hw), (rsm, rhw) = pair(arch, profile, n)
        assert (sm.layers, sm.attn_layers) == (rsm.layers, rsm.attn_layers)
        chunks = lbcp.uniform_partition(bucket, m)
        assert chunks == ref_lbcp.uniform_partition(bucket, m)
        for use in (False, True):
            mp = mbkr.plan(m, n) if use else None
            rmp = ref_mbkr.plan(m, n) if use else None
            for got, want in zip(cm.chunk_cost_arrays(sm, chunks, hw, mbkr_plan=mp),
                                 ref_cm.chunk_cost_arrays(rsm, chunks, rhw, mbkr_plan=rmp)):
                close(got, want)
            res = cm.evaluate_prefill(chunks, sm, n, hw, mbkr_plan=mp, compress=0.5)
            want = ref_cm.evaluate_prefill(chunks, rsm, n, rhw, mbkr_plan=rmp,
                                           compress=0.5)
            close(res.latency, want.latency)
            close(res.stage_finish, want.stage_finish)
            close(res.chunk_times, want.chunk_times)
            close(res.realloc_overhead, want.realloc_overhead)
            close(cm.evaluate_e2e(8, res.latency, chunks, sm, n, hw, mbkr_plan=mp),
                  ref_cm.evaluate_e2e(8, want.latency, chunks, rsm, n, rhw,
                                      mbkr_plan=rmp))


def test_dp_partition_matches_reference():
    """Stage 1 alone: the DP over a cost that is not linear in the chunk
    size gives the same chunks and objective."""
    rng = np.random.default_rng(0)
    for _ in range(20):
        sq, m, n = int(rng.integers(8, 64)), int(rng.integers(2, 8)), int(rng.integers(2, 17))
        a, b = rng.uniform(0.1, 2.0, 2)

        def cost(ks, s):
            return a * ks + b * ks * (s + ks / 2.0) / sq + (ks ** 1.5) * 0.01
        got = lbcp.dp_partition(sq, m, n, cost)
        assert got == ref_lbcp.dp_partition(sq, m, n, cost)
        assert sum(got[0]) == sq and len(got[0]) == m


@pytest.mark.parametrize("arch,profile,bucket,n,m", PLAN_SAMPLE)
def test_plan_partition_matches_reference(arch, profile, bucket, n, m):
    """DP seed + simulated annealing from the same seed: the same chunk
    list, annealing counts and analytic times."""
    for seed in (0, 7):
        got = lbcp.plan_partition(get_config(arch), bucket, m, n, profile, seed=seed,
                                  sa_iters=120)
        want = ref_lbcp.plan_partition(ref_config(arch), bucket, m, n, profile,
                                       seed=seed, sa_iters=120)
        assert got.chunks == want.chunks and sum(got.chunks) == bucket
        assert (got.quantum, got.batch, got.sa_iters, got.sa_accepted) == \
            (want.quantum, want.batch, want.sa_iters, want.sa_accepted)
        close([got.t_prefill, got.t_e2e, got.throughput, got.dp_objective],
              [want.t_prefill, want.t_e2e, want.throughput, want.dp_objective])
        assert (got.mbkr_plan is None) == (want.mbkr_plan is None)
        if got.mbkr_plan is not None:
            assert (got.mbkr_plan.p2, got.mbkr_plan.num_slots) == \
                (want.mbkr_plan.p2, want.mbkr_plan.num_slots)


SIM_CASES = [(s, arch, ex) for s in ("gpipe", "terapipe", "mocap") for arch in ARCHS
             for ex in ("lockstep", "eventdriven")]


@pytest.mark.parametrize("scheduler,arch,execution", SIM_CASES)
def test_simulate_matches_reference(scheduler, arch, execution):
    for profile, seq, n, m, part in (("wsc-gr24", 65536, 16, 16, "uniform"),
                                     ("hgx-b200", 32768, 8, 8, "lbcp"),
                                     ("tpu-v5e", 131072, 16, 8, "uniform")):
        kw = dict(scheduler=scheduler, num_stages=n, num_chunks=m, seq_len=seq,
                  partition=part, execution=execution, sa_iters=40, compress=0.5)
        got = sim.simulate(sim.SimConfig(model=get_config(arch),
                                         hw=cm.PROFILES[profile], **kw))
        want = ref_sim.simulate(ref_sim.SimConfig(model=ref_config(arch),
                                                  hw=ref_cm.PROFILES[profile], **kw))
        assert got.feasible == want.feasible and got.chunks == want.chunks
        assert got.detail == want.detail
        close([got.makespan, got.e2e_latency, got.throughput, got.peak_mem,
               got.capacity, got.link_bytes],
              [want.makespan, want.e2e_latency, want.throughput, want.peak_mem,
               want.capacity, want.link_bytes])
        if want.stage_busy is not None:
            close(got.stage_busy, want.stage_busy)


@pytest.mark.parametrize("scheduler", ["gpipe", "terapipe", "mocap"])
def test_max_seq_len_matches_reference(scheduler):
    for arch in ("qwen3-8b", "zamba2-7b"):
        kw = dict(scheduler=scheduler, num_stages=16, num_chunks=16, batch=4)
        got = sim.max_seq_len(sim.SimConfig(model=get_config(arch),
                                            hw=cm.PROFILES["tpu-v5e"], **kw))
        want = ref_sim.max_seq_len(ref_sim.SimConfig(model=ref_config(arch),
                                                     hw=ref_cm.PROFILES["tpu-v5e"], **kw))
        assert got == want and got > 0


def test_schedule_request_matches_reference():
    rng = np.random.default_rng(3)
    for n in (4, 16):
        cost, comm = rng.uniform(0.1, 1.0, 8), rng.uniform(0.0, 0.1, 8)
        scale = rng.uniform(1.0, 2.0, n)
        free, rfree = np.zeros(n), np.zeros(n)
        for release in (0.0, 0.5, 30.0):
            got = sim.schedule_request(cost, comm, n, free, release=release,
                                       stage_scale=scale)
            want = ref_sim.schedule_request(cost, comm, n, rfree, release=release,
                                            stage_scale=scale)
            close(got, want)
            close(free, rfree)
