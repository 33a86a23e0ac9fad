"""qwen3-14b and the paper's four evaluation models (llama3-70b,
mistral-123b, qwen3-235b, llama3-405b) in the port against the JAX
reference on the CPU:

- the configs, full and smoke, field for field (qwen3-14b's ``source``
  aside: the reference tags it ``[hf:Qwen/Qwen3-8B; hf]``, a slip, while
  its numbers are Qwen3-14B's, which the port's tag names), and the arch
  lists;
- host parity, in-process, each side from its own configs and profiles:
  ``param_count`` and the per-layer analytics, ``chunk_cost_features``,
  the cost model's chunk / ``t_prefill`` / ``t_e2e`` figures, the event
  simulator, the scheduler and both engines on ``SimExecutor`` and
  ``max_seq_len_for_budget`` under MBKR (mocap) and without (terapipe):
  lists equal, floats at rtol 1e-12 (LBCP's annealing samples of these
  archs are in ``tests/test_torch_costmodel.py::PLAN_SAMPLE``);
- ``Model.forward``'s logits of the smoke configs in fp32, parameters from
  ``model.init(jax.random.key(0))`` carried over by the bridge: max rel err
  < 2e-3 (denominator floor 1e-3);
- ``prefill_pipeline`` against the reference pipeline for the smoke
  qwen3-14b (GQA group 5 at head dim 16), llama3-70b, mistral-123b and
  qwen3-235b (MoE), mocap under qship and fetch, the port under the
  ``torch``, ``cuda`` and ``paged`` pools (plain versions on the CPU): logits
  at max rel err < 2e-3 and every ledger key equal at rtol 1e-6; one
  reference subprocess (8 fake host devices, N = 8, tp = 1, M = 8 chunks of
  C = 16, B = 2) runs every case;
- ``decode_step`` of the smoke qwen3-14b (K5's plain version at G 5)
  against the reference's: logits within 2e-3 of max|logit|, the cache
  within 1e-5; the same for the paper's four at their decode groups on
  the card (G 8, 12, 16 over one kv head, 16 over two) and for
  qwen2-moe-a2.7b (MHA)."""
import dataclasses
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro import sim as ref_sim
from repro.configs.base import get_config as ref_config
from repro.configs.base import get_smoke_config as ref_smoke
from repro.configs.base import replace as ref_replace
from repro.core import costmodel as ref_cm
from repro.core import mbkr as ref_mbkr
from repro.kvstore import quant as ref_quant
from repro.kvstore import tiers as ref_tiers
from repro.models.api import build_model as ref_build
from repro.runtime import engine as ref_engine
from repro_torch import bridge, configs, sim
from repro_torch.configs import RunConfig, get_config, get_smoke_config, replace
from repro_torch.core import costmodel as cm
from repro_torch.core import lbcp, mbkr
from repro_torch.core import pipeline as pp
from repro_torch.kvstore import quant, tiers
from repro_torch.models.api import build_model
from repro_torch.runtime import engine
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_sched import build as build_engine
from tests.test_torch_sched import check_same, stream

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCHS = ("qwen3-14b",) + configs.PAPER_MODELS
PROFILES = ("wsc-gr24", "hgx-b200", "tpu-v5e")
# (bucket, N, M): the cost model's grid, cut to what these archs add
GRID = [(4096, 8, 8), (32768, 16, 16), (131072, 16, 8), (32768, 4, 16)]
N, M, C, B = 8, 8, 16, 2
CASES = {f"{arch}_mocap_{remote}": (arch, "mocap", remote)
         for arch in ("qwen3-14b", "llama3-70b", "mistral-123b", "qwen3-235b")
         for remote in ("qship", "fetch")}


def close(got, want):
    np.testing.assert_allclose(np.asarray(got, float), np.asarray(want, float),
                               rtol=1e-12, atol=0)


def pair(arch, n, tp=1):
    """(port, reference) stage models."""
    return (cm.StageModel.build(get_config(arch), n, tp),
            ref_cm.StageModel.build(ref_config(arch), n, tp))


# ----------------------------------------------------------------- configs

def test_arch_lists_match_reference():
    assert configs.ASSIGNED_ARCHS == ref_configs.ASSIGNED_ARCHS
    assert configs.PAPER_MODELS == ref_configs.PAPER_MODELS
    registered = set(configs.list_archs())
    assert set(ARCHS) <= registered
    # every arch the reference lists is registered, and nothing else
    assert registered == set(configs.ASSIGNED_ARCHS) | set(configs.PAPER_MODELS)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    """full_config and smoke_config field for field; qwen3-14b's full
    ``source`` is the one field that differs, by the reference's slip."""
    for full in (True, False):
        cfg = get_config(arch) if full else get_smoke_config(arch)
        rcfg = ref_config(arch) if full else ref_smoke(arch)
        for field in cfg.__dataclass_fields__:
            got, want = getattr(cfg, field), getattr(rcfg, field)
            if field == "source" and arch == "qwen3-14b" and full:
                assert want == "[hf:Qwen/Qwen3-8B; hf]"
                assert got == "[hf:Qwen/Qwen3-14B; hf]"
            elif field == "moe" and want is not None:
                assert {k: getattr(got, k) for k in got.__dataclass_fields__} == \
                    {k: getattr(want, k) for k in got.__dataclass_fields__}
                assert got.real_experts == want.real_experts
            elif field == "frontend":          # each package's own dataclass
                assert (got.kind, got.num_embeds) == (want.kind, want.num_embeds)
            else:
                assert got == want, (field, got, want)
    cfg = get_config(arch)
    assert cfg.num_heads % cfg.num_kv_heads == 0 and cfg.resolved_head_dim == 128


@pytest.mark.parametrize("arch", ARCHS)
def test_model_analytics_match_reference(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    assert cfg.param_count() == rcfg.param_count()
    assert cm.layer_linear_flops_per_token(cfg) == ref_cm.layer_linear_flops_per_token(rcfg)
    assert cm.kv_bytes_per_token_layer(cfg) == ref_cm.kv_bytes_per_token_layer(rcfg)
    assert cm.attn_layers(cfg) == ref_cm.attn_layers(rcfg)
    for c, p in ((512, 0), (4096, 28672)):
        assert cm.attn_flops(cfg, c, p) == ref_cm.attn_flops(rcfg, c, p)
    for n in (8, 16):
        sm, rsm = pair(arch, n)
        close([sm.layers, sm.attn_layers], [rsm.layers, rsm.attn_layers])
        assert cm.kv_chunk_bytes(sm, 512) == ref_cm.kv_chunk_bytes(rsm, 512)


# ---------------------------------------------------------- cost model

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("k", [0, 3])
def test_chunk_cost_features_match_reference(arch, k):
    chunks = [1024, 2048, 1024, 4096, 2048, 1024, 3072, 2048]
    sm, rsm = pair(arch, 8)
    for hw in PROFILES:
        for use in (True, False):
            got = cm.chunk_cost_features(sm, chunks, hw, prefix_hit_chunks=k,
                                         mbkr_plan=mbkr.plan(8, 8) if use else None)
            want = ref_cm.chunk_cost_features(rsm, chunks, hw, prefix_hit_chunks=k,
                                              mbkr_plan=ref_mbkr.plan(8, 8) if use else None)
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch,profile", [(a, p) for a in ARCHS for p in PROFILES])
def test_chunk_costs_and_schedules_match_reference(arch, profile):
    """chunk_cost_arrays, evaluate_prefill (t_prefill) and evaluate_e2e
    (t_e2e) over GRID, uniform chunks, with and without MBKR."""
    hw, rhw = cm.PROFILES[profile], ref_cm.PROFILES[profile]
    for bucket, n, m in GRID:
        sm, rsm = pair(arch, n)
        chunks = lbcp.uniform_partition(bucket, m)
        for use in (False, True):
            mp = mbkr.plan(m, n) if use else None
            rmp = ref_mbkr.plan(m, n) if use else None
            for got, want in zip(cm.chunk_cost_arrays(sm, chunks, hw, mbkr_plan=mp),
                                 ref_cm.chunk_cost_arrays(rsm, chunks, rhw, mbkr_plan=rmp)):
                close(got, want)
            res = cm.evaluate_prefill(chunks, sm, n, hw, mbkr_plan=mp, compress=0.5)
            want = ref_cm.evaluate_prefill(chunks, rsm, n, rhw, mbkr_plan=rmp,
                                           compress=0.5)
            close([res.latency, res.realloc_overhead], [want.latency, want.realloc_overhead])
            close(res.stage_finish, want.stage_finish)
            close(res.chunk_times, want.chunk_times)
            close(cm.evaluate_e2e(8, res.latency, chunks, sm, n, hw, mbkr_plan=mp),
                  ref_cm.evaluate_e2e(8, want.latency, chunks, rsm, n, rhw, mbkr_plan=rmp))


@pytest.mark.parametrize("scheduler", ["gpipe", "terapipe", "mocap"])
@pytest.mark.parametrize("arch", ARCHS)
def test_simulate_matches_reference(scheduler, arch):
    for profile, seq, n, m, part, ex in (("wsc-gr24", 65536, 16, 16, "uniform", "lockstep"),
                                         ("hgx-b200", 32768, 8, 8, "lbcp", "eventdriven"),
                                         ("tpu-v5e", 131072, 16, 8, "uniform", "eventdriven")):
        kw = dict(scheduler=scheduler, num_stages=n, num_chunks=m, seq_len=seq,
                  partition=part, execution=ex, sa_iters=40, compress=0.5)
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


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_max_seq_len_for_budget_matches_reference(arch, kv):
    """The longest sequence whose per-stage pool fits a budget, under MBKR
    (mocap) and without (terapipe), from each side's stage KV bytes: equal,
    and MBKR's the longer at N = M = 16 (the paper's sequence-length claim,
    on the analytic pool)."""
    out = {}
    for use in (True, False):
        sm, rsm = pair(arch, 16)
        kw = dict(num_chunks=16, num_stages=16, page_tokens=64, head_dim=128, mbkr=use)
        got = tiers.max_seq_len_for_budget(
            8e9, kv_token_bytes=cm.kv_chunk_bytes(sm, 1), codec=quant.get_codec(kv), **kw)
        want = ref_tiers.max_seq_len_for_budget(
            8e9, kv_token_bytes=ref_cm.kv_chunk_bytes(rsm, 1),
            codec=ref_quant.get_codec(kv), **kw)
        assert got == want and got > 0
        out[use] = got
    assert out[True] > out[False]


# ------------------------------------------------------ scheduler, engines

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("policy,slo", [("edf", 0.25), ("sjf", None)])
def test_continuous_engine_matches_reference(arch, policy, slo):
    """ContinuousEngine on SimExecutor, the same Poisson stream of mixed
    lengths: admission orders, lease timelines, finish times, metrics and
    the scheduler trace equal to the reference's."""
    got, want = (build_engine(pkg, arch, policy=policy, slo=slo, trace=True,
                              partition="lbcp") for pkg in (engine, ref_engine))
    for eng, pkg in ((got, engine), (want, ref_engine)):
        for r in stream(pkg, 10, (30000, 8192, 100000), rate=6.0, seed=2):
            eng.submit(r)
        eng.run_until_drained()
    check_same(got, want)
    assert got.metrics()["completed"] + got.metrics()["rejected"] == 10
    assert got.trace.chrome_trace() == want.trace.chrome_trace()


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_engine_matches_reference(arch):
    """The batch-synchronous engine with a stage failure and a straggler:
    the same re-meshes, replays, finish times and metrics."""
    got, want = (build_engine(pkg, arch, continuous=False, max_batch=2, partition="lbcp",
                              fail_at={2: 5}, slow={3: 1.5}) for pkg in (engine, ref_engine))
    for eng, pkg in ((got, engine), (want, ref_engine)):
        for r in stream(pkg, 6, (30000, 100000), rate=0.0):
            eng.submit(r)
        eng.run_until_drained()
    m, rm = got.metrics(), want.metrics()
    assert set(m) == set(rm)
    for key, v in rm.items():
        assert (math.isnan(v) and math.isnan(m[key])) or m[key] == pytest.approx(
            v, rel=1e-12, abs=0), key
    assert [(r.rid, r.replays) for r in got.done] == [(r.rid, r.replays) for r in want.done]
    close([r.finish_time for r in got.done], [r.finish_time for r in want.done])
    assert got.failed_stages == want.failed_stages and m["remeshes"] >= 1


# ------------------------------------------------------------------ model

def _ref_params(rcfg):
    return jax.tree.map(np.asarray, ref_build(rcfg).init(jax.random.key(0)))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    rcfg = ref_replace(ref_smoke(arch), dtype="float32")
    cfg = replace(get_smoke_config(arch), dtype="float32")
    tree = _ref_params(rcfg)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 24))
    want = np.asarray(ref_build(rcfg).forward(jax.tree.map(jnp.asarray, tree),
                                              jnp.asarray(toks)))
    got = build_model(cfg).forward(bridge.params_from_numpy(tree, device="cpu"),
                                   torch.from_numpy(toks)).numpy()
    assert got.shape == want.shape
    rel = np.abs(got - want) / (np.abs(want) + 1e-3)
    assert rel.max() < 2e-3, rel.max()


def _decode_steps_match_reference(rcfg, cfg):
    """forward(return_cache) on 16 tokens, the KV axis padded by 8, then 4
    decode steps in both packages from the reference's cache carried
    across: logits within 2e-3 of max|logit| and the cache's k / v within
    1e-5 of their own max|ref| after each step; the first step also against
    the port's own forward on 17 tokens."""
    tree = _ref_params(rcfg)
    rm, pm = ref_build(rcfg), build_model(cfg)
    jp, params = jax.tree.map(jnp.asarray, tree), bridge.params_from_numpy(tree, device="cpu")
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
    _, jcache = rm.forward(jp, jnp.asarray(toks[:, :16]), return_cache=True)
    pad = ((0, 0), (0, 0), (0, 8), (0, 0), (0, 0))
    jcache = {k: (np.pad(np.asarray(v), pad) if k in ("k", "v") else np.asarray(v))
              for k, v in jcache.items()}
    cache = bridge.cache_from_numpy(jcache, "cpu")
    jcache = jax.tree.map(jnp.asarray, jcache)
    full = pm.forward(params, torch.from_numpy(toks[:, :17]))[:, -1].numpy()
    for t in range(16, 20):
        jlogits, jcache = rm.decode_step(jp, jcache, jnp.asarray(toks[:, t]))
        logits, cache = pm.decode_step(params, cache, torch.from_numpy(toks[:, t]))
        want = np.asarray(jlogits, np.float32)
        assert np.abs(logits.numpy() - want).max() <= 2e-3 * np.abs(want).max()
        if t == 16:
            assert np.abs(logits.numpy() - full).max() <= 2e-3 * np.abs(full).max()
        for key in ("k", "v"):
            w = np.asarray(jcache[key], np.float32)
            assert np.abs(cache[key].numpy() - w).max() <= 1e-5 * np.abs(w).max()
        assert cache["pos"].tolist() == [t + 1] * 2


def test_qwen3_14b_decode_steps_match_reference():
    """The smoke qwen3-14b (5 query heads on 1 kv head: K5's plain version
    at G 5), as ``_decode_steps_match_reference`` sets out."""
    arch = "qwen3-14b"
    rcfg = ref_replace(ref_smoke(arch), dtype="float32")
    cfg = replace(get_smoke_config(arch), dtype="float32")
    assert cfg.num_heads // cfg.num_kv_heads == 5
    _decode_steps_match_reference(rcfg, cfg)


# arch -> (query heads, kv heads) of the smoke config decoded: the paper's
# four at the GQA groups they decode with on the card (llama3-70b G 8,
# mistral-123b G 12, qwen3-235b G 16, llama3-405b G 16 over two kv heads),
# qwen2-moe-a2.7b as it is (MHA)
DECODE_HEADS = {"llama3-70b": (8, 1), "mistral-123b": (12, 1), "qwen3-235b": (16, 1),
                "llama3-405b": (32, 2), "qwen2-moe-a2.7b": (4, 4)}


@pytest.mark.parametrize("arch", DECODE_HEADS)
def test_decode_steps_match_reference_at_the_card_groups(arch):
    """The smoke configs of the paper's four models with the query / kv heads
    of ``DECODE_HEADS`` set in both packages through each one's own
    ``replace`` (head dim 16 kept), and qwen2-moe-a2.7b's: K5's plain
    version at G 8, 12, 16 and 1, as ``_decode_steps_match_reference``
    sets out. An MoE config (qwen3-235b, experts kept; qwen2-moe-a2.7b)
    takes, in both packages, the capacity at which no token drops, as the
    decode bridge on the card does, so that forward on 17 tokens and the
    one-token decode step route alike."""
    h, kvh = DECODE_HEADS[arch]
    rcfg = ref_replace(ref_smoke(arch), dtype="float32", num_heads=h, num_kv_heads=kvh)
    cfg = replace(get_smoke_config(arch), dtype="float32", num_heads=h, num_kv_heads=kvh)
    if cfg.moe is not None:
        no_drop = cfg.moe.real_experts / cfg.moe.top_k
        rcfg = ref_replace(rcfg, moe=dataclasses.replace(rcfg.moe, capacity_factor=no_drop))
        cfg = replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=no_drop))
    assert (cfg.resolved_head_dim, rcfg.resolved_head_dim) == (16, 16)
    _decode_steps_match_reference(rcfg, cfg)


# ---------------------------------------------------------------- pipeline

REFERENCE = r"""
import sys
import jax, numpy as np
from repro import compat
from repro.compat import AxisType
from repro.configs.base import RunConfig, get_smoke_config, replace
from repro.core import pipeline as pp
from repro.core import transport as tx
from repro.models.api import build_model
from repro.models.topology import Topology

N, M, C, B = {N}, {M}, {C}, {B}
CASES = {CASES!r}
mesh = compat.make_mesh((N, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
topo = Topology(mesh=mesh)
out = {{}}
for arch in sorted({{a for a, _, _ in CASES.values()}}):
    cfg = replace(get_smoke_config(arch), dtype="float32")
    params = build_model(cfg).init(jax.random.key(0))
    toks = jax.random.randint(jax.random.key(1), (B, M * C), 0, cfg.vocab_size)
    out[arch + "/tokens"] = np.asarray(toks)
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        out[arch + "/param/" + "/".join(str(k.key) for k in path)] = np.asarray(leaf)
    for name, (a, mode, remote) in CASES.items():
        if a != arch:
            continue
        run = RunConfig(num_chunks=M, num_stages=N, mbkr=mode == "mocap",
                        remote_attn=remote, attn_backend="jnp")
        plan = pp.build_plan(cfg, N, M * C, run, mode=mode)
        staged = pp.stage_params(cfg, params, plan)
        with compat.set_mesh(mesh):
            logits, led = jax.jit(lambda st, tk: pp.prefill_pipeline(
                cfg, st, tk, plan, topo, return_ledger=True))(staged, toks)
        out[name + "/logits"] = np.asarray(logits, np.float32)
        for k, v in tx.ledger_to_dict(led).items():
            out[name + "/ledger/" + k] = np.float64(v)
np.savez(sys.argv[1], **out)
print("DONE")
""".format(N=N, M=M, C=C, B=B, CASES=CASES)


def _unflatten(flat, prefix):
    tree = {}
    for key, val in flat.items():
        if not key.startswith(prefix):
            continue
        *path, leaf = key[len(prefix):].split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = val
    return tree


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "ref.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "-c", REFERENCE, str(path)], env=env,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0 and "DONE" in r.stdout, r.stdout + r.stderr
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("pool_backend", ["torch", "cuda", "paged"])
@pytest.mark.parametrize("case", list(CASES))
def test_pipeline_matches_reference(reference, case, pool_backend):
    arch, mode, remote = CASES[case]
    cfg = replace(get_smoke_config(arch), dtype="float32")
    run = RunConfig(num_chunks=M, num_stages=N, mbkr=True, remote_attn=remote,
                    attn_backend="torch" if pool_backend == "torch" else "cuda",
                    pool_backend=pool_backend)
    plan = pp.build_plan(cfg, N, M * C, run, mode=mode)
    assert plan.p2 == 6
    params = bridge.params_from_numpy(_unflatten(reference, arch + "/param/"), device="cpu")
    staged = pp.stage_params(cfg, params, plan)
    logits, led = pp.prefill_pipeline(cfg, staged, reference[arch + "/tokens"], plan,
                                      device="cpu", return_ledger=True)
    got = logits.numpy()
    want = reference[case + "/logits"]
    assert got.shape == want.shape and np.isfinite(got).all()
    rel = np.abs(got - want) / (np.abs(want) + 1e-3)
    assert rel.max() < 2e-3, rel.max()
    for key, value in led.items():
        np.testing.assert_allclose(value, reference[f"{case}/ledger/{key}"],
                                   rtol=1e-6, err_msg=key)
    assert led["spill"] > 0 and led[{"qship": "qship_q", "fetch": "fetch"}[remote]] > 0
