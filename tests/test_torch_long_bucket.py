"""Prefill at the reference engine's largest bucket, S = 131072, on the
port's side (``chip_smoke.py``'s ``[long]`` phase runs it on the card):
qwen3-8b at full width, N 8, M 8 chunks of 16384, one request a wave.

(a) ``build_plan`` at S 131072 equals the reference's table for table
under MBKR and terapipe, and ``alloc_kv_pool`` on meta holds (slots + 1) x
N chunk-pages: 18.79 / 24.16 GB.
(b) ``PrefillEngine`` at ``EngineConfig``'s default buckets (8192, 32768,
131072) puts a 131072-token request in the 131072 bucket and runs it as 8
chunks of 16384, wave for wave as the reference's engine; at smoke size,
with the buckets scaled by 1/256 and one request in each, the port's
logits (TorchExecutor, ``cuda`` / ``cuda`` backends: the kernels' plain
versions on the CPU) match the reference engine's (JaxExecutor, ``jnp``)
within 2e-3 relative.
(c) ``chip_smoke.long_faults`` at a scaled cut (a launch of 64 keys cut at
16, as 16384 at 4096) breaks the sliced per-launch check for K1, K2 and
K3, which the kernels' plain versions pass.
(d) ``rope_angles`` at positions 131000-131071 against float64 and the
reference (bounds and their cause in the test's docstring).
(e) the meta count of the S 131072 wave (``chip_smoke.
count_roofline_wave(131072, 1)``): K1 / K2 work equal to ``kernel_work``'s
closed form over the wave's launches, the counted peaks below the card's
memory."""
import importlib.util
import math
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig as RefRun
from repro.configs.base import get_config as ref_config
from repro.core import plan as ref_plan
from repro.models import layers as ref_layers
from repro.runtime import engine as ref_engine
from repro_torch import bridge
from repro_torch.configs import RunConfig, get_config, get_smoke_config, replace
from repro_torch.core import pipeline as pp
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.roofline import analysis, op_graph
from repro_torch.runtime import engine
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
N, M, S = 8, 8, 131072
BUCKETS = (8192, 32768, 131072)         # EngineConfig's default
SMALL_BUCKETS = tuple(b // 256 for b in BUCKETS)
SMALL_LENGTHS = (30, 100, 512)          # one request in each small bucket
_TABLES = ("own_slot", "host_slot_a", "host_slot_b", "slot_own_chunk",
           "slot_host_chunk_a", "slot_host_chunk_b", "host_slots_used",
           "slot_pages")


@pytest.fixture(scope="module")
def cs():
    """``chip_smoke.py`` as a module (it imports the standard library only
    at its top)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _plan(mode):
    return pp.build_plan(get_config("qwen3-8b"), N, S,
                         RunConfig(num_chunks=M, num_stages=N, mbkr=mode == "mocap",
                                   attn_backend="cuda", pool_backend="cuda"), mode=mode)


# ------------------------------------------------------------ (a) the plan

@pytest.mark.parametrize("mode", ["mocap", "terapipe"])
def test_full_size_plan_matches_reference(mode):
    """Every static table of the port's plan at S 131072 equals the
    reference's; chunks of 16384, 6 slots (p2 6) under MBKR, 8 under
    terapipe, one page a chunk."""
    got = _plan(mode)
    want = ref_plan.build_plan(ref_config("qwen3-8b"), N, S,
                               RefRun(num_chunks=M, num_stages=N, mbkr=mode == "mocap"),
                               mode=mode)
    for f in ("num_slots", "p2", "layers_per_stage", "chunk_len", "num_ticks",
              "page_tokens", "pages_per_chunk"):
        assert getattr(got, f) == getattr(want, f), f
    for f in _TABLES:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)), err_msg=f)
    assert (got.chunk_len, got.layers_per_stage, got.pages_per_chunk) == (16384, 5, 1)
    assert (got.num_slots, got.p2) == ((6, 6) if mode == "mocap" else (8, 8))


@pytest.mark.parametrize("mode,gb", [("mocap", 18.79), ("terapipe", 24.16)])
def test_pool_on_meta_is_the_plan_bytes(mode, gb):
    """``alloc_kv_pool`` for one request on meta: (slots + 1) x N
    chunk-pages of 5 layers x 16384 tokens x 8 kv heads x 128 x bf16 x
    (K, V), exactly; 18.79 GB under MBKR, 24.16 GB under terapipe."""
    cfg, plan = get_config("qwen3-8b"), _plan(mode)
    pool = pp.alloc_kv_pool(cfg, plan, 1, device=torch.device("meta"))
    got = sum(x.numel() * x.element_size() for x in (pool.k, pool.v, pool.k_scale, pool.v_scale)
              if x is not None)
    page = 5 * 16384 * cfg.num_kv_heads * cfg.resolved_head_dim * 2 * 2
    assert got == (plan.num_slots + 1) * N * page
    assert round(got / 1e9, 2) == gb


# ---------------------------------------------------------- (b) the engine

class _Recorder:
    """An executor that records each wave's (rids, chunks) and answers."""

    def __init__(self):
        self.waves = []

    def run(self, requests, chunks, num_stages, tp):
        self.waves.append(([r.rid for r in requests], list(chunks)))
        for r in requests:
            r.result = np.zeros(1)
        return 1.0, np.ones(num_stages)


def test_default_buckets_place_the_long_request_as_the_reference():
    """At the default buckets (partition uniform, max_batch 1) requests of
    5000, 20000, 131072 and 100000 tokens land in 8192, 32768, 131072 and
    131072; each runs alone as 8 equal chunks of its bucket (16384 at
    131072), wave for wave as in the reference's engine."""
    lengths = (5000, 20000, 131072, 100000)
    waves = []
    for mod, cfg in ((engine, get_config("qwen3-8b")), (ref_engine, ref_config("qwen3-8b"))):
        ec = mod.EngineConfig(model=cfg, num_stages=N, tp=1, num_chunks=M, max_batch=1,
                              partition="uniform")
        assert ec.buckets == BUCKETS
        ex = _Recorder()
        eng = mod.PrefillEngine(ec, ex)
        for i, n in enumerate(lengths):
            eng.submit(mod.Request(rid=i, arrival=float(i), seq_len=n))
        assert [r.bucket for r in eng.queue] == [8192, 32768, 131072, 131072]
        eng.run_until_drained()
        waves.append(ex.waves)
    assert waves[0] == waves[1]
    assert waves[0][2] == ([2], [16384] * 8)


REFERENCE = r"""
import sys
import jax, numpy as np
from repro import compat
from repro.compat import AxisType
from repro.configs.base import RunConfig, get_smoke_config, replace
from repro.core import pipeline as pp
from repro.models.api import build_model
from repro.models.topology import Topology
from repro.runtime.engine import EngineConfig, JaxExecutor, PrefillEngine, Request

N, M, BUCKETS, LENGTHS = {N}, {M}, {BUCKETS!r}, {LENGTHS!r}
cfg = replace(get_smoke_config("qwen3-8b"), dtype="float32")
mesh = compat.make_mesh((N, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
topo = Topology(mesh=mesh, stage_axis="data", tp_axis="model")
params = build_model(cfg).init(jax.random.key(0))
out = {{}}
for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
    out["param/" + "/".join(str(k.key) for k in path)] = np.asarray(leaf)
run = RunConfig(num_chunks=M, num_stages=N, attn_backend="jnp")
staged = pp.stage_params(cfg, params, pp.build_plan(cfg, N, BUCKETS[-1], run))
compat.set_mesh(mesh)
rng = np.random.default_rng(1)
ex = JaxExecutor(cfg, staged, topo, run)
eng = PrefillEngine(EngineConfig(model=cfg, num_stages=N, tp=1, num_chunks=M, max_batch=1,
                                 buckets=BUCKETS, partition="uniform"), ex)
for i, n in enumerate(LENGTHS):
    toks = rng.integers(0, cfg.vocab_size, n).astype(np.int32)
    out["tokens/%d" % i] = toks
    eng.submit(Request(rid=i, arrival=float(i), seq_len=n, tokens=toks))
eng.run_until_drained()
for r in eng.done:
    out["logits/%d" % r.rid] = np.asarray(r.result, np.float32)
    out["bucket/%d" % r.rid] = np.int64(r.bucket)
out["seqs"] = np.array([w["seq"] for w in ex.waves])
np.savez(sys.argv[1], **out)
print("DONE")
""".format(N=N, M=M, BUCKETS=SMALL_BUCKETS, LENGTHS=SMALL_LENGTHS)


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
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", REFERENCE, str(path)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and "DONE" in r.stdout, r.stdout + r.stderr
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_engine_buckets_match_reference_engine(reference):
    """Smoke qwen3-8b in fp32, the default buckets scaled by 1/256 (32,
    128, 512), one request of 30, 100 and 512 tokens in each: the port's
    PrefillEngine + TorchExecutor (``cuda`` attention and pool backends,
    whose wrappers take the kernels' plain versions on the CPU) runs the
    waves the reference's PrefillEngine + JaxExecutor runs, each padded to
    its bucket as M 8 chunks, and every request's logits match within 2e-3
    relative (``tests/helpers/pipeline_check.py``'s bound)."""
    cfg = replace(get_smoke_config("qwen3-8b"), dtype="float32")
    run = RunConfig(num_chunks=M, num_stages=N, attn_backend="cuda", pool_backend="cuda")
    params = bridge.params_from_numpy(_unflatten(reference, "param/"), device="cpu")
    staged = pp.stage_params(cfg, params, pp.build_plan(cfg, N, SMALL_BUCKETS[-1], run))
    ex = engine.TorchExecutor(cfg, staged, run, device="cpu")
    eng = engine.PrefillEngine(engine.EngineConfig(
        model=cfg, num_stages=N, tp=1, num_chunks=M, max_batch=1, buckets=SMALL_BUCKETS,
        partition="uniform"), ex)
    for i, n in enumerate(SMALL_LENGTHS):
        eng.submit(engine.Request(rid=i, arrival=float(i), seq_len=n,
                                  tokens=reference["tokens/%d" % i]))
    eng.run_until_drained()
    assert [w["seq"] for w in ex.waves] == list(reference["seqs"]) == list(SMALL_BUCKETS)
    assert [w["chunks"] for w in ex.waves] == [[b // M] * M for b in SMALL_BUCKETS]
    for r in eng.done:
        assert r.bucket == int(reference["bucket/%d" % r.rid])
        want = reference["logits/%d" % r.rid]
        got = np.asarray(r.result)
        assert got.shape == want.shape and np.isfinite(got).all()
        rel = np.abs(got - want) / (np.abs(want) + 1e-3)
        assert rel.max() < 2e-3, (r.rid, rel.max())


# ------------------------------------------------- (c) the chunk faults

def _randn(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                            .astype(np.float32))


def _launch(kind, t, h=4, kvh=2, d=16, slots=3, b=2):
    """(args, kw) of a call of ``ops.<kind>`` as the pipeline makes it, N
    stage groups of ``b`` rows, a chunk of ``t`` queries and ``t`` keys a
    slot: K1 the causal self block, K2 a stack with a mixed valid [N, S]
    (group 0 reads nothing), K3 one page of ``t`` tokens a chunk."""
    q = _randn(N * b, t, h, d)
    valid = torch.zeros((N, slots), dtype=torch.bool)
    for s in range(N):
        valid[s, :min(s, slots)] = True
    if kind == "chunk_attention":
        return (q, _randn(N * b, t, kvh, d, seed=1), _randn(N * b, t, kvh, d, seed=2)), \
            dict(return_state=True)
    if kind == "pool_attention":
        return (q, _randn(slots, N * b, t, kvh, d, seed=1),
                _randn(slots, N * b, t, kvh, d, seed=2), valid), {}
    handles = torch.randperm(slots + 1, generator=torch.Generator().manual_seed(3))
    return (q, _randn(N, slots + 1, b, t, kvh, d, seed=1),
            _randn(N, slots + 1, b, t, kvh, d, seed=2),
            handles[:slots].to(torch.int32), valid), dict(ppc=1)


@pytest.mark.parametrize("kind", ["chunk_attention", "pool_attention", "pool_attention_paged"])
def test_chunk_faults_break_the_sliced_check(cs, kind):
    """The faults of ``long_faults(..., keys=16)`` on launches of 64 keys a
    chunk (the card's 4096 of 16384, scaled by 1/256), under the sliced
    per-launch check of the last 16 queries (``shadowed(q_block=16)``):
    each breaks it (> 1 of the tolerance), the wrappers themselves (the
    plain versions on the CPU) read 0, and on a launch of 16 keys a chunk
    the fault is the wrapper exactly."""
    real = getattr(ops, kind)
    faults = cs.long_faults(ops.chunk_attention, ops.pool_attention_paged,
                            ops.pool_attention, keys=16)
    assert set(faults) == {"chunk_attention", "pool_attention", "pool_attention_paged"}
    name, fault = faults[kind]
    assert "16" in name
    args, kw = _launch(kind, 64)
    for fn, breaks in ((real, False), (fault, True)):
        worst = [0.0]
        cs.shadowed(fn, kind, worst, q_block=16)(*args, **kw)
        assert (worst[0] > 1.0) == breaks, (name, worst[0])
        if not breaks:
            assert worst[0] == 0.0
    args, kw = _launch(kind, 16)
    got, want = fault(*args, **kw), real(*args, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# -------------------------------------------------------------- (d) RoPE

@pytest.mark.parametrize("theta,vs_ref", [(1e6, 2e-3), (5e5, 1e-2)])
def test_rope_angles_far_from_zero(theta, vs_ref):
    """``rope_angles`` at positions 131000-131071 (head dim 128; qwen3's
    theta 1e6, llama3's 5e5). Both packages form the same fp32 exponent
    -ln(theta) i / 64 and the angle pos x freq in fp32. The cause of their
    gap is the fp32 exp: each frequency is within one ulp of the correctly
    rounded exp of that exponent, but XLA's (the reference's) is off by
    that ulp at 6-7 of the 64 and torch's at 0-1, and an angle near 1.3e5
    rad carries the ulp times the position. So: (1) the port's cos / sin
    are the float64 cos / sin of its own fp32 angle within one fp32 ulp at
    1.0 (2**-23); (2) against the float64 cos / sin of the exact angle they
    are within 1e-2 (measured 7.0e-3 / 9.3e-3: the fp32 angle, whose ulp at
    1.3e5 is 7.8e-3, and the fp32 exponent's rounding times pos); (3)
    against the reference within 2e-3 at theta 1e6 and 1e-2 at 5e5
    (measured 9.8e-4 / 7.8e-3, growing with the position: 2.4e-4 at 4096,
    2.0e-3 at 32768 at theta 1e6)."""
    pos = np.arange(131000, 131072)
    cos, sin = (x.numpy().astype(np.float64)
                for x in layers.rope_angles(torch.as_tensor(pos), 128, theta))
    rcos, rsin = (np.asarray(x, np.float64)
                  for x in ref_layers.rope_angles(jnp.asarray(pos), 128, theta))
    arg = (-math.log(theta) * torch.arange(64, dtype=torch.float32) / 64).numpy()
    rounded = np.exp(arg.astype(np.float64)).astype(np.float32).view(np.int32)
    freq = torch.exp(torch.from_numpy(arg)).numpy()
    ref_freq = np.asarray(jnp.exp(jnp.asarray(arg)))
    assert np.abs(freq.view(np.int32) - rounded).max() <= 1
    assert np.abs(ref_freq.view(np.int32) - rounded).max() <= 1
    ang32 = (pos.astype(np.float32)[:, None] * freq).astype(np.float64)
    one_ulp = float(np.spacing(np.float32(1.0)))
    assert np.abs(cos - np.cos(ang32)).max() <= one_ulp
    assert np.abs(sin - np.sin(ang32)).max() <= one_ulp
    exact = pos[:, None] * np.exp(-math.log(theta) * np.arange(64) / 64)
    assert max(np.abs(cos - np.cos(exact)).max(), np.abs(sin - np.sin(exact)).max()) <= 1e-2
    assert max(np.abs(cos - rcos).max(), np.abs(sin - rsin).max()) <= vs_ref


# ------------------------------------------------------ (e) the meta count

def _k2_pairs(plan) -> int:
    """Valid (stage group, slot) pairs over every K2 launch of one layer
    slot of a qship wave: the local pool scan of each tick (a slot's own
    chunk below min(phase, p2)) and, under MBKR with a remote prefix, the
    creditor scan (the host slots' chunks below the pair's phase), as
    ``core.attention.pool_scan`` gates them."""
    stages = np.arange(plan.num_stages)
    first = stages < plan.num_stages // 2
    own = np.asarray(plan.slot_own_chunk)[:plan.num_slots]
    used = np.asarray(plan.host_slots_used)
    host = np.where(first[:, None], np.asarray(plan.slot_host_chunk_a)[None],
                    np.asarray(plan.slot_host_chunk_b)[None])[:, used]
    pairs = 0
    for t in range(plan.num_ticks):
        phase = t - stages
        limit = np.minimum(phase, plan.p2)
        pairs += int(((own[None] >= 0) & (own[None] < limit[:, None])).sum())
        if plan.mode == "mocap" and plan.p2 < plan.num_chunks and len(used):
            pair = np.where(first, phase - plan.pair_shift, phase + plan.pair_shift)
            pairs += int(((host >= 0) & (host < pair[:, None])).sum())
    return pairs


def test_long_wave_count_on_meta(cs):
    """The S 131072 mocap wave (B 1) counted on meta, as ``chip_smoke.py``
    holds the profiler's FLOPs to it: launches K1 75, K2 150
    (``wave_launch_form``); the K1 / K2 work charged equals K1's closed
    form (``kernel_work`` of the causal self block [8, 16384, 32, 128])
    times its launches plus K2's, 4 d H C^2 per valid (group, slot) pair
    and layer (``_k2_pairs``), to rel 1e-12; the counted peak (56.05 GiB)
    is below the card's memory (``HW_H100["hbm_cap"]``)."""
    cost, _ = cs.count_roofline_wave(S, 1)
    plan = _plan("mocap")
    cfg = get_config("qwen3-8b")
    c, h, kvh, d = plan.chunk_len, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    assert cost.launches == cs.wave_launch_form(plan) == {"chunk_attention": 75,
                                                          "pool_attention": 150}
    meta = torch.device("meta")
    q = torch.empty((N, c, h, d), dtype=torch.bfloat16, device=meta)
    kv = torch.empty((N, c, kvh, d), dtype=torch.bfloat16, device=meta)
    k1, _, _ = analysis.kernel_work("chunk_attention", q, kv, kv, return_state=True)
    assert k1 == 4.0 * d * N * h * c * (c + 1) / 2
    k2 = 4.0 * d * h * c * c * plan.layers_per_stage * _k2_pairs(plan)
    want = 75 * k1 + k2
    assert abs(cost.kernel_flops - want) <= 1e-12 * want
    assert cost.peak_live_bytes < analysis.HW_H100["hbm_cap"]
    assert round(cost.peak_live_bytes / 2 ** 30, 2) == 56.05


def test_terapipe_long_wave_peak_on_meta():
    """The terapipe wave at S 131072 (B 1) counted on meta: launches K1 75,
    K2 75, and its peak (61.02 GiB, the largest of the slice's waves) below
    the card's memory."""
    cfg, plan = get_config("qwen3-8b"), _plan("terapipe")
    from repro_torch.core.staging import init_staged
    meta = torch.device("meta")
    with torch.no_grad():
        cost = op_graph.count(
            lambda st, tk: pp.prefill_pipeline(cfg, st, tk, plan, device=meta),
            init_staged(cfg, plan, None, device=meta),
            torch.empty((1, S), dtype=torch.int64, device=meta))
    assert cost.launches == {"chunk_attention": 75, "pool_attention": 75}
    assert cost.peak_live_bytes < analysis.HW_H100["hbm_cap"]
    assert round(cost.peak_live_bytes / 2 ** 30, 2) == 61.02
