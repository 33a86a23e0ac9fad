"""The port's stage telemetry, health sentinel, measured tick spans, merged
trace and serve flags (``repro_torch.obs``, ``core.pipeline``,
``runtime.engine``, ``launch.serve``) against the JAX reference.

One subprocess (8 fake host devices) runs the reference's
``prefill_pipeline(return_telemetry=True)`` at the smoke size of
``tests/helpers/pipeline_check.py`` (fp32, N = M = 8, S = 128, B = 2,
parameters from ``model.init(jax.random.key(0))``) for qwen3-8b mocap
qship, mocap fetch (also on int8 pages), terapipe and GPipe (M = 2
microbatches of one row), zamba2-7b (hybrid) and mamba2-130m (ssm), and a
prefix run seeded at k = 3; and the reference's health sentinel on the
qwen3-8b pipeline with one stage's weights set to NaN. The port runs the
same inputs on the CPU.

Tolerances: the counts (occupancy, events, launches, prefix hits) equal
exactly; ``attn_work`` and ``kv_bytes`` at rtol 1e-6, because the reference
sums them in fp32 (the port in float64). Logits with telemetry or health
on equal those with both off, bit for bit.

``launches`` is the reference's logical count: block invocations a stage
makes. With the ``torch`` backends it equals the reference's (``jnp``)
exactly; with the kernel backends a launch serves all N stages, so the
stages' sum is N times the wrappers' calls in a ``timed_launches`` frame
(on the CPU the frame stamps each plain-version call; on the card each
launch, so there the same relation holds against ``ops.LAUNCHES``)."""
import json
import os
import subprocess
import sys
from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import RunConfig, get_config, get_smoke_config, replace
from repro_torch.core import costmodel as cm
from repro_torch.core import pipeline as pp
from repro_torch.kernels import ops
from repro_torch.obs import telemetry as obs_t
from repro_torch.obs.health import HealthMonitor
from repro_torch.obs.profile import measure_prefill
from repro_torch.runtime.engine import (ContinuousEngine, EngineConfig, Request,
                                        SimExecutor)
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
N, M, C, B = 8, 8, 16, 2
GP_M = 2                       # gpipe: microbatches of B // GP_M rows
K = 3                          # the prefix run's hit length
POISON = 3                     # the stage whose weights the health run sets to NaN
CASES = {   # name: (arch, mode, remote_attn, kv_dtype)
    "mocap_qship": ("qwen3-8b", "mocap", "qship", "auto"),
    "mocap_fetch": ("qwen3-8b", "mocap", "fetch", "auto"),
    "mocap_fetch_int8": ("qwen3-8b", "mocap", "fetch", "int8"),
    "terapipe_qship": ("qwen3-8b", "terapipe", "qship", "auto"),
    "gpipe": ("qwen3-8b", "gpipe", "qship", "auto"),
    "hybrid_qship": ("zamba2-7b", "mocap", "qship", "auto"),
    "ssm_terapipe": ("mamba2-130m", "terapipe", "qship", "auto"),
}
ARCHS = ("qwen3-8b", "zamba2-7b", "mamba2-130m")
EXACT = ("own_chunks", "hosted_chunks", "spill_events", "fetch_events",
         "qship_events", "launches", "prefix_hit")

REFERENCE = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from repro import compat
from repro.compat import AxisType
from repro.configs.base import RunConfig, get_smoke_config, replace
from repro.core import pipeline as pp
from repro.models.api import build_model
from repro.models.topology import Topology
from repro.obs.health import HealthMonitor

N, M, C, B, K, GP_M, POISON = {N}, {M}, {C}, {B}, {K}, {GP_M}, {POISON}
CASES = {CASES!r}
mesh = compat.make_mesh((N, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
topo = Topology(mesh=mesh)
compat.set_mesh(mesh)
out = {{}}
params, toks = {{}}, {{}}
for arch in {ARCHS!r}:
    cfg = replace(get_smoke_config(arch), dtype="float32")
    params[arch] = build_model(cfg).init(jax.random.key(0))
    toks[arch] = np.asarray(jax.random.randint(jax.random.key(1), (B, M * C), 0,
                                               cfg.vocab_size))
    out[arch + "/tokens"] = toks[arch]
    for path, leaf in jax.tree_util.tree_flatten_with_path(params[arch])[0]:
        out[arch + "/param/" + "/".join(str(k.key) for k in path)] = np.asarray(leaf)

def save(name, tel):
    for k, v in tel.items():
        out[name + "/tel/" + k] = np.asarray(v, np.float64)

def plan_of(arch, mode, remote, kv):
    cfg = replace(get_smoke_config(arch), dtype="float32")
    if mode == "gpipe":
        run = RunConfig(num_chunks=GP_M, num_stages=N, attn_backend="jnp")
    else:
        run = RunConfig(num_chunks=M, num_stages=N, mbkr=mode == "mocap",
                        remote_attn=remote, attn_backend="jnp", ssm_backend="jnp",
                        kv_dtype=kv)
    plan = pp.build_plan(cfg, N, M * C, run, mode=mode)
    return cfg, plan, pp.stage_params(cfg, params[arch], plan)

for name, (arch, mode, remote, kv) in CASES.items():
    cfg, plan, staged = plan_of(arch, mode, remote, kv)
    _, tel = jax.jit(lambda st, tk: pp.prefill_pipeline(
        cfg, st, tk, plan, topo, return_telemetry=True))(staged, toks[arch])
    save(name, tel)

# the prefix path: a return_kv pool seeds a run whose first K chunks are garbage
cfg, plan, staged = plan_of("qwen3-8b", "mocap", "qship", "auto")
_, pool = jax.jit(lambda st, tk: pp.prefill_pipeline(
    cfg, st, tk, plan, topo, return_kv=True))(staged, toks["qwen3-8b"])
pool = jax.tree.map(np.asarray, pool)
garb = toks["qwen3-8b"].copy()
garb[:, :K * C] = 7
_, tel = jax.jit(lambda st, tk, pl: pp.prefill_pipeline(
    cfg, st, tk, plan, topo, prefix_chunks=K, prefix_pool=pl,
    return_telemetry=True))(staged, garb, pool)
save("prefix", tel)

# the health sentinel: stage POISON's layer weights set to NaN
bad = dict(staged)
bad["stage_layers"] = jax.tree.map(
    lambda a: a.at[POISON].set(jnp.nan) if jnp.issubdtype(a.dtype, jnp.floating) else a,
    staged["stage_layers"])
mon = HealthMonitor()
res = jax.jit(lambda st, tk: pp.prefill_pipeline(cfg, st, tk, plan, topo,
                                                 health=mon))(bad, toks["qwen3-8b"])
jax.block_until_ready(res)
jax.effects_barrier()
out["health/alerts"] = np.array([(a.stage, a.tick, a.value) for a in mon.alerts],
                                np.float64).reshape(-1, 3)
np.savez(sys.argv[1], **out)
print("DONE")
""".format(N=N, M=M, C=C, B=B, K=K, GP_M=GP_M, POISON=POISON, CASES=CASES, ARCHS=ARCHS)


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
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and "DONE" in r.stdout, r.stdout + r.stderr
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _cfg(arch):
    return replace(get_smoke_config(arch), dtype="float32")


def _setup(reference, case, backend):
    """(cfg, plan, staged, tokens) of ``case`` on the port, with the
    attention, pool and SSD backends all ``torch`` or the kernels'
    (``cuda``; pool ``cuda`` or ``paged``)."""
    arch, mode, remote, kv = CASES[case]
    cfg = _cfg(arch)
    kernels = backend != "torch"
    if mode == "gpipe":
        run = RunConfig(num_chunks=GP_M, num_stages=N,
                        attn_backend="cuda" if kernels else "torch")
    else:
        run = RunConfig(num_chunks=M, num_stages=N, mbkr=mode == "mocap",
                        remote_attn=remote, kv_dtype=kv,
                        attn_backend="cuda" if kernels else "torch",
                        pool_backend=backend,
                        ssm_backend="cuda" if kernels else "torch")
    plan = pp.build_plan(cfg, N, M * C, run, mode=mode)
    params = bridge.params_from_numpy(_unflatten(reference, arch + "/param/"),
                                      device="cpu")
    return cfg, plan, pp.stage_params(cfg, params, plan), reference[arch + "/tokens"]


def _assert_telemetry(got, reference, name, skip=()):
    assert set(got) == set(obs_t.TELEM_KEYS)
    for key in obs_t.TELEM_KEYS:
        if key in skip:
            continue
        want = reference[f"{name}/tel/{key}"]
        assert got[key].shape == want.shape == (N, want.shape[1]), key
        if key in EXACT:
            np.testing.assert_array_equal(got[key], want, err_msg=key)
        else:
            np.testing.assert_allclose(got[key], want, rtol=1e-6, err_msg=key)


RUNS = [(case, "torch") for case in CASES] + [
    ("mocap_qship", "cuda"), ("mocap_fetch", "paged"), ("mocap_fetch_int8", "cuda"),
    ("terapipe_qship", "paged"), ("gpipe", "cuda"), ("hybrid_qship", "cuda"),
    ("ssm_terapipe", "cuda")]


@pytest.mark.parametrize("case,backend", RUNS)
def test_telemetry_matches_reference(reference, case, backend):
    """The [N, T] profile of every key against the reference's, logits
    bit-identical with telemetry on and off, and (kernel backends) the
    launches against the wrappers' calls of the same run."""
    cfg, plan, staged, toks = _setup(reference, case, backend)
    off = pp.prefill_pipeline(cfg, staged, toks, plan, device="cpu")
    with ops.timed_launches("cpu") as frame:
        logits, tel = pp.prefill_pipeline(cfg, staged, toks, plan, device="cpu",
                                          return_telemetry=True)
    assert torch.equal(logits, off)
    kernels = backend != "torch"
    _assert_telemetry(tel, reference, case, skip=("launches",) if kernels else ())
    calls = Counter(tag for tag, _ in frame["events"])
    attn = sum(calls[t] for t in ("chunk_attention", "pool_attention",
                                  "pool_attention_paged"))
    if not kernels:
        return
    # the reference's logical count, per stage; one launch serves N stages
    want = N * (calls["ssd"] if cfg.family == "ssm" else attn)
    assert tel["launches"][:, -1].sum() == want > 0
    # the cuda backend's per-stage count is the reference's pallas charge
    per_tick = np.diff(tel["launches"], axis=1, prepend=0)
    assert (per_tick == per_tick[0, 0]).all()


def test_telemetry_closed_forms_on_the_run(reference):
    """The reference's own acceptance, on the port: occupancy equals the
    analytic model tick by tick, the peak equals the slot plan, kv_bytes is
    occupancy x the stored chunk price, events x the per-event price equal
    the ledger, and terapipe peaks at M against MBKR's p2."""
    for case in ("mocap_fetch", "mocap_qship", "terapipe_qship"):
        cfg, plan, staged, toks = _setup(reference, case, "torch")
        _, led, tel = pp.prefill_pipeline(cfg, staged, toks, plan, device="cpu",
                                          return_ledger=True, return_telemetry=True)
        prof = obs_t.TelemetryProfile.from_run(tel)
        own, hosted = obs_t.analytic_occupancy(M, N, plan.p2, mode=plan.mode)
        np.testing.assert_array_equal(prof.data["own_chunks"], own)
        np.testing.assert_array_equal(prof.data["hosted_chunks"], hosted)
        cb = obs_t.chunk_stored_bytes(plan, plan.layers_per_stage, B, C,
                                      cfg.num_kv_heads, cfg.resolved_head_dim)
        np.testing.assert_allclose(prof.data["kv_bytes"], (own + hosted) * cb)
        pe = obs_t.per_event_wire_bytes(plan, cfg, B)
        tot = prof.totals()
        np.testing.assert_allclose(tot["spill_events"] * pe["spill"], led["spill"])
        np.testing.assert_allclose(tot["fetch_events"] * pe["fetch"], led["fetch"])
        np.testing.assert_allclose(tot["qship_events"] * pe["qship"],
                                   led["qship_q"] + led["qship_state"])
        if plan.mode == "mocap":
            assert prof.peak() == plan.num_slots == plan.p2 < M
        else:
            assert prof.peak() == M and tot["spill_events"] == 0


def test_prefix_telemetry_matches_reference(reference):
    """Seeded at k = 3 from a ``return_kv`` pool: ``prefix_hit`` is N x k
    events, and the residency (kv_bytes included) follows the plan's
    lifecycle, not the lent-slot put-back: equal to the reference's."""
    cfg, plan, staged, toks = _setup(reference, "mocap_qship", "torch")
    base, kvp = pp.prefill_pipeline(cfg, staged, toks, plan, device="cpu",
                                    return_kv=True)
    garb = toks.copy()
    garb[:, :K * C] = 7
    seeded, tel, kv2 = pp.prefill_pipeline(cfg, staged, garb, plan, device="cpu",
                                           prefix_chunks=K, prefix_pool=kvp,
                                           return_telemetry=True, return_kv=True)
    assert torch.equal(seeded, base)
    _assert_telemetry(tel, reference, "prefix")
    model = obs_t.prefix_saved_model(plan, plan.layers_per_stage, B, C,
                                     cfg.num_kv_heads, cfg.resolved_head_dim, K)
    assert tel["prefix_hit"][:, -1].sum() == model["events"] == N * K


def _poisoned(staged, stage):
    layers = {k: w.clone() for k, w in staged["stage_layers"].items()}
    for w in layers.values():
        if w.is_floating_point():
            w[stage] = float("nan")
    return dict(staged, stage_layers=layers)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_health_sentinel(reference, backend):
    """Disarmed and armed on healthy weights: bit-identical logits, no
    alert. Stage 3's weights set to NaN: the same (stage, tick, count)
    nonfinite alerts as the reference's (``torch`` backends), and with the
    kernels the first alert at stage 3's first active tick, none before."""
    cfg, plan, staged, toks = _setup(reference, "mocap_qship", backend)
    off = pp.prefill_pipeline(cfg, staged, toks, plan, device="cpu")
    mon = HealthMonitor()
    on = pp.prefill_pipeline(cfg, staged, toks, plan, device="cpu", health=mon)
    assert torch.equal(on, off) and mon.alerts == []
    mon = HealthMonitor()
    pp.prefill_pipeline(cfg, _poisoned(staged, POISON), toks, plan, device="cpu",
                        health=mon)
    got = np.array([(a.stage, a.tick, a.value) for a in mon.alerts]).reshape(-1, 3)
    assert {a.kind for a in mon.alerts} == {"nonfinite"}
    assert all(a.severity == "crit" for a in mon.alerts)
    first = min((a.tick, a.stage) for a in mon.alerts)
    assert first == (POISON, POISON)
    assert all(a.stage >= POISON and a.tick >= a.stage for a in mon.alerts)
    if backend == "torch":
        np.testing.assert_array_equal(got, reference["health/alerts"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nonfinite_count_equals_isfinite(dtype):
    """The health sentinel's count (``x * 0 != 0``, summed in fp32 per row
    and in int64 over rows) equals the count of ``~isfinite`` per stage:
    NaN, +inf and -inf count, -0.0 and large finite values do not."""
    x = torch.randn(8, 2, 16, 64, dtype=dtype)
    x[3, 1, 2, 5] = float("nan")
    x[5] = float("inf")
    x[6, 0, 0, :7] = -float("inf")
    x[0, 0, 0, 0] = -0.0
    x[1, 0, 0, 0] = torch.finfo(dtype).max
    got = pp.nonfinite_per_stage(x)
    assert got.dtype == torch.int64
    assert got.tolist() == (~torch.isfinite(x)).reshape(8, -1).sum(1).tolist() \
        == [0, 0, 0, 1, 0, 2 * 16 * 64, 7, 0]


def test_measured_spans_on_the_run(reference):
    """``measure_prefill``: logits bit-identical to the plain run, tick_s
    [N, T] with every valid cell > 0 and the bubble 0, per-tag kernel
    times from the timed frame; a fit to those spans never does worse (L2)
    than the nominal profile on them (the reference's 1.5x where a rate is
    clamped)."""
    from repro_torch.obs import calibrate as cal
    cfg, plan, staged, toks = _setup(reference, "mocap_qship", "cuda")
    off = pp.prefill_pipeline(cfg, staged, toks, plan, device="cpu")
    logits, meas = measure_prefill(cfg, staged, toks, plan, device="cpu",
                                   timed_kernels=True)
    assert torch.equal(logits, off)
    assert meas.tick_s.shape == (N, M + N - 1)
    valid = meas.valid(M)
    assert valid.sum() == N * M
    assert (meas.tick_s[valid] > 0).all() and (meas.tick_s[~valid] == 0).all()
    assert set(meas.kernel_s) == {"chunk_attention", "pool_attention"}
    assert all(v > 0 for v in meas.kernel_s.values())
    sm = cm.StageModel.build(cfg, N, 1)
    fit = cal.fit_profile(sm, [C] * M, meas, cm.GPU_HGX, mbkr_plan=plan)
    x, y, _ = cal.design_matrix(sm, [C] * M, cm.GPU_HGX, meas.tick_s, mbkr_plan=plan)
    r_cal = float(np.linalg.norm(fit.residual_s))
    r_nom = float(np.linalg.norm(y - x @ fit.theta_nominal))
    clamped = (fit.theta == fit.theta_nominal).any()
    assert r_cal <= r_nom * (1.5 if clamped else 1 + 1e-9), (r_cal, r_nom)


# ------------------------------------------------------ engines and traces

def _sim_engine(mod, cfg, with_health):
    ec = mod.EngineConfig(model=cfg, hw=mod.cm.WSC_PAPER, num_stages=8, tp=1,
                          num_chunks=8, max_batch=4, buckets=(8192,),
                          partition="lbcp", sa_iters=4, policy="fcfs", trace=True)
    eng = mod.ContinuousEngine(ec, mod.SimExecutor(cfg, ec.hw))
    if with_health:
        mon = mod.HealthMonitor(burn_threshold=1.0)
        eng.configure_obs(health=mon)
    for i in range(4):
        eng.submit(mod.Request(rid=i, arrival=0.0, seq_len=8192))
    eng.run_until_drained()
    return eng


def test_engine_merged_trace_sim_matches_reference(tmp_path):
    """``ContinuousEngine.merged_trace`` on the analytic executor equals
    the reference's event for event; the exports parse."""
    from types import SimpleNamespace
    from repro.configs.base import get_config as ref_config
    from repro.core import costmodel as ref_cm
    from repro.obs.health import HealthMonitor as RefMonitor
    from repro.runtime import engine as ref_engine
    ours = SimpleNamespace(EngineConfig=EngineConfig, ContinuousEngine=ContinuousEngine,
                           SimExecutor=SimExecutor, Request=Request, cm=cm,
                           HealthMonitor=HealthMonitor)
    theirs = SimpleNamespace(EngineConfig=ref_engine.EngineConfig,
                             ContinuousEngine=ref_engine.ContinuousEngine,
                             SimExecutor=ref_engine.SimExecutor,
                             Request=ref_engine.Request, cm=ref_cm,
                             HealthMonitor=RefMonitor)
    eng = _sim_engine(ours, get_config("qwen3-8b"), False)
    ref = _sim_engine(theirs, ref_config("qwen3-8b"), False)
    got = eng.merged_trace().chrome_trace()["traceEvents"]
    assert got == ref.merged_trace().chrome_trace()["traceEvents"]
    assert {"kv_lease_bytes", "wire_bytes"} <= {e["name"] for e in got if e["ph"] == "C"}
    assert len(eng.merged_trace().chrome_trace()["traceEvents"]) == len(got)
    paths = eng.export_obs(trace_out=str(tmp_path / "t.json"),
                           metrics_out=str(tmp_path / "m.prom"))
    assert json.load(open(paths["trace"]))["traceEvents"]
    ref_paths = ref.export_obs(metrics_out=str(tmp_path / "ref.prom"))
    assert open(paths["metrics"]).read() == open(ref_paths["metrics"]).read()
    # an attached monitor labels its row, alerts or none
    eng = _sim_engine(ours, get_config("qwen3-8b"), True)
    names = {e["pid"]: e["args"]["name"] for e in
             eng.merged_trace().chrome_trace()["traceEvents"] if e["ph"] == "M"}
    assert names["health"] == "health sentinels"


def test_torch_executor_obs_waves(reference, tmp_path):
    """``ContinuousEngine`` + ``TorchExecutor`` with telemetry, measured
    spans and health armed through ``configure_obs``: each wave carries the
    [N, T] telemetry and spans, the trace has its engine, measured and
    health rows and the ``kv_resident_bytes`` tracks, and the logits equal
    an unarmed engine's bit for bit."""
    from repro_torch.runtime.engine import TorchExecutor
    cfg, plan, staged, toks = _setup(reference, "mocap_qship", "cuda")
    run = RunConfig(num_chunks=M, num_stages=N, attn_backend="cuda", pool_backend="cuda")

    def serve(armed):
        ex = TorchExecutor(cfg, staged, run, device="cpu")
        eng = ContinuousEngine(EngineConfig(model=cfg, num_stages=N, tp=1, num_chunks=M,
                                            max_batch=2, buckets=(M * C,),
                                            partition="uniform", trace=True), ex)
        mon = HealthMonitor()
        if armed:
            eng.configure_obs(telemetry=True, measured=True, health=mon)
        for i in range(4):
            eng.submit(Request(rid=i, arrival=0.0, seq_len=M * C, tokens=toks[i % B]))
        eng.run_until_drained()
        return eng, ex, mon

    eng, ex, mon = serve(True)
    plain, _, _ = serve(False)
    assert [r.result.tolist() for r in eng.done] == [r.result.tolist() for r in plain.done]
    assert len(ex.waves) == 2 and len(eng.measured_waves()) == 2 and mon.alerts == []
    for w in ex.waves:
        assert w["telemetry"]["own_chunks"].shape == w["measured"].shape == (N, M + N - 1)
        assert w["per_event_wire"]["qship"] > 0
    evs = eng.merged_trace().chrome_trace()["traceEvents"]
    pids = {e["pid"] for e in evs if e["ph"] == "M"}
    assert {"engine", "measured", "health"} <= pids
    assert "kv_resident_bytes" in {e["name"] for e in evs if e["ph"] == "C"}


def test_serve_cli_obs_flags(tmp_path, capsys):
    """The serve CLI on the CPU with every observability flag: the trace
    loads as Chrome JSON with its rows, the metrics parse, the calibrated
    profile loads (``meta`` says one card, N stages) and prices a re-run."""
    from repro_torch.launch import serve
    out = tmp_path
    args = ["--smoke", "--device", "cpu", "--requests", "4", "--seq", "128",
            "--num-chunks", "8", "--num-stages", "8", "--scheduler", "continuous",
            "--max-batch", "2", "--slo-ms", "5000"]
    assert serve.main(args + ["--trace-out", str(out / "t.json"), "--metrics-out",
                              str(out / "m.prom"), "--health", "--calibrate",
                              str(out / "cal.json"), "--profile-dir",
                              str(out / "prof")]) == 0
    printed = capsys.readouterr().out
    assert "[health] alerts 0" in printed and "[calibrate]" in printed
    evs = json.load(open(out / "t.json"))["traceEvents"]
    assert {"engine", "measured", "health"} <= {e["pid"] for e in evs if e["ph"] == "M"}
    assert "kv_resident_bytes" in {e["name"] for e in evs if e["ph"] == "C"}
    prom = open(out / "m.prom").read()
    assert "# TYPE repro_completed counter" in prom
    assert "repro_health_alerts_total 0" in prom
    assert json.load(open(out / "prof" / "serve_trace.json"))["traceEvents"]
    blob = json.load(open(out / "cal.json"))
    assert blob["meta"]["one_card"] is True and blob["meta"]["num_stages"] == N
    assert blob["fit"]["feature_terms"] == list(cm.FEATURE_TERMS)
    assert serve.main(args + ["--calibrated-profile", str(out / "cal.json"),
                              "--metrics-out", str(out / "m.jsonl")]) == 0
    assert f"-> {blob['profile']['name']}" in capsys.readouterr().out
    rows = [json.loads(line) for line in open(out / "m.jsonl")]
    assert {"name", "kind", "help"} <= set(rows[0])
