"""The port's chunked-pipeline prefill of the ssm and hybrid families at
long chunks (``repro_torch.core.pipeline``) against the JAX reference
``prefill_pipeline``: the float32 smoke mamba2-130m and zamba2-7b at N = 8
stages, M = 8 chunks of C = 256, B = 2, so that every pipeline chunk is 8
SSD chunks of the smoke's 32 (``chip_smoke.py``'s ``[long-ssm]`` runs 16
of 256 a chunk); zamba2-7b also at the full model's 13 groups (2 groups a
stage, the last two group slots padding, as the full model at N 8).

One subprocess (8 fake host devices) runs the reference with the ``jnp``
attention and SSD backends for mamba2 terapipe, zamba2 mocap qship, mocap
fetch, terapipe qship and mocap qship on int8 pages, and zamba2 at 13
groups mocap qship, and writes params, tokens, logits, the
CollectiveLedger and the stage telemetry's ``kv_bytes`` to an ``.npz``;
the port runs each case on the CPU under each ``ssm_backend`` (``torch``;
``cuda``, whose wrapper takes K4's plain version on the CPU) and each
pool backend (``torch``; ``cuda`` and ``paged``, whose wrappers take the
kernels' plain versions).

Bounds, those of ``tests/test_torch_hybrid.py``: float pages max rel err
< 2e-3 against the reference logits; int8 pages argmax equal and p99 rel
err < 1e-2 against the reference's own int8 logits; every ledger key
equal at rtol 1e-6; zamba2's largest per-stage peak of ``kv_bytes`` under
MBKR against terapipe's equal to the plans' slot ratio (6/8).

Then ``chip_smoke.py``'s helpers at this size: its closed form of a
wave's K1 / K2 / K4 launches (``wave_launch_form``) against the wrappers'
calls on the CPU (each a launch on the card) and the meta count's launches
(what the card's ``ops.LAUNCHES`` is held to), and its K4 fault that only
a launch longer than ``SSD_FAULT_POS`` positions shows (``ssd_zero_past``:
every SSD chunk past that position starts from a zero state; scaled to 64
positions) breaking the per-launch check on a
pipeline run where the wrapper itself holds."""
import dataclasses
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import RunConfig, get_smoke_config, replace
from repro_torch.core import pipeline as pp
from repro_torch.core.staging import init_staged
from repro_torch.kernels import ops
from repro_torch.obs import telemetry as obs_t
from repro_torch.roofline import op_graph
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
N, M, C, B = 8, 8, 256, 2
MODELS = {   # name: (arch, hybrid groups; None: the smoke config's)
    "mamba2": ("mamba2-130m", None),
    "zamba2": ("zamba2-7b", None),
    "zamba2_13g": ("zamba2-7b", 13),
}
CASES = {   # name: (model, mode, remote_attn, kv_dtype)
    "mamba2_terapipe": ("mamba2", "terapipe", "qship", "auto"),
    "zamba2_mocap_qship": ("zamba2", "mocap", "qship", "auto"),
    "zamba2_mocap_fetch": ("zamba2", "mocap", "fetch", "auto"),
    "zamba2_terapipe_qship": ("zamba2", "terapipe", "qship", "auto"),
    "zamba2_mocap_qship_int8": ("zamba2", "mocap", "qship", "int8"),
    "zamba2_13g_mocap_qship": ("zamba2_13g", "mocap", "qship", "auto"),
}

REFERENCE = r"""
import dataclasses, sys
import jax, numpy as np
from repro import compat
from repro.compat import AxisType
from repro.configs.base import RunConfig, get_smoke_config, replace
from repro.core import pipeline as pp
from repro.core import transport as tx
from repro.models.api import build_model
from repro.models.topology import Topology

N, M, C, B = {N}, {M}, {C}, {B}
MODELS, CASES = {MODELS!r}, {CASES!r}


def model_cfg(arch, groups):
    cfg = replace(get_smoke_config(arch), dtype="float32")
    if groups is not None:
        h = dataclasses.replace(cfg.hybrid, num_groups=groups)
        cfg = replace(cfg, hybrid=h, num_layers=h.total_layers)
    return cfg


mesh = compat.make_mesh((N, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
topo = Topology(mesh=mesh)
out = {{}}
params, toks = {{}}, {{}}
for model, (arch, groups) in MODELS.items():
    cfg = model_cfg(arch, groups)
    params[model] = build_model(cfg).init(jax.random.key(0))
    toks[model] = jax.random.randint(jax.random.key(1), (B, M * C), 0, cfg.vocab_size)
    out[model + "/tokens"] = np.asarray(toks[model])
    for path, leaf in jax.tree_util.tree_flatten_with_path(params[model])[0]:
        out[model + "/param/" + "/".join(str(k.key) for k in path)] = np.asarray(leaf)
for name, (model, mode, remote, kv) in CASES.items():
    cfg = model_cfg(*MODELS[model])
    run = RunConfig(num_chunks=M, num_stages=N, mbkr=mode == "mocap",
                    remote_attn=remote, attn_backend="jnp", ssm_backend="jnp",
                    kv_dtype=kv)
    plan = pp.build_plan(cfg, N, M * C, run, mode=mode)
    staged = pp.stage_params(cfg, params[model], plan)
    with compat.set_mesh(mesh):
        logits, led, tel = jax.jit(lambda st, tk: pp.prefill_pipeline(
            cfg, st, tk, plan, topo, return_ledger=True,
            return_telemetry=True))(staged, toks[model])
    out[name + "/logits"] = np.asarray(logits, np.float32)
    for k, v in tx.ledger_to_dict(led).items():
        out[name + "/ledger/" + k] = np.float64(v)
    out[name + "/kv_bytes"] = np.asarray(tel["kv_bytes"], np.float64)
np.savez(sys.argv[1], **out)
print("DONE")
""".format(N=N, M=M, C=C, B=B, MODELS=MODELS, CASES=CASES)


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


@pytest.fixture(scope="module")
def cs():
    """``chip_smoke.py`` as a module (it imports the standard library only
    at its top)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cfg(model):
    arch, groups = MODELS[model]
    cfg = replace(get_smoke_config(arch), dtype="float32")
    if groups is not None:
        h = dataclasses.replace(cfg.hybrid, num_groups=groups)
        cfg = replace(cfg, hybrid=h, num_layers=h.total_layers)
    return cfg


def _run_config(mode, remote, kv, ssm_backend="cuda", pool_backend="cuda"):
    return RunConfig(num_chunks=M, num_stages=N, mbkr=mode == "mocap", remote_attn=remote,
                     kv_dtype=kv, ssm_backend=ssm_backend,
                     attn_backend="torch" if pool_backend == "torch" else "cuda",
                     pool_backend=pool_backend)


_RUNS: dict = {}


def _run(reference, case, ssm_backend, pool_backend):
    """The port's (logits, ledger, telemetry, plan) of one case, run once
    a module (the slot-ratio test reads the pipeline test's runs)."""
    key = (case, ssm_backend, pool_backend)
    if key not in _RUNS:
        model, mode, remote, kv = CASES[case]
        cfg = _cfg(model)
        plan = pp.build_plan(cfg, N, M * C, _run_config(mode, remote, kv, ssm_backend,
                                                        pool_backend), mode=mode)
        params = bridge.params_from_numpy(_unflatten(reference, model + "/param/"),
                                          device="cpu")
        logits, led, tel = pp.prefill_pipeline(
            cfg, pp.stage_params(cfg, params, plan), reference[model + "/tokens"], plan,
            device="cpu", return_ledger=True, return_telemetry=True)
        _RUNS[key] = (logits.numpy(), led, tel, plan)
    return _RUNS[key]


@pytest.mark.parametrize("pool_backend", ["torch", "cuda", "paged"])
@pytest.mark.parametrize("ssm_backend", ["torch", "cuda"])
@pytest.mark.parametrize("case", list(CASES))
def test_pipeline_matches_reference(reference, case, ssm_backend, pool_backend):
    model, mode, remote, kv = CASES[case]
    got, led, tel, plan = _run(reference, case, ssm_backend, pool_backend)
    cfg = _cfg(model)
    assert plan.chunk_len == C and C // cfg.ssm.chunk_size == 8
    assert plan.layers_per_stage == (2 if model == "zamba2_13g" else 1)
    assert plan.p2 == (M if mode == "terapipe" or cfg.attn_free else 6)
    want = reference[case + "/logits"]
    assert got.shape == want.shape and np.isfinite(got).all()
    rel = np.abs(got - want) / (np.abs(want) + 1e-3)
    if kv == "int8":
        assert (got.argmax(-1) == want.argmax(-1)).all()
        assert np.percentile(rel, 99) < 1e-2, np.percentile(rel, 99)
    else:
        assert rel.max() < 2e-3, rel.max()
    for k, value in led.items():
        np.testing.assert_allclose(value, reference[f"{case}/ledger/{k}"], rtol=1e-6,
                                   err_msg=k)
    if not cfg.attn_free:
        np.testing.assert_allclose(tel["kv_bytes"], reference[case + "/kv_bytes"],
                                   rtol=1e-6)


def test_mbkr_peak_is_the_slot_ratio(reference):
    """zamba2-7b's largest per-stage peak of ``kv_bytes`` under MBKR over
    terapipe's is the plans' slot ratio, 6/8, on the port and on the
    reference."""
    peaks, slots = {}, {}
    for name in ("zamba2_mocap_qship", "zamba2_terapipe_qship"):
        _, _, tel, plan = _run(reference, name, "cuda", "cuda")
        peaks[name] = obs_t.TelemetryProfile.from_run(tel).per_stage_peak("kv_bytes").max()
        slots[name] = plan.num_slots
        want = reference[f"{name}/kv_bytes"].max(axis=1).max()
        np.testing.assert_allclose(peaks[name], want, rtol=1e-6)
    assert slots["zamba2_mocap_qship"] / slots["zamba2_terapipe_qship"] == 6 / 8
    assert peaks["zamba2_mocap_qship"] / peaks["zamba2_terapipe_qship"] == 6 / 8


# ------------------------------------------------ chip_smoke.py's checks

KERNEL_TAGS = ("chunk_attention", "pool_attention", "pool_attention_paged", "ssd")


@pytest.mark.parametrize("mode", ["mocap", "terapipe"])
@pytest.mark.parametrize("model", list(MODELS))
def test_wave_launch_form(cs, monkeypatch, model, mode):
    """``wave_launch_form(plan, cfg)``: the K1 / K2 / K4 launches of one
    wave on the ``cuda`` pool and SSD equal the wrappers' calls of a CPU
    run of the wave (each a launch on the card) and the launches of the
    same wave counted on meta, which ``[long-ssm]`` holds ``ops.LAUNCHES``
    to. zamba2-7b at 13 groups: K1 lps x ticks = 30, K2 60 under MBKR
    (the qship creditor scan) and 30 under terapipe, K4 lps x pg x ticks =
    60; the ssm family launches K4 only."""
    cfg = _cfg(model)
    plan = pp.build_plan(cfg, N, M * C, _run_config(mode, "qship", "auto"), mode=mode)
    form = cs.wave_launch_form(plan, cfg)
    calls = {}
    for tag in KERNEL_TAGS:
        def counted(*a, _real=getattr(ops, tag), _tag=tag, **k):
            calls[_tag] = calls.get(_tag, 0) + 1
            return _real(*a, **k)
        monkeypatch.setattr(ops, tag, counted)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, M * C))
    staged = init_staged(cfg, plan, torch.Generator().manual_seed(0), device="cpu")
    pp.prefill_pipeline(cfg, staged, toks, plan, device="cpu")
    assert calls == form
    monkeypatch.undo()
    meta = torch.device("meta")
    with torch.no_grad():
        cost = op_graph.count(lambda st, tk: pp.prefill_pipeline(cfg, st, tk, plan, device=meta),
                              init_staged(cfg, plan, None, device=meta),
                              torch.empty((B, M * C), dtype=torch.int64, device=meta))
    assert cost.launches == form
    if model == "zamba2_13g":
        assert form == {"chunk_attention": 30, "pool_attention": 60 if mode == "mocap" else 30,
                        "ssd": 60}
    if model == "mamba2":
        assert set(form) == {"ssd"}


@pytest.mark.parametrize("model", ["mamba2", "zamba2"])
def test_ssd_long_fault_breaks_the_per_launch_check(cs, model):
    """The K4 fault of ``long_faults(..., k4=, pos=64)`` (each SSD chunk at
    or past position 64 of a launch starts from a zero state;
    ``[long-ssm]``'s 512 of 4096, scaled) in the place of ``ops.ssd`` on a
    pipeline wave of 256-position
    chunks: ``long_fault`` holds every launch whole against its plain
    version, and the first launch breaks it (> 1 of the tolerance), where
    the wrapper itself under the same check holds (<= 1). On a launch of
    64 positions the fault is the wrapper exactly."""
    cfg = _cfg(model)
    mode = "terapipe" if cfg.attn_free else "mocap"
    plan = pp.build_plan(cfg, N, M * C, _run_config(mode, "qship", "auto"), mode=mode)
    staged = init_staged(cfg, plan, torch.Generator().manual_seed(0), device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, M * C))

    def run():
        return pp.prefill_pipeline(cfg, staged, toks, plan, device="cpu")
    worst = [0.0]
    with cs.swapped(ops, "ssd", cs.shadowed(ops.ssd, "ssd", worst)):
        run()
    assert worst[0] <= 1.0, worst[0]
    faults = cs.long_faults(ops.chunk_attention, ops.pool_attention_paged, k4=ops.ssd, pos=64)
    name, fault = faults["ssd"]
    assert "64" in name
    failures, results = [], {}
    cs.long_fault(name, "ssd", fault, run, failures, results, phase="[long-ssm]")
    assert not failures, failures
    assert results["ssd"]["planted"][f"long-ssm: {name}"] > 1.0
    rng = np.random.default_rng(2)
    h, p, n = 4, 16, 16
    f32 = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    args = (f32(2, 64, h, p), torch.nn.functional.softplus(f32(2, 64, h)), f32(h),
            f32(2, 64, 1, n), f32(2, 64, 1, n), f32(h))
    init = f32(2, h, p, n)
    for g, w in zip(fault(*args, chunk=32, init_state=init),
                    ops.ssd(*args, chunk=32, init_state=init)):
        assert torch.equal(g, w)
