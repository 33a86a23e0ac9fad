"""The port's chunked-pipeline prefill (``repro_torch.core.pipeline``) against
the JAX reference ``prefill_pipeline`` on the deep geometry (N = 8 stages,
tp = 1, M = 8 chunks of C = 16, B = 2, p2 = 6 so chunk 7 really attends to
a remote chunk), float32 smoke qwen3-8b.

One subprocess (8 fake host devices) runs the reference with the ``jnp``
attention backend for five cases and writes params, tokens, logits and the
CollectiveLedger to an ``.npz``; the port runs each case on the CPU under
each pool backend (``torch``; ``cuda`` and ``paged``, whose wrappers take
the kernels' plain versions on the CPU).

Float cases: max rel err < 2e-3 against the reference logits (the bound of
``tests/helpers/pipeline_check.py``) and every ledger key equal at rtol
1e-6. int8 pages: argmax equal and p99 rel err < 1e-2 against the
reference's own int8 logits (both sides read the same quantized pages;
the same holds for the int8 spill wire of a float pool).

The same subprocess also runs the GPipe baseline (``mode="gpipe"``, M = 4
microbatches over B = 8 rows of S = 128); the port's ``gpipe_prefill``
(K1's plain version on the CPU) is held to it and to ``forward`` at max
rel err < 2e-3."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import RunConfig, get_smoke_config, replace
from repro_torch.core import pipeline as pp

ROOT = os.path.join(os.path.dirname(__file__), "..")
N, M, C, B = 8, 8, 16, 2
GP_M, GP_B = 4, 8            # gpipe: microbatches, rows (B divisible by M)
CASES = {   # name: (mode, remote_attn, kv_dtype, kv_spill_dtype)
    "mocap_qship": ("mocap", "qship", "auto", "bfloat16"),
    "mocap_fetch": ("mocap", "fetch", "auto", "bfloat16"),
    "terapipe_qship": ("terapipe", "qship", "auto", "bfloat16"),
    "mocap_qship_int8": ("mocap", "qship", "int8", "bfloat16"),
    "mocap_fetch_spill_int8": ("mocap", "fetch", "auto", "int8"),
}

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
cfg = replace(get_smoke_config("qwen3-8b"), dtype="float32")
mesh = compat.make_mesh((N, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
topo = Topology(mesh=mesh)
params = build_model(cfg).init(jax.random.key(0))
toks = jax.random.randint(jax.random.key(1), (B, M * C), 0, cfg.vocab_size)
out = {{"tokens": np.asarray(toks)}}
for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
    out["param/" + "/".join(str(k.key) for k in path)] = np.asarray(leaf)
for name, (mode, remote, kv, spill) in CASES.items():
    run = RunConfig(num_chunks=M, num_stages=N, mbkr=mode == "mocap",
                    remote_attn=remote, attn_backend="jnp", kv_dtype=kv,
                    kv_spill_dtype=spill)
    plan = pp.build_plan(cfg, N, M * C, run, mode=mode)
    staged = pp.stage_params(cfg, params, plan)
    if name == "mocap_qship":
        for path, leaf in jax.tree_util.tree_flatten_with_path(staged)[0]:
            out["staged/" + "/".join(str(k.key) for k in path)] = np.asarray(leaf)
    with compat.set_mesh(mesh):
        logits, led = jax.jit(lambda st, tk: pp.prefill_pipeline(
            cfg, st, tk, plan, topo, return_ledger=True))(staged, toks)
    out[name + "/logits"] = np.asarray(logits, np.float32)
    for k, v in tx.ledger_to_dict(led).items():
        out[name + "/ledger/" + k] = np.float64(v)
gtoks = jax.random.randint(jax.random.key(2), ({GP_B}, M * C), 0, cfg.vocab_size)
plan = pp.build_plan(cfg, N, M * C, RunConfig(num_chunks={GP_M}, num_stages=N,
                                              attn_backend="jnp"), mode="gpipe")
staged = pp.stage_params(cfg, params, plan)
with compat.set_mesh(mesh):
    logits = jax.jit(lambda st, tk: pp.prefill_pipeline(cfg, st, tk, plan, topo))(
        staged, gtoks)
out["gpipe/tokens"] = np.asarray(gtoks)
out["gpipe/logits"] = np.asarray(logits, np.float32)
np.savez(sys.argv[1], **out)
print("DONE")
""".format(N=N, M=M, C=C, B=B, CASES=CASES, GP_M=GP_M, GP_B=GP_B)


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


def test_bridge_staging_equals_reference_staging(reference):
    """``stage_params`` of the bridged flat params equals the bridged
    output of the reference's ``stage_params``, leaf for leaf."""
    cfg = replace(get_smoke_config("qwen3-8b"), dtype="float32")
    plan = pp.build_plan(cfg, N, M * C, RunConfig(num_chunks=M, num_stages=N))
    params = bridge.params_from_numpy(_unflatten(reference, "param/"), device="cpu")
    staged = pp.stage_params(cfg, params, plan)
    want = bridge.staged_from_numpy(_unflatten(reference, "staged/"), device="cpu")
    assert set(staged) == set(want)
    for key in ("embed", "final_norm", "lm_head"):
        assert torch.equal(staged[key], want[key])
    assert set(staged["stage_layers"]) == set(want["stage_layers"])
    for key, w in want["stage_layers"].items():
        assert torch.equal(staged["stage_layers"][key], w), key


@pytest.mark.parametrize("pool_backend", ["torch", "cuda", "paged"])
@pytest.mark.parametrize("case", list(CASES))
def test_pipeline_matches_reference(reference, case, pool_backend):
    mode, remote, kv, spill = CASES[case]
    cfg = replace(get_smoke_config("qwen3-8b"), dtype="float32")
    run = RunConfig(num_chunks=M, num_stages=N, mbkr=mode == "mocap",
                    remote_attn=remote, kv_dtype=kv, kv_spill_dtype=spill,
                    attn_backend="torch" if pool_backend == "torch" else "cuda",
                    pool_backend=pool_backend)
    plan = pp.build_plan(cfg, N, M * C, run, mode=mode)
    assert plan.p2 == (6 if mode == "mocap" else M)
    params = bridge.params_from_numpy(_unflatten(reference, "param/"), device="cpu")
    staged = pp.stage_params(cfg, params, plan)
    logits, led = pp.prefill_pipeline(cfg, staged, reference["tokens"], plan,
                                      device="cpu", return_ledger=True)
    got = logits.numpy()
    want = reference[case + "/logits"]
    assert got.shape == want.shape and np.isfinite(got).all()
    rel = np.abs(got - want) / (np.abs(want) + 1e-3)
    if "int8" in (kv, spill):
        assert (got.argmax(-1) == want.argmax(-1)).all()
        assert np.percentile(rel, 99) < 1e-2, np.percentile(rel, 99)
    else:
        assert rel.max() < 2e-3, rel.max()
    for key, value in led.items():
        np.testing.assert_allclose(value, reference[f"{case}/ledger/{key}"],
                                   rtol=1e-6, err_msg=key)
    if mode == "mocap":
        assert led["spill"] > 0 and led[{"qship": "qship_q", "fetch": "fetch"}[remote]] > 0


@pytest.mark.parametrize("attn_backend", ["torch", "cuda"])
def test_gpipe_matches_reference_and_forward(reference, attn_backend):
    """GPipe over M = 4 microbatches of 2 rows: the port's logits against
    the reference's gpipe (its ``xla_flash`` attention) and against the
    port's own ``forward`` last-token logits."""
    from repro_torch.models import transformer as T
    cfg = replace(get_smoke_config("qwen3-8b"), dtype="float32")
    plan = pp.build_plan(cfg, N, M * C, RunConfig(num_chunks=GP_M, num_stages=N,
                                                  attn_backend=attn_backend),
                         mode="gpipe")
    assert (plan.mode, plan.num_chunks, plan.chunk_len, plan.num_slots) == \
        ("gpipe", GP_M, 0, 0)
    params = bridge.params_from_numpy(_unflatten(reference, "param/"), device="cpu")
    staged = pp.stage_params(cfg, params, plan)
    toks = reference["gpipe/tokens"]
    got = pp.prefill_pipeline(cfg, staged, toks, plan, device="cpu").numpy()
    want = reference["gpipe/logits"]
    assert got.shape == want.shape == (GP_B, want.shape[1]) and np.isfinite(got).all()
    rel = np.abs(got - want) / (np.abs(want) + 1e-3)
    assert rel.max() < 2e-3, rel.max()
    fwd = T.forward(cfg, params, torch.as_tensor(toks))[:, -1].numpy()
    rel = np.abs(got - fwd) / (np.abs(fwd) + 1e-3)
    assert rel.max() < 2e-3, rel.max()


def test_gpipe_refuses_what_it_does_not_run():
    """A gpipe plan raises for an ssm or hybrid config, for a batch that
    does not divide into M microbatches, and under ``return_ledger``."""
    from repro_torch.core.staging import init_staged
    run = RunConfig(num_chunks=4, num_stages=4)
    cfg = replace(get_smoke_config("qwen3-8b"), dtype="float32")
    plan = pp.build_plan(cfg, 4, 32, run, mode="gpipe")
    staged = init_staged(cfg, plan, torch.Generator().manual_seed(0), device="cpu")
    toks = np.zeros((8, 32), np.int64)
    assert pp.prefill_pipeline(cfg, staged, toks, plan, device="cpu").shape[0] == 8
    with pytest.raises(ValueError):
        pp.prefill_pipeline(cfg, staged, toks[:6], plan, device="cpu")
    with pytest.raises(ValueError):
        pp.prefill_pipeline(cfg, staged, toks, plan, device="cpu", return_ledger=True)
    for arch in ("mamba2-130m", "zamba2-7b"):
        scfg = replace(get_smoke_config(arch), dtype="float32")
        splan = pp.build_plan(scfg, 4, 32, run, mode="gpipe")
        sstaged = init_staged(scfg, splan, torch.Generator().manual_seed(0),
                              device="cpu")
        with pytest.raises(ValueError):
            pp.prefill_pipeline(scfg, sstaged, toks, splan, device="cpu")
