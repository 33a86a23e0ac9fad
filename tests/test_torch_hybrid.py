"""The port's chunked-pipeline prefill for the ssm and hybrid families
(mamba2-130m, zamba2-7b smoke configs, float32) against the JAX reference
``prefill_pipeline`` on the deep geometry (N = 8 stages, tp = 1, M = 8
chunks of C = 16, B = 2; for zamba2-7b p2 = 6, so chunk 7 attends to a
remote chunk of the shared block's KV), plus serving both families.

One subprocess (8 fake host devices) runs the reference, with the ``jnp``
attention and SSD backends, for the four cases and writes params, tokens,
staged params, logits and the CollectiveLedger to one ``.npz``; the port
runs each case on the CPU under each ``ssm_backend`` (``torch``; ``cuda``,
whose wrapper takes K4's plain version on the CPU) and each pool backend
(``torch``, ``cuda``, ``paged``).

Float cases: max rel err < 2e-3 against the reference logits and every
ledger key equal at rtol 1e-6. int8 pages: argmax equal and p99 rel err
< 1e-2 against the reference's own int8 logits."""
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
from repro_torch.launch.serve import make_requests
from repro_torch.runtime.engine import EngineConfig, PrefillEngine, TorchExecutor
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
N, M, C, B = 8, 8, 16, 2
CASES = {   # name: (arch, mode, remote_attn, kv_dtype)
    "mamba2_terapipe": ("mamba2-130m", "terapipe", "qship", "auto"),
    "zamba2_mocap_qship": ("zamba2-7b", "mocap", "qship", "auto"),
    "zamba2_mocap_fetch": ("zamba2-7b", "mocap", "fetch", "auto"),
    "zamba2_mocap_qship_int8": ("zamba2-7b", "mocap", "qship", "int8"),
}
ARCHS = ("mamba2-130m", "zamba2-7b")

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
params, toks = {{}}, {{}}
for arch in {ARCHS!r}:
    cfg = replace(get_smoke_config(arch), dtype="float32")
    params[arch] = build_model(cfg).init(jax.random.key(0))
    toks[arch] = jax.random.randint(jax.random.key(1), (B, M * C), 0, cfg.vocab_size)
    out[arch + "/tokens"] = np.asarray(toks[arch])
    for path, leaf in jax.tree_util.tree_flatten_with_path(params[arch])[0]:
        out[arch + "/param/" + "/".join(str(k.key) for k in path)] = np.asarray(leaf)
for name, (arch, mode, remote, kv) in CASES.items():
    cfg = replace(get_smoke_config(arch), dtype="float32")
    run = RunConfig(num_chunks=M, num_stages=N, mbkr=mode == "mocap",
                    remote_attn=remote, attn_backend="jnp", ssm_backend="jnp",
                    kv_dtype=kv)
    plan = pp.build_plan(cfg, N, M * C, run, mode=mode)
    staged = pp.stage_params(cfg, params[arch], plan)
    if kv == "auto" and remote == "qship":
        for path, leaf in jax.tree_util.tree_flatten_with_path(staged)[0]:
            out[arch + "/staged/" + "/".join(str(k.key) for k in path)] = np.asarray(leaf)
    with compat.set_mesh(mesh):
        logits, led = jax.jit(lambda st, tk: pp.prefill_pipeline(
            cfg, st, tk, plan, topo, return_ledger=True))(staged, toks[arch])
    out[name + "/logits"] = np.asarray(logits, np.float32)
    for k, v in tx.ledger_to_dict(led).items():
        out[name + "/ledger/" + k] = np.float64(v)
np.savez(sys.argv[1], **out)
print("DONE")
""".format(N=N, M=M, C=C, B=B, CASES=CASES, ARCHS=ARCHS)


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


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_staging_equals_reference_staging(reference, arch):
    """``stage_params`` of the bridged flat params equals the bridged
    output of the reference's ``stage_params``, leaf for leaf (the hybrid
    fold: tail as pseudo-group G, groups zero-padded to N x lps)."""
    cfg = _cfg(arch)
    plan = pp.build_plan(cfg, N, M * C, RunConfig(num_chunks=M, num_stages=N))
    params = bridge.params_from_numpy(_unflatten(reference, arch + "/param/"), device="cpu")
    staged = pp.stage_params(cfg, params, plan)
    want = bridge.staged_from_numpy(_unflatten(reference, arch + "/staged/"), device="cpu")
    assert set(staged) == set(want)
    flat = lambda t, pre="": {f"{pre}{k}": v for key, sub in t.items()   # noqa: E731
                              for k, v in (flat(sub, f"{pre}{key}/").items()
                                           if isinstance(sub, dict) else [(key, sub)])}
    got, ref = flat(staged), flat(want)
    assert set(got) == set(ref)
    for key, w in ref.items():
        assert torch.equal(got[key], w), key


@pytest.mark.parametrize("pool_backend", ["torch", "cuda", "paged"])
@pytest.mark.parametrize("ssm_backend", ["torch", "cuda"])
@pytest.mark.parametrize("case", list(CASES))
def test_pipeline_matches_reference(reference, case, ssm_backend, pool_backend):
    arch, mode, remote, kv = CASES[case]
    cfg = _cfg(arch)
    run = RunConfig(num_chunks=M, num_stages=N, mbkr=mode == "mocap",
                    remote_attn=remote, kv_dtype=kv, ssm_backend=ssm_backend,
                    attn_backend="torch" if pool_backend == "torch" else "cuda",
                    pool_backend=pool_backend)
    plan = pp.build_plan(cfg, N, M * C, run, mode=mode)
    assert plan.p2 == (6 if mode == "mocap" else M)
    params = bridge.params_from_numpy(_unflatten(reference, arch + "/param/"), device="cpu")
    staged = pp.stage_params(cfg, params, plan)
    logits, led = pp.prefill_pipeline(cfg, staged, reference[arch + "/tokens"], plan,
                                      device="cpu", return_ledger=True)
    got = logits.numpy()
    want = reference[case + "/logits"]
    assert got.shape == want.shape and np.isfinite(got).all()
    rel = np.abs(got - want) / (np.abs(want) + 1e-3)
    if kv == "int8":
        assert (got.argmax(-1) == want.argmax(-1)).all()
        assert np.percentile(rel, 99) < 1e-2, np.percentile(rel, 99)
    else:
        assert rel.max() < 2e-3, rel.max()
    for key, value in led.items():
        np.testing.assert_allclose(value, reference[f"{case}/ledger/{key}"],
                                   rtol=1e-6, err_msg=key)
    if mode == "mocap":
        assert led["spill"] > 0 and led[{"qship": "qship_q", "fetch": "fetch"}[remote]] > 0
    else:
        assert led["spill"] == 0 and led["ring"] > 0


def test_fresh_state_resets_per_stage():
    """A stage at phase 0 starts from a zero SSM state while the stages
    beside it carry theirs: the same tokens through N = 4 stages and
    through N = 2 stages (other fill ticks, other neighbours at phase 0)
    give the same logits, and both equal the whole-sequence forward."""
    from repro_torch.models import hybrid as HY
    cfg = _cfg("zamba2-7b")
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, 4 * C))
    params = HY.init(cfg, torch.Generator().manual_seed(3), "cpu")
    want = HY.forward(cfg, params, torch.from_numpy(toks))[:, -1].numpy()
    for n in (2, 4):
        plan = pp.build_plan(cfg, n, 4 * C, RunConfig(num_chunks=4, num_stages=n,
                                                      ssm_backend="cuda"))
        got = pp.prefill_pipeline(cfg, pp.stage_params(cfg, params, plan), toks, plan,
                                  device="cpu").numpy()
        rel = np.abs(got - want) / (np.abs(want) + 1e-3)
        assert rel.max() < 2e-3, (n, rel.max())


@pytest.mark.parametrize("arch", ARCHS)
def test_init_staged_zero_pads(arch):
    """``init_staged`` zeroes what ``stage_params`` pads: mamba2 layers past
    L; zamba2 groups past the tail pseudo-group and tail layers past
    tail_ssm_layers."""
    cfg = get_smoke_config(arch)
    plan = pp.build_plan(cfg, 4, 4 * C, RunConfig(num_chunks=4, num_stages=4))
    staged = init_staged(cfg, plan, torch.Generator().manual_seed(0), device="cpu")
    w = staged["stage_layers"]["in_proj"]
    a = staged["stage_layers"]["a_log"]
    assert a.dtype == torch.float32 and w.dtype == torch.bfloat16
    if arch == "mamba2-130m":
        flat = w.reshape(-1, *w.shape[2:])
        assert bool((flat[cfg.num_layers:] == 0).all()) and bool((flat[:cfg.num_layers] != 0).any())
    else:
        h = cfg.hybrid
        flat = w.reshape(-1, *w.shape[2:])
        assert flat.shape[0] == plan.num_stages * plan.layers_per_stage
        assert bool((flat[h.num_groups + 1:] == 0).all())
        assert bool((flat[h.num_groups, h.tail_ssm_layers:] == 0).all())
        assert bool((flat[h.num_groups, :h.tail_ssm_layers] != 0).any())
        assert set(staged["shared"]) >= {"wq", "wk", "wv", "wo", "wg", "wu", "wd"}


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_serves_like_direct_pipeline(arch):
    """``PrefillEngine`` + ``TorchExecutor`` on the CPU answer every request
    with the logits of ``prefill_pipeline`` on the same batch."""
    cfg = _cfg(arch)
    seq = M * C
    run = RunConfig(num_chunks=M, num_stages=N, remote_attn="fetch",
                    attn_backend="cuda", pool_backend="paged", ssm_backend="cuda")
    plan = pp.build_plan(cfg, N, seq, run)
    staged = init_staged(cfg, plan, torch.Generator().manual_seed(0), device="cpu")
    ex = TorchExecutor(cfg, staged, run, device="cpu")
    eng = PrefillEngine(EngineConfig(model=cfg, num_stages=N, tp=1, num_chunks=M,
                                     max_batch=2, buckets=(seq,),
                                     partition="uniform"), ex)
    for r in make_requests(4, seq, cfg.vocab_size, seed=2):
        eng.submit(r)
    eng.run_until_drained()
    assert len(eng.done) == 4 and len(ex.waves) == 2
    by_rid = {r.rid: r for r in eng.done}
    for wave in ex.waves:
        toks = np.stack([by_rid[i].tokens for i in wave["rids"]])
        direct = pp.prefill_pipeline(cfg, staged, toks, plan, device="cpu").numpy()
        for i, row in zip(wave["rids"], direct):
            np.testing.assert_array_equal(by_rid[i].result, row)
            assert np.isfinite(row).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_cpu(arch):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch, "--smoke",
           "--device", "cpu", "--requests", "2", "--seq", "128", "--num-chunks", "8",
           "--num-stages", "8", "--ssm-backend", "cuda", "--attn-backend", "cuda"]
    r = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert sum(line.startswith("request ") for line in r.stdout.splitlines()) == 2
    assert f"[serve] {arch}" in r.stdout and "ssm=cuda" in r.stdout
