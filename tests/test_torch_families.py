"""The port's other decoder families against the JAX reference on the CPU,
float32: the MoE layer (``repro_torch.models.layers.moe_layer``), the
forwards of the four smoke configs (granite-3-2b, stablelm-3b,
qwen2-moe-a2.7b, granite-moe-3b-a800m), their chunked-pipeline prefill
against the reference ``prefill_pipeline``, the MoE decode step, and the
cost model's MoE FLOPs.

Layer: the dispatch tables (choices, slot tokens, slot used) are equal
exactly and the slot weights within 1e-6 of each other (the router logits
and the softmax's exponential differ from XLA's in the last bit); y within
1e-5 of max|y|. Forward: max rel err < 2e-3 (denominator floor 1e-3).
Pipeline: the reference subprocess (8 fake host devices, deep geometry:
N = 8, tp = 1, M = 8 chunks of C = 16, B = 2) runs each case with the
``jnp`` attention backend and the config's own capacity (capacity is per
chunk in both pipelines, so the same pairs drop); the port runs it under
the ``torch``, ``cuda`` and ``paged`` pool backends (plain versions on the
CPU): logits at max rel err < 2e-3, every ledger key equal at rtol 1e-6."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_config
from repro.configs.base import get_smoke_config as ref_smoke
from repro.configs.base import replace as ref_replace
from repro.core import costmodel as ref_cm
from repro.models import layers as RL
from repro.models.api import build_model as ref_build
from repro_torch import bridge
from repro_torch.configs import RunConfig, get_config, get_smoke_config, replace
from repro_torch.core import costmodel as cm
from repro_torch.core import pipeline as pp
from repro_torch.models import layers as L
from repro_torch.models.api import build_model

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCHS = ("granite-3-2b", "stablelm-3b", "qwen2-moe-a2.7b", "granite-moe-3b-a800m")
MOE_ARCHS = ("qwen2-moe-a2.7b", "granite-moe-3b-a800m")
N, M, C, B = 8, 8, 16, 2
CASES = {   # name: (arch, mode, remote_attn); the reference's CASES plus mocap stablelm
    "granite-3-2b_mocap_qship": ("granite-3-2b", "mocap", "qship"),
    "qwen2-moe-a2.7b_mocap_qship": ("qwen2-moe-a2.7b", "mocap", "qship"),
    "granite-moe-3b-a800m_mocap_fetch": ("granite-moe-3b-a800m", "mocap", "fetch"),
    "stablelm-3b_terapipe_fetch": ("stablelm-3b", "terapipe", "fetch"),
    "stablelm-3b_mocap_qship": ("stablelm-3b", "mocap", "qship"),
}


# ------------------------------------------------------------------- layer

def _ref_moe(params, x, **kw):
    """The reference ``moe_layer`` on numpy inputs, eagerly, with its
    dispatch tables: (y, choices [B,S,k], tok, valid, w [B,E,cap]), taken
    from its ``jax.lax.top_k`` and its first ``jax.vmap`` (the dispatch)."""
    seen = {}
    real_vmap, real_topk = jax.vmap, jax.lax.top_k

    def vmap(fn, *a, **k):
        mapped = real_vmap(fn, *a, **k)

        def call(*args):
            out = mapped(*args)
            seen.setdefault("dispatch", out)
            return out
        return call

    def top_k(v, k):
        out = real_topk(v, k)
        seen["top_k"] = out
        return out

    jax.vmap, jax.lax.top_k = vmap, top_k
    try:
        y = RL.moe_layer({n: jnp.asarray(v) for n, v in params.items()}, jnp.asarray(x), **kw)
    finally:
        jax.vmap, jax.lax.top_k = real_vmap, real_topk
    _, tok, valid, w = seen["dispatch"]
    return (np.asarray(y), np.asarray(seen["top_k"][1]), np.asarray(tok), np.asarray(valid),
            np.asarray(w))


# (capacity factor, num_real, zero inputs, zero router): capacity that binds
# (1.0, 0.5: pairs drop), that does not (8.0), padded experts (num_real < E),
# all-zero inputs and a zero router (every logit ties)
MOE_CASES = {"binds": (1.0, 0, False, False), "binds_half": (0.5, 0, False, False),
             "free": (8.0, 0, False, False), "num_real": (1.5, 6, False, False),
             "zero_x": (1.0, 0, True, False), "zero_router": (1.25, 0, False, True)}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_layer_matches_reference(case):
    cf, num_real, zero_x, zero_router = MOE_CASES[case]
    b, s, d, e, k, f = 2, 16, 32, 8, 2, 24
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    p = {"router": rng.standard_normal((d, e)).astype(np.float32) * 0.3,
         "wg": rng.standard_normal((e, d, f)).astype(np.float32) * 0.1,
         "wu": rng.standard_normal((e, d, f)).astype(np.float32) * 0.1,
         "wd": rng.standard_normal((e, f, d)).astype(np.float32) * 0.1}
    if zero_x:
        x[:] = 0
    if zero_router:
        p["router"][:] = 0
    kw = dict(num_experts=e, top_k=k, capacity_factor=cf, num_real=num_real)
    y, choices, tok, valid, w = _ref_moe(p, x, **kw)
    tp = {n: torch.from_numpy(v) for n, v in p.items()}
    weights, got_choices = L.moe_route(torch.from_numpy(x), tp["router"], top_k=k,
                                       num_real=num_real)
    cap = L.moe_capacity(s, k, num_real or e, cf)
    assert cap == tok.shape[-1]
    got_tok, got_valid, got_w, pos = L.moe_dispatch(got_choices, weights, e, cap)
    np.testing.assert_array_equal(got_choices.numpy(), choices)
    np.testing.assert_array_equal(got_tok.numpy(), tok)
    np.testing.assert_array_equal(got_valid.numpy(), valid)
    np.testing.assert_allclose(got_w.numpy(), w, rtol=1e-6, atol=1e-7)
    dropped = int((pos >= e * cap).sum())
    assert dropped == choices.size - int(valid.sum())
    if case.startswith("binds"):
        assert dropped > 0
    if case == "free":
        assert dropped == 0
    if case == "num_real":
        assert int(got_choices.max()) < num_real
    if zero_x or zero_router:            # ties pick the lowest experts
        assert (got_choices.numpy() == np.arange(k)).all()
    got = L.moe_layer(tp, torch.from_numpy(x), **kw).numpy()
    assert np.abs(got - y).max() <= 1e-5 * max(np.abs(y).max(), 1e-30)


def test_moe_layer_stage_stacked_equals_per_stage():
    """x [G, B, S, d] with each group's own experts equals G unstacked
    calls (the pipeline's layout: one dispatch per (stage, row))."""
    g, b, s, d, e, k, f = 3, 2, 16, 32, 6, 2, 24
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((g, b, s, d), generator=gen)
    p = {"router": torch.randn((g, d, e), generator=gen),
         "wg": torch.randn((g, e, d, f), generator=gen) * 0.1,
         "wu": torch.randn((g, e, d, f), generator=gen) * 0.1,
         "wd": torch.randn((g, e, f, d), generator=gen) * 0.1}
    kw = dict(num_experts=e, top_k=k, capacity_factor=1.0)
    got = L.moe_layer(p, x, **kw)
    for i in range(g):
        one = L.moe_layer({n: w[i] for n, w in p.items()}, x[i], **kw)
        torch.testing.assert_close(got[i], one, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------- model

def _ref_params(rcfg):
    return jax.tree.map(np.asarray, ref_build(rcfg).init(jax.random.key(0)))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    """Whole-sequence forward of the smoke config, params through the
    bridge: last-position logits of every token, max rel err < 2e-3."""
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


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_steps_match_reference(arch):
    """Four decode steps from an empty cache (one token a row: capacity k,
    nothing drops) against the reference ``decode_step``: logits within
    2e-3 of max|logit| and the cache's k/v within 1e-5."""
    rcfg = ref_replace(ref_smoke(arch), dtype="float32")
    cfg = replace(get_smoke_config(arch), dtype="float32")
    tree = _ref_params(rcfg)
    rm, pm = ref_build(rcfg), build_model(cfg)
    jp = jax.tree.map(jnp.asarray, tree)
    params = bridge.params_from_numpy(tree, device="cpu")
    jcache, cache = rm.init_cache(2, 8), pm.init_cache(2, 8, device="cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 4)).astype(np.int32)
    for t in range(toks.shape[1]):
        jlogits, jcache = rm.decode_step(jp, jcache, jnp.asarray(toks[:, t]))
        logits, cache = pm.decode_step(params, cache, torch.from_numpy(toks[:, t]))
        want = np.asarray(jlogits, np.float32)
        assert np.abs(logits.numpy() - want).max() <= 2e-3 * np.abs(want).max()
        for key in ("k", "v"):
            w = np.asarray(jcache[key], np.float32)
            assert np.abs(cache[key].numpy() - w).max() <= 1e-5 * max(np.abs(w).max(), 1e-30)
        assert cache["pos"].tolist() == [t + 1] * 2


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    """full_config and smoke_config field for field, the parameter count,
    and the cost model's per-layer FLOPs (MoE: routed top-k + shared +
    router) at rtol 1e-12."""
    for full in (True, False):
        cfg = get_config(arch) if full else get_smoke_config(arch)
        rcfg = ref_config(arch) if full else ref_smoke(arch)
        for field in cfg.__dataclass_fields__:
            want = getattr(rcfg, field)
            got = getattr(cfg, field)
            if field == "moe" and want is not None:
                assert {k: getattr(got, k) for k in got.__dataclass_fields__} == \
                    {k: getattr(want, k) for k in got.__dataclass_fields__}
                assert got.real_experts == want.real_experts
            else:
                assert got == want, (field, got, want)
        assert cfg.param_count() == rcfg.param_count()
        np.testing.assert_allclose(cm.layer_linear_flops_per_token(cfg),
                                   ref_cm.layer_linear_flops_per_token(rcfg), rtol=1e-12)
        sm, rsm = cm.StageModel.build(cfg, 8, 1), ref_cm.StageModel.build(rcfg, 8, 1)
        np.testing.assert_allclose(sm.layers, rsm.layers, rtol=1e-12)
        np.testing.assert_allclose(sm.attn_layers, rsm.attn_layers, rtol=1e-12)


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
    run = RunConfig(num_chunks=M, num_stages=N, mbkr=mode == "mocap", remote_attn=remote,
                    attn_backend="torch" if pool_backend == "torch" else "cuda",
                    pool_backend=pool_backend)
    plan = pp.build_plan(cfg, N, M * C, run, mode=mode)
    assert plan.p2 == (6 if mode == "mocap" else M)
    params = bridge.params_from_numpy(_unflatten(reference, arch + "/param/"), device="cpu")
    staged = pp.stage_params(cfg, params, plan)
    if cfg.moe is not None:
        assert staged["stage_layers"]["e_wg"].shape[:3] == (N, plan.layers_per_stage,
                                                            cfg.moe.num_experts)
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
    if mode == "mocap":
        assert led["spill"] > 0 and led[{"qship": "qship_q", "fetch": "fetch"}[remote]] > 0
