"""The port's manual tensor-parallel lowering against the JAX reference's,
the other families' half: qwen2-moe-a2.7b (f-sharded experts and shared
experts), granite-moe-3b-a800m, mamba2-130m (nothing sharded), zamba2-7b
(the shared attention block sharded, its Mamba2 groups replicated) under
qship and fetch, and whisper-small (cross-attention psum after ``xwo``),
at the harness's N = 4 stages x tp = 2 (``tests/test_torch_tp_pipeline.py``
has the dense half and the bounds); then ``tests/test_perf_variants.py``'s
three cases: kv_split attention with query heads padded 6 -> 8 on a
(2 stages, kv 2, qg 2) layout, expert parallelism with experts padded
6 -> 8 on the same layout, and the padded router's mask; and
``ContinuousEngine`` + ``TorchExecutor`` serving at tp 2.

Each reference run is in one subprocess a group
(``tests/helpers/tp_reference.py families`` / ``variants``, 8 fake host
devices, ``RunConfig(tp_lowering="manual")``)."""
import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import RunConfig, get_smoke_config, replace
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.core import pipeline as pp
from repro_torch.core.staging import (TPLayout, init_staged, manual_tp_plan,
                                      shard_params)
from repro_torch.launch.serve import make_requests
from repro_torch.models import layers as L
from repro_torch.runtime.engine import ContinuousEngine, EngineConfig, TorchExecutor
from tests.helpers import tp_reference as ref
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_tp_pipeline import check_against, run_case

CASES = ref.GROUPS["families"]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return ref.run("families", tmp_path_factory.mktemp("tpref") / "families.npz")


@pytest.fixture(scope="module")
def variants(tmp_path_factory):
    return ref.run("variants", tmp_path_factory.mktemp("tpref") / "variants.npz")


RUNS = [(name, pool) for name in CASES for pool in ("torch", "cuda", "paged")]


@pytest.mark.parametrize("name,pool", RUNS)
def test_manual_tp_matches_reference(reference, name, pool):
    arch, mode, remote = CASES[name]
    cfg, plan, mtp, logits, led, tel = run_case(reference, name, arch, mode, remote, pool)
    if cfg.family == "ssm":
        assert not (mtp.attn or mtp.ffn) and mtp.kv_div == 1
    else:
        assert mtp.attn and mtp.ffn
    if cfg.moe is not None:
        assert mtp.moe_ffn and not mtp.moe_ep
        assert mtp.shared_moe == bool(cfg.moe.num_shared_experts)
    check_against(reference, name, logits, led, tel, launches=pool == "torch")
    assert (led["tp"] > 0) == (cfg.family != "ssm")   # ssm: nothing sharded, no psum


VARIANT_CFGS = {
    "pad_heads": ModelConfig(arch="padtest", family="dense", num_layers=2, d_model=48,
                             num_heads=6, num_kv_heads=2, d_ff=96, vocab_size=128,
                             head_dim=8, dtype="float32"),
    "ep": ModelConfig(arch="eptest", family="moe", num_layers=2, d_model=32,
                      num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=128,
                      head_dim=8, dtype="float32",
                      moe=MoEConfig(num_experts=6, top_k=2, d_expert=64,
                                    capacity_factor=8.0)),
}


@pytest.mark.parametrize("name", list(VARIANT_CFGS))
def test_kv_split_and_expert_parallel_match_reference(variants, name):
    """kv_split at tp 4 = (kv 2, qg 2): query heads padded 6 -> 8 (local 1
    kv head, G 2), or experts padded 6 -> 8 (2 a shard, EP); logits within
    2e-3 of the reference's pipeline and of its unpadded forward, every
    ledger key equal at rtol 1e-6."""
    cfg = VARIANT_CFGS[name]
    params = bridge.params_from_numpy(ref.unflatten(variants, name + "/param/"),
                                      device="cpu")
    if name == "pad_heads":
        assert pp.kv_split_axes(cfg, 4) == (2, 2, 4)
        cfg2, params2 = pp.pad_q_heads(cfg, params, 4)
        assert cfg2.num_heads == 8
    else:
        cfg2, params2 = pp.pad_experts(cfg, params, 8)
        assert cfg2.moe.num_experts == 8 and cfg2.moe.real_experts == 6
    layout = TPLayout(4, kv=2)
    run = RunConfig(num_chunks=ref.VARIANT_M, num_stages=ref.VARIANT_N)
    plan = pp.build_plan(cfg2, ref.VARIANT_N, ref.VARIANT_SEQ, run)
    mtp = manual_tp_plan(cfg2, plan, layout)
    assert mtp.kv_split and mtp.attn and mtp.kv_div == 2 and mtp.qg == 2
    assert mtp.moe_ep == (name == "ep") and not mtp.moe_ffn
    staged = shard_params(cfg2, pp.stage_params(cfg2, params2, plan), mtp)
    logits, led = pp.prefill_pipeline(cfg2, staged, variants[name + "/tokens"], plan,
                                      device="cpu", return_ledger=True, layout=layout)
    got = logits.numpy()
    for want in (variants[name + "/logits"], variants[name + "/forward"]):
        rel = np.abs(got - want) / (np.abs(want) + 1e-3)
        assert rel.max() < 2e-3, rel.max()
    for key, value in led.items():
        np.testing.assert_allclose(value, variants[f"{name}/ledger/{key}"],
                                   rtol=1e-6, err_msg=key)
    assert led["tp"] > 0


def test_padding_equals_reference_padding(variants):
    """``pad_q_heads`` and ``pad_experts`` give the reference's padded
    params leaf for leaf."""
    import jax.numpy as jnp
    from repro.configs import base as ref_base
    from repro.core import staging as ref_staging
    for name, pad in (("pad_heads", 4), ("ep", 8)):
        tree = ref.unflatten(variants, name + "/param/")
        rcfg = ref_base.ModelConfig(**{
            f: getattr(VARIANT_CFGS[name], f) for f in
            ("arch", "family", "num_layers", "d_model", "num_heads", "num_kv_heads",
             "d_ff", "vocab_size", "head_dim", "dtype")},
            moe=None if name == "pad_heads" else ref_base.MoEConfig(
                num_experts=6, top_k=2, d_expert=64, capacity_factor=8.0))
        rparams = {"layers": {k: jnp.asarray(v) for k, v in tree["layers"].items()}}
        fn = ref_staging.pad_q_heads if name == "pad_heads" else ref_staging.pad_experts
        _, want = fn(rcfg, rparams, pad)
        port_fn = pp.pad_q_heads if name == "pad_heads" else pp.pad_experts
        _, got = port_fn(VARIANT_CFGS[name],
                         bridge.params_from_numpy({"layers": tree["layers"]}, device="cpu"),
                         pad)
        for k, v in want["layers"].items():
            np.testing.assert_array_equal(got["layers"][k].numpy(), np.asarray(v), err_msg=k)


def test_padded_experts_are_never_routed():
    """The reference's padded-router case: padded experts with the HIGHEST
    raw router logits are masked, so the layer equals the real experts
    alone, and equals the reference's ``moe_layer`` on the same params;
    sharded for EP (2 experts a shard over 2 shards) its partials sum to
    the same output."""
    import jax.numpy as jnp
    from repro.models import layers as ref_layers
    d, e = 8, 4
    params = {"router": torch.ones((d, e)), "wg": torch.ones((e, d, 8)) * 0.1,
              "wu": torch.ones((e, d, 8)) * 0.1, "wd": torch.ones((e, 8, d)) * 0.1}
    x = torch.ones((1, 4, d))
    full = L.moe_layer(params, x, num_experts=e, top_k=2, capacity_factor=8.0,
                       num_real=2)
    only_real = L.moe_layer({k: (v[:, :2] if k == "router" else v[:2])
                             for k, v in params.items()}, x, num_experts=2, top_k=2,
                            capacity_factor=8.0)
    torch.testing.assert_close(full, only_real, atol=1e-6, rtol=0)
    want = ref_layers.moe_layer({k: jnp.asarray(v.numpy()) for k, v in params.items()},
                                jnp.asarray(x.numpy()), num_experts=e, top_k=2,
                                capacity_factor=8.0, num_real=2)
    np.testing.assert_allclose(full.numpy(), np.asarray(want), atol=1e-6)
    sharded = {"router": params["router"][None]}
    for k in ("wg", "wu", "wd"):
        sharded[k] = params[k].reshape(2, 2, *params[k].shape[1:])[None]
    part = L.moe_layer(sharded, x[None], num_experts=e, top_k=2, capacity_factor=8.0,
                       num_real=2, sharded=True, ep=True)
    assert part.shape == (1, 2, 1, 4, d)
    assert float(part[0, 1].abs().max()) == 0.0        # shard 1: padded experts only
    torch.testing.assert_close(part.sum(1)[0], full, atol=1e-6, rtol=0)


def test_continuous_engine_serves_at_tp2():
    """``ContinuousEngine`` + ``TorchExecutor`` at tp 2 (the reference's
    serve path runs tp 2): every request's logits equal a direct tp 2
    ``prefill_pipeline`` call on its wave, and the tp 1 engine's argmaxes
    and logits (fp32, max rel err < 2e-3), with the prefix cache on."""
    cfg = replace(get_smoke_config("qwen3-8b"), dtype="float32")
    n, m, seq = 8, 8, 128
    run = RunConfig(num_chunks=m, num_stages=n, remote_attn="fetch",
                    attn_backend="cuda", pool_backend="paged")
    plan = pp.build_plan(cfg, n, seq, run)
    staged = init_staged(cfg, plan, torch.Generator().manual_seed(0), device="cpu")
    layout = TPLayout(2)
    staged2 = shard_params(cfg, staged, manual_tp_plan(cfg, plan, layout))
    results = {}
    for tp, st in ((1, staged), (2, staged2)):
        ex = TorchExecutor(cfg, st, run, device="cpu", layout=TPLayout(tp))
        eng = ContinuousEngine(EngineConfig(model=cfg, num_stages=n, tp=tp, num_chunks=m,
                                            max_batch=2, buckets=(seq,),
                                            partition="uniform", prefix_cache="on"), ex)
        reqs = make_requests(4, seq, cfg.vocab_size, seed=5, shared_prefix=96)
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        done = {r.rid: r.result for r in eng.done}
        assert len(done) == 4 and sum(w["prefix_chunks"] > 0 for w in ex.waves) >= 1
        results[tp] = np.stack([done[i] for i in range(4)])
        if tp == 2:
            by_rid = {r.rid: r for r in reqs}
            wave = ex.waves[0]
            toks = np.stack([by_rid[i].tokens for i in wave["rids"]])
            direct = pp.prefill_pipeline(cfg, st, toks, plan, device="cpu",
                                         layout=layout).numpy()
            np.testing.assert_array_equal(np.stack([done[i] for i in wave["rids"]]),
                                          direct)
    got, want = results[2], results[1]
    assert (got.argmax(-1) == want.argmax(-1)).all()
    assert (np.abs(got - want) / (np.abs(want) + 1e-3)).max() < 2e-3


def test_serve_options_carry_tp_to_a_torch_cell():
    """``--tp`` / ``--tp-lowering`` land in ``ServeOptions``, survive its
    JSON round trip, and reach a torch cell: the executor's layout, the
    engine's tp and the plans' resolved lowering."""
    import argparse
    from repro_torch.launch.options import ServeOptions, add_serve_args, options_from_args
    from repro_torch.launch.serve import build
    ap = argparse.ArgumentParser()
    add_serve_args(ap)
    opts = options_from_args(ap.parse_args(["--tp", "2", "--tp-lowering", "auto",
                                            "--smoke", "--device", "cpu", "--seq", "128"]))
    assert (opts.tp, opts.tp_lowering) == (2, "auto")
    assert ServeOptions.from_json(opts.to_json()) == opts
    assert (ServeOptions().tp, ServeOptions().tp_lowering) == (1, "auto")
    _, engine, executor = build(opts)
    assert executor.layout == TPLayout(2) and engine.ec.tp == 2
    assert executor.plan_for(128, 8, 8).tp_lowering == "manual"
    assert executor.staged["stage_layers"]["wq"].shape[1] == 2
