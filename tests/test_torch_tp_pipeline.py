"""The port's manual tensor-parallel lowering (``repro_torch.core.staging.
ManualTP`` and the tp axis of ``core.pipeline.prefill_pipeline``) against
the JAX reference's manual lowering, dense-family half: qwen3-8b under
mocap qship / fetch, terapipe and GPipe, granite-3-2b, llava-next-34b's
splice and stablelm-3b (``tests/test_pipeline.py``'s cases), plus
qwen3-14b, whose smoke config's single kv head leaves its attention
replicated at tp 2 (the unsharded-group path).

One subprocess (``tests/helpers/tp_reference.py dense``, 8 fake host
devices) runs the reference at the harness's geometry, N = 4 stages x
tp = 2, M = 8 chunks of C = 16, B = 2, fp32 smoke configs, passing
``RunConfig(tp_lowering="manual")`` so that it takes the manual lowering
whatever the jaxlib. The port runs the same params (bridged, then
``shard_params``) on the CPU under the ``torch`` pool backend and the
``cuda`` and ``paged`` ones (the kernels' plain versions here).

Bounds: logits max rel err < 2e-3; every ledger key, ``tp`` included,
equal at rtol 1e-6; the stage telemetry's counts equal exactly and
``attn_work`` / ``kv_bytes`` at rtol 1e-6 (``launches`` with the torch
backend only: a kernel launch serves every stage). Also here:
``manual_tp_plan`` and ``kv_split_axes`` against the reference's over the
fourteen configs x tp in {1, 2, 4, 8, 16} x {plain, kv_split}."""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import RunConfig, get_config, get_smoke_config, list_archs, replace
from repro_torch.core import pipeline as pp
from repro_torch.core.staging import TPLayout, manual_tp_plan, shard_params
from repro_torch.obs import telemetry as obs_t
from tests.helpers import tp_reference as ref
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401

EXACT = ("own_chunks", "hosted_chunks", "spill_events", "fetch_events",
         "qship_events", "launches", "prefix_hit")
CASES = ref.GROUPS["dense"]
LAYOUT = TPLayout(ref.TP)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return ref.run("dense", tmp_path_factory.mktemp("tpref") / "dense.npz")


def port_cfg(arch: str):
    cfg = replace(get_smoke_config(arch), dtype="float32")
    if cfg.moe is not None:
        cfg = replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    return cfg


def run_case(reference, name, arch, mode, remote, pool):
    """The port's tp = 2 run of one reference case: (cfg, plan, mtp,
    logits, ledger or None, telemetry)."""
    cfg = port_cfg(arch)
    gp = mode == "gpipe"
    attn = "torch" if pool == "torch" else "cuda"
    run = RunConfig(num_chunks=ref.GP_M if gp else ref.M, num_stages=ref.N,
                    mbkr=mode == "mocap", remote_attn=remote, attn_backend=attn,
                    pool_backend="torch" if gp else pool, ssm_backend=attn,
                    tp_lowering="manual")
    plan = pp.build_plan(cfg, ref.N, ref.M * ref.C, run, mode=mode)
    mtp = manual_tp_plan(cfg, plan, LAYOUT)
    params = bridge.params_from_numpy(ref.unflatten(reference, arch + "/param/"),
                                      device="cpu")
    staged = shard_params(cfg, pp.stage_params(cfg, params, plan), mtp)
    kw = {}
    if name + "/embeds" in reference:
        kw["embeds"] = torch.as_tensor(reference[name + "/embeds"])
    out = pp.prefill_pipeline(cfg, staged, reference[name + "/tokens"], plan,
                              device="cpu", return_ledger=not gp,
                              return_telemetry=True, layout=LAYOUT, **kw)
    led = None if gp else out[1]
    return cfg, plan, mtp, out[0].numpy(), led, out[-1]


def check_against(reference, name, logits, led, tel, launches: bool):
    want = reference[name + "/logits"]
    assert logits.shape == want.shape and np.isfinite(logits).all()
    rel = np.abs(logits - want) / (np.abs(want) + 1e-3)
    assert rel.max() < 2e-3, rel.max()
    if led is not None:
        assert set(led) == {k[len(name + "/ledger/"):] for k in reference
                            if k.startswith(name + "/ledger/")}
        for key, value in led.items():
            np.testing.assert_allclose(value, reference[f"{name}/ledger/{key}"],
                                       rtol=1e-6, err_msg=key)
    for key in obs_t.TELEM_KEYS:
        if key == "launches" and not launches:
            continue
        got, want = tel[key], reference[f"{name}/tel/{key}"]
        assert got.shape == want.shape, key
        if key in EXACT:
            np.testing.assert_array_equal(got, want, err_msg=key)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=key)


RUNS = [(name, pool) for name, (_, mode, _) in CASES.items()
        for pool in (("torch", "cuda") if mode == "gpipe" else ("torch", "cuda", "paged"))]


@pytest.mark.parametrize("name,pool", RUNS)
def test_manual_tp_matches_reference(reference, name, pool):
    arch, mode, remote = CASES[name]
    cfg, plan, mtp, logits, led, tel = run_case(reference, name, arch, mode, remote, pool)
    assert mtp is not None and mtp.tp == ref.TP
    # qwen3-14b's smoke config has one kv head: attention replicates at tp 2
    assert mtp.attn == (cfg.num_kv_heads % ref.TP == 0) and mtp.ffn
    check_against(reference, name, logits, led, tel, launches=pool == "torch")
    assert led is None or led["tp"] > 0


def test_tp_ledger_is_the_psums_closed_form(reference):
    """The ``tp`` key of a dense run: per active (stage, phase), one psum
    after each layer's o-projection and one after its FFN, each
    2(k-1)/k of the [B, C, d] partial on each of the stage's k chips."""
    name = "qwen3-8b_mocap_qship"
    cfg, plan, _, _, led, _ = run_case(reference, name, *CASES[name], "torch")
    k = ref.TP
    per = 2.0 * (k - 1) / k * ref.B * ref.C * cfg.d_model * 4 * k
    assert led["tp"] == pytest.approx(
        plan.num_stages * plan.num_chunks * plan.layers_per_stage * 2 * per, rel=1e-12)


def _reference_topo(layout: TPLayout):
    """A duck-typed reference ``Topology`` (what ``manual_tp_plan`` reads)."""
    if layout.kv_split:
        return types.SimpleNamespace(
            tp_size=layout.tp, tp_axis=("kv", "qg"),
            mesh=types.SimpleNamespace(shape={"kv": layout.kv, "qg": layout.qg}))
    return types.SimpleNamespace(tp_size=layout.tp, tp_axis="model",
                                 mesh=types.SimpleNamespace(shape={"model": layout.tp}))


@pytest.mark.parametrize("arch", list_archs())
def test_manual_tp_plan_matches_reference_grid(arch):
    """The port's decisions equal the reference's for every registered
    config (unpadded, and with its query heads padded for the kv_split
    view) at tp 1, 2, 4, 8, 16, on the plain TP axis and the kv_split
    view, and ``kv_split_axes`` equals the reference's."""
    from repro.configs.base import RunConfig as RefRun
    from repro.configs.base import get_config as ref_get_config
    from repro.configs.base import replace as ref_replace
    from repro.core import staging as ref_staging
    ref_plan = types.SimpleNamespace(tp_lowering="manual")
    plan = pp.build_plan(get_config(arch), 8, 8 * 512,
                         RunConfig(num_chunks=8, num_stages=8, tp_lowering="auto"))
    assert plan.tp_lowering == "manual"
    fields = ("tp", "attn", "kv_div", "ffn", "moe_ffn", "moe_ep", "shared_moe")
    for tp in (1, 2, 4, 8, 16):
        cfg, rcfg = get_config(arch), ref_get_config(arch)
        axes = pp.kv_split_axes(cfg, tp)
        assert axes == ref_staging.kv_split_axes(rcfg, tp)
        layouts = [TPLayout(tp)]
        if axes is not None:
            layouts.append(TPLayout(tp, kv=axes[0]))
        for layout in layouts:
            pairs = [(cfg, rcfg)]
            if layout.kv_split and axes[2] * cfg.num_kv_heads != cfg.num_heads:
                pairs.append((replace(cfg, num_heads=cfg.num_kv_heads * axes[2]),
                              ref_replace(rcfg, num_heads=rcfg.num_kv_heads * axes[2])))
            for c, rc in pairs:
                got = manual_tp_plan(c, plan, layout)
                want = ref_staging.manual_tp_plan(rc, ref_plan, _reference_topo(layout))
                if want is None:
                    assert got is None and tp == 1
                    continue
                assert tuple(getattr(got, f) for f in fields) == \
                    tuple(getattr(want, f) for f in fields), (arch, tp, layout)
                assert got.kv_split == layout.kv_split == (len(want.axes) == 2)
    assert RefRun().tp_lowering == RunConfig().tp_lowering == "auto"
