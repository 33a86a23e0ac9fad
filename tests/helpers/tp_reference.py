"""Subprocess worker: the JAX reference's runs under its MANUAL tensor-parallel
lowering (``RunConfig(tp_lowering="manual")``: explicit transport psums,
every mesh axis manual) at the pipeline harness's size, written to an
``.npz`` for the port's tests (``tests/test_torch_tp*.py``). Run with
XLA_FLAGS=--xla_force_host_platform_device_count=8.

Usage: python tests/helpers/tp_reference.py <group> <out.npz>
(``run(group, path)`` starts it and loads what it wrote).

Groups:
- ``dense`` / ``families``: cases of ``tests/test_pipeline.py`` (the
  reference's 13 pipeline cases, split in two) on the harness's mesh of
  N = 4 stages x tp = 2 (``tests/helpers/pipeline_check.py``: fp32 smoke
  configs, M = 8 chunks of C = 16, B = 2; GPipe B = 8 over M = 4
  microbatches; MoE capacity factor 8; a front of 2 C + 5 embeddings for
  the vlm and encdec), plus (``dense``) qwen3-14b, whose single kv head at
  the smoke size leaves its attention replicated at tp 2. Written per
  case: the params, tokens and embeds, the logits, the CollectiveLedger
  (not GPipe's) and the stage telemetry.
- ``variants``: ``tests/test_perf_variants.py``'s two lowerings on a
  (2 stages, kv 2, qg 2) mesh: kv_split attention with query heads padded
  6 -> 8, and expert parallelism with experts padded 6 -> 8; their
  forward's last-token logits, the pipeline's logits and ledger.
"""
import os
import subprocess
import sys

import numpy as np

M, C, B = 8, 16, 2
N, TP = 4, 2
GP_M, GP_B = 4, 8
N_FRONT = 2 * C + 5
GROUPS = {   # name: (arch, mode, remote_attn)
    "dense": {
        "qwen3-8b_mocap_qship": ("qwen3-8b", "mocap", "qship"),
        "qwen3-8b_mocap_fetch": ("qwen3-8b", "mocap", "fetch"),
        "qwen3-8b_terapipe_qship": ("qwen3-8b", "terapipe", "qship"),
        "qwen3-8b_gpipe": ("qwen3-8b", "gpipe", "qship"),
        "granite-3-2b_mocap_qship": ("granite-3-2b", "mocap", "qship"),
        "llava-next-34b_mocap_qship": ("llava-next-34b", "mocap", "qship"),
        "stablelm-3b_terapipe_fetch": ("stablelm-3b", "terapipe", "fetch"),
        "qwen3-14b_mocap_qship": ("qwen3-14b", "mocap", "qship"),
    },
    "families": {
        "qwen2-moe-a2.7b_mocap_qship": ("qwen2-moe-a2.7b", "mocap", "qship"),
        "granite-moe-3b-a800m_mocap_fetch": ("granite-moe-3b-a800m", "mocap", "fetch"),
        "mamba2-130m_terapipe_qship": ("mamba2-130m", "terapipe", "qship"),
        "zamba2-7b_mocap_qship": ("zamba2-7b", "mocap", "qship"),
        "zamba2-7b_mocap_fetch": ("zamba2-7b", "mocap", "fetch"),
        "whisper-small_mocap_qship": ("whisper-small", "mocap", "qship"),
    },
}
VARIANT_SEQ, VARIANT_N, VARIANT_M = 64, 2, 8


def smoke_cfg(arch: str):
    """The harness's config: the fp32 smoke config, MoE without drops."""
    import dataclasses
    from repro.configs.base import get_smoke_config, replace
    cfg = replace(get_smoke_config(arch), dtype="float32")
    if cfg.moe is not None:
        cfg = replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    return cfg


def variant_cfgs():
    """test_perf_variants.py's two configs (reference ModelConfigs)."""
    from repro.configs.base import ModelConfig, MoEConfig
    pad = ModelConfig(arch="padtest", family="dense", num_layers=2, d_model=48,
                      num_heads=6, num_kv_heads=2, d_ff=96, vocab_size=128,
                      head_dim=8, dtype="float32")
    ep = ModelConfig(arch="eptest", family="moe", num_layers=2, d_model=32,
                     num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=128,
                     head_dim=8, dtype="float32",
                     moe=MoEConfig(num_experts=6, top_k=2, d_expert=64,
                                   capacity_factor=8.0))
    return {"pad_heads": pad, "ep": ep}


def _save_tree(out, prefix, tree):
    import jax
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/".join(str(k.key) for k in path)] = np.asarray(leaf)


def _pipeline_cases(cases, out):
    import jax
    import jax.numpy as jnp
    from repro import compat
    from repro.compat import AxisType
    from repro.configs.base import RunConfig
    from repro.core import pipeline as pp
    from repro.core import transport as tx
    from repro.models.api import build_model
    from repro.models.topology import Topology

    mesh = compat.make_mesh((N, TP), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    topo = Topology(mesh=mesh)
    done = set()
    for name, (arch, mode, remote) in cases.items():
        cfg = smoke_cfg(arch)
        params = build_model(cfg).init(jax.random.key(0))
        if arch not in done:
            _save_tree(out, arch + "/param/", params)
            done.add(arch)
        b, m = (GP_B, GP_M) if mode == "gpipe" else (B, M)
        toks = jax.random.randint(jax.random.key(1), (b, M * C), 0, cfg.vocab_size)
        kw = {}
        if cfg.family in ("vlm", "encdec"):
            kw["embeds"] = jax.random.normal(jax.random.key(2), (b, N_FRONT, cfg.d_model),
                                             jnp.float32) * 0.02
            if cfg.family == "vlm":
                toks = toks[:, : M * C - N_FRONT]
            out[name + "/embeds"] = np.asarray(kw["embeds"])
        out[name + "/tokens"] = np.asarray(toks)
        run = RunConfig(num_chunks=m, num_stages=N, mbkr=mode == "mocap",
                        remote_attn=remote, attn_backend="jnp", ssm_backend="jnp",
                        tp_lowering="manual")
        plan = pp.build_plan(cfg, N, M * C, run, mode=mode)
        assert plan.tp_lowering == "manual"
        staged = pp.stage_params(cfg, params, plan)
        gp = mode == "gpipe"
        with compat.set_mesh(mesh):
            res = jax.jit(lambda st, tk, **k: pp.prefill_pipeline(
                cfg, st, tk, plan, topo, return_ledger=not gp, return_telemetry=True,
                **k))(staged, toks, **kw)
        out[name + "/logits"] = np.asarray(res[0], np.float32)
        if not gp:
            for k, v in tx.ledger_to_dict(res[1]).items():
                out[name + "/ledger/" + k] = np.float64(v)
        for k, v in res[-1].items():
            out[name + "/tel/" + k] = np.asarray(v, np.float64)


def _variants(out):
    import jax
    from repro import compat
    from repro.compat import AxisType
    from repro.configs.base import RunConfig
    from repro.core import pipeline as pp
    from repro.core import transport as tx
    from repro.models.api import build_model
    from repro.models.topology import Topology

    mesh = compat.make_mesh((VARIANT_N, 2, 2), ("data", "kv", "qg"),
                            axis_types=(AxisType.Auto,) * 3)
    topo = Topology(mesh=mesh, tp_axis=("kv", "qg"))
    for name, cfg in variant_cfgs().items():
        model = build_model(cfg)
        params = model.init(jax.random.key(0))
        _save_tree(out, name + "/param/", params)
        toks = jax.random.randint(jax.random.key(1), (B, VARIANT_SEQ), 0, 128)
        out[name + "/tokens"] = np.asarray(toks)
        out[name + "/forward"] = np.asarray(model.forward(params, toks)[:, -1, :], np.float32)
        if name == "pad_heads":
            kv_ax, qg_ax, g_pad = pp.kv_split_axes(cfg, 4)
            cfg2, params2 = pp.pad_q_heads(cfg, params, g_pad)
        else:
            cfg2, params2 = pp.pad_experts(cfg, params, 8)
        run = RunConfig(num_chunks=VARIANT_M, num_stages=VARIANT_N, tp_lowering="manual")
        plan = pp.build_plan(cfg2, VARIANT_N, VARIANT_SEQ, run)
        staged = pp.stage_params(cfg2, params2, plan)
        with compat.set_mesh(mesh):
            logits, led = jax.jit(lambda st, tk: pp.prefill_pipeline(
                cfg2, st, tk, plan, topo, return_ledger=True))(staged, toks)
        out[name + "/logits"] = np.asarray(logits, np.float32)
        for k, v in tx.ledger_to_dict(led).items():
            out[name + "/ledger/" + k] = np.float64(v)


def main(group: str, path: str) -> None:
    out = {}
    if group == "variants":
        _variants(out)
    else:
        _pipeline_cases(GROUPS[group], out)
    np.savez(path, **out)
    print("DONE")


def run(group: str, path) -> dict:
    """Run this worker for ``group`` in a subprocess with 8 fake host
    devices; the arrays it wrote."""
    root = os.path.join(os.path.dirname(__file__), "..", "..")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(root, "src") + os.pathsep + root
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, os.path.abspath(__file__), group, str(path)],
                       env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0 and "DONE" in r.stdout, r.stdout + r.stderr
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def unflatten(flat: dict, prefix: str) -> dict:
    """The nested dict under ``prefix`` of a flat ``path/to/leaf`` dict."""
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


if __name__ == "__main__":
    main(*sys.argv[1:])
