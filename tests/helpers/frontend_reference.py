"""Subprocess worker: the JAX reference's runs of one frontend arch
(llava-next-34b's patch-embedding splice or whisper-small's encoder-decoder)
at the smoke size in fp32, written to an ``.npz`` for the port's tests
(``tests/test_torch_frontends.py``, ``tests/test_torch_encdec.py``). Run
with XLA_FLAGS=--xla_force_host_platform_device_count=8.

Usage: python tests/helpers/frontend_reference.py <arch> <out.npz>
(``run(arch, path)`` starts it and loads what it wrote).

The front is ``N_FRONT = 2 C + 5`` embeddings (deliberately not a whole
number of chunks, as in ``tests/helpers/pipeline_check.py``): patch
embeddings in front of ``M C - N_FRONT`` tokens (vlm) or the encoder's
frames before ``M C`` decoder tokens (encdec). Written: the params, tokens
and embeds; the forward's logits (and, encdec, the encoder output and the
forward's cache); ``prefill_pipeline`` under mocap for every case of
``CASES`` (N stages, remote attention) with its ledger and telemetry; and
``DECODE_STEPS`` decode steps from the forward's cache of the first
``DECODE_PROMPT`` tokens (the KV axis padded by ``DECODE_PAD``)."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro import compat
from repro.compat import AxisType
from repro.configs.base import RunConfig, get_smoke_config, replace
from repro.core import pipeline as pp
from repro.core import transport as tx
from repro.models.api import build_model
from repro.models.topology import Topology

M, C, B = 8, 16, 2
N_FRONT = 2 * C + 5
CASES = {f"n{n}_{remote}": (n, remote) for n in (8, 4) for remote in ("qship", "fetch")}
DECODE_PROMPT, DECODE_PAD, DECODE_STEPS = 16, 8, 4


def main(arch: str, path: str) -> None:
    cfg = replace(get_smoke_config(arch), dtype="float32")
    model = build_model(cfg)
    params = model.init(jax.random.key(0))
    toks = jax.random.randint(jax.random.key(1), (B, M * C), 0, cfg.vocab_size)
    emb = jax.random.normal(jax.random.key(2), (B, N_FRONT, cfg.d_model),
                            jnp.float32) * 0.02
    if cfg.family == "vlm":
        toks = toks[:, : M * C - N_FRONT]
    out = {"tokens": np.asarray(toks), "embeds": np.asarray(emb)}
    for p, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        out["param/" + "/".join(str(k.key) for k in p)] = np.asarray(leaf)
    out["forward"] = np.asarray(model.forward(params, toks, embeds=emb), np.float32)
    if cfg.family == "encdec":
        from repro.models import whisper as W
        out["encode"] = np.asarray(W.encode(cfg, params, emb), np.float32)
        _, cache = model.forward(params, toks, embeds=emb, return_cache=True)
        for k, v in cache.items():
            out["cache/" + k] = np.asarray(v)

    for name, (n, remote) in CASES.items():
        mesh = compat.make_mesh((n, 1), ("data", "model"),
                                axis_types=(AxisType.Auto,) * 2,
                                devices=jax.devices()[:n])
        topo = Topology(mesh=mesh)
        run = RunConfig(num_chunks=M, num_stages=n, mbkr=True, remote_attn=remote,
                        attn_backend="jnp")
        plan = pp.build_plan(cfg, n, M * C, run, mode="mocap")
        staged = pp.stage_params(cfg, params, plan)
        with compat.set_mesh(mesh):
            logits, led, tel = jax.jit(lambda st, tk, e: pp.prefill_pipeline(
                cfg, st, tk, plan, topo, embeds=e, return_ledger=True,
                return_telemetry=True))(staged, toks, emb)
        out[name + "/logits"] = np.asarray(logits, np.float32)
        for k, v in tx.ledger_to_dict(led).items():
            out[name + "/ledger/" + k] = np.float64(v)
        for k, v in tel.items():
            out[name + "/tel/" + k] = np.asarray(v, np.float64)

    # decode: the forward's cache of the prompt (front included), then steps
    _, cache = model.forward(params, toks[:, :DECODE_PROMPT], embeds=emb,
                             return_cache=True)
    pad = ((0, 0), (0, 0), (0, DECODE_PAD), (0, 0), (0, 0))
    cache = {k: (jnp.pad(v, pad) if k in ("k", "v") else v) for k, v in cache.items()}
    for k, v in cache.items():
        out["decode/cache0/" + k] = np.asarray(v)
    for t in range(DECODE_STEPS):
        logits, cache = model.decode_step(params, cache, toks[:, DECODE_PROMPT + t])
        out[f"decode/logits{t}"] = np.asarray(logits, np.float32)
    for k, v in cache.items():
        out["decode/cache/" + k] = np.asarray(v)
    np.savez(path, **out)
    print("DONE")


def run(arch: str, path) -> dict:
    """Runs the worker for ``arch`` in a subprocess (8 fake host devices)
    and returns what it wrote, {key: numpy array}."""
    root = os.path.join(os.path.dirname(__file__), "..", "..")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(root, "src")
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, __file__, arch, str(path)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and "DONE" in r.stdout, r.stdout + r.stderr
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


if __name__ == "__main__":
    main(*sys.argv[1:])
