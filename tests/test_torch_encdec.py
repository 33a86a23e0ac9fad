"""whisper-small, the encdec family (a bidirectional encoder over stub frame
embeddings, a decoder with cross-attention), in the port against the JAX
reference on the CPU:

- the configs, full and smoke, field for field, and ``param_count``;
- ``whisper.encode`` and ``Model.forward`` (every position) against the
  reference's, and ``forward(return_cache=True)`` leaf for leaf (k, v, xk,
  xv, pos): max rel err < 2e-3 (denominator floor 1e-3);
- ``prefill_pipeline(embeds=)`` against the reference pipeline and its
  forward, ``2 C + 5`` frames (not a whole number of chunks), mocap under
  qship and fetch at N = 8 (deep) and N = 4, under the ``torch``, ``cuda``
  and ``paged`` pools (plain versions on the CPU): logits at max rel err <
  2e-3, the ledger and the telemetry equal (``frontend_checks``; the
  cross-attention charges one ``launches`` a layer, as the reference);
  one reference subprocess (``tests/helpers/frontend_reference.py``) runs
  every case;
- the routes: the encoder's and the prefill cross-attention's attention
  go through ``ops.full_attention`` (K1 non-causal) under the ``cuda``
  backend, and ``decode_step``'s self- and cross-attention through
  ``ops.decode_attention`` (K5), counted by a timed launch frame;
- each backend's ``full_block`` (that non-causal attention) against the
  reference's unmasked ``naive_attention``;
- ``decode_step`` against the reference's over 4 steps;
- ``TorchExecutor`` and the serve CLI refuse it (no frame embeddings), as
  the reference's ``JaxExecutor`` cannot run it."""
from collections import Counter

import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_config
from repro.configs.base import get_smoke_config as ref_smoke
from repro_torch.configs import RunConfig, get_config, get_smoke_config
from repro_torch.core import pipeline as pp
from repro_torch.core.staging import init_staged
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import whisper as W
from repro_torch.models.api import build_model
from repro_torch.runtime.engine import TorchExecutor
from tests.helpers import frontend_checks as fc
from tests.helpers import frontend_reference as fr
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401

ARCH = "whisper-small"


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return fr.run(ARCH, tmp_path_factory.mktemp("ref") / "ref.npz")


@pytest.mark.parametrize("full", [True, False], ids=["full", "smoke"])
def test_config_matches_reference(full):
    cfg = get_config(ARCH) if full else get_smoke_config(ARCH)
    rcfg = ref_config(ARCH) if full else ref_smoke(ARCH)
    assert set(cfg.__dataclass_fields__) == set(rcfg.__dataclass_fields__)
    for field in cfg.__dataclass_fields__:
        got, want = getattr(cfg, field), getattr(rcfg, field)
        if field in ("frontend", "encdec"):
            names = got.__dataclass_fields__
            assert {k: getattr(got, k) for k in names} == {k: getattr(want, k) for k in names}
            assert set(names) == set(want.__dataclass_fields__)
        else:
            assert got == want, (field, got, want)
    assert cfg.param_count() == rcfg.param_count()
    if full:
        assert (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim) == (12, 12, 64)


def test_encode_and_forward_match_reference(reference):
    cfg = fc.smoke(ARCH)
    prm = fc.params(reference)
    emb = torch.from_numpy(reference["embeds"])
    enc = W.encode(cfg, prm, emb).numpy()
    assert enc.shape == reference["encode"].shape == (fr.B, fr.N_FRONT, cfg.d_model)
    assert fc.rel_err(enc, reference["encode"]) < 2e-3
    logits, cache = build_model(cfg).forward(prm, torch.from_numpy(reference["tokens"]),
                                             embeds=emb, return_cache=True)
    assert logits.shape == reference["forward"].shape
    assert fc.rel_err(logits.numpy(), reference["forward"]) < 2e-3
    want = fc.unflatten(reference, "cache/")
    assert set(cache) == set(want) == {"k", "v", "xk", "xv", "pos"}
    for key, w in want.items():
        assert tuple(cache[key].shape) == w.shape, key
        if key == "pos":
            assert cache[key].tolist() == w.tolist()
        else:
            assert fc.rel_err(cache[key].numpy(), w) < 2e-3, key
    with pytest.raises(ValueError, match="frame embeddings"):
        W.forward(cfg, prm, torch.from_numpy(reference["tokens"]))


@pytest.mark.parametrize("pool", fc.POOLS)
@pytest.mark.parametrize("case", list(fr.CASES))
def test_pipeline_matches_reference(reference, case, pool):
    fc.check_pipeline(reference, ARCH, case, pool,
                      encoder_launches=get_smoke_config(ARCH).encdec.enc_layers)


def test_cross_kv_layout_is_read_in_place(reference):
    """``stage_cross_kv``: [N, lps, B, F, KVH, D] on the stage axis, each
    layer's slice one contiguous block (the kernel's input, no copy), equal
    to each stage's own projection of the encoder output."""
    cfg = fc.smoke(ARCH)
    run = RunConfig(num_chunks=fr.M, num_stages=4)
    plan = pp.build_plan(cfg, 4, fr.M * fr.C, run)
    staged = pp.stage_params(cfg, fc.params(reference), plan)
    enc = torch.from_numpy(reference["encode"])
    xk, xv = pp.stage_cross_kv(cfg, staged["stage_layers"], enc)
    n, lps = 4, plan.layers_per_stage
    assert xk.shape == (n, lps, fr.B, fr.N_FRONT, cfg.num_kv_heads, cfg.resolved_head_dim)
    for li in range(lps):
        assert xk[:, li].is_contiguous() and xv[:, li].is_contiguous()
        for s in range(n):
            lp = {k: w[s, li] for k, w in staged["stage_layers"].items()}
            want = W.cross_kv(cfg, lp, enc)
            assert torch.equal(xk[s, li], want[0]) and torch.equal(xv[s, li], want[1])


def test_kernel_routes():
    """Under the ``cuda`` backend the encoder's layers and the prefill's
    cross-attention call ``ops.chunk_attention`` non-causally (through
    ``ops.full_attention``), one call per encoder layer and one per
    (layer, tick); the ``torch`` backend calls no kernel wrapper for them.
    ``decode_step`` calls ``ops.decode_attention`` twice a layer (self,
    cross) and nothing else."""
    cfg = fc.smoke(ARCH)
    m = build_model(cfg)
    n = 4
    gen = torch.Generator().manual_seed(0)
    front = torch.randn(fr.B, fr.N_FRONT, cfg.d_model, generator=gen) * 0.02
    toks = torch.randint(0, cfg.vocab_size, (fr.B, fr.M * fr.C), generator=gen)
    full_calls = []
    real = ops.full_attention

    def spy(q, k, v, **kw):
        full_calls.append((tuple(q.shape), tuple(k.shape)))
        return real(q, k, v, **kw)
    for backend in ("torch", "cuda"):
        run = RunConfig(num_chunks=fr.M, num_stages=n, attn_backend=backend)
        plan = pp.build_plan(cfg, n, fr.M * fr.C, run)
        staged = init_staged(cfg, plan, torch.Generator().manual_seed(1), device="cpu")
        full_calls.clear()
        ops.full_attention = spy
        try:
            pp.prefill_pipeline(cfg, staged, toks, plan, device="cpu", embeds=front)
        finally:
            ops.full_attention = real
        if backend == "torch":
            assert full_calls == []
            continue
        enc = cfg.encdec.enc_layers
        lps = plan.layers_per_stage
        shapes = Counter(full_calls)
        assert shapes[((fr.B, fr.N_FRONT, cfg.num_heads, cfg.resolved_head_dim),
                       (fr.B, fr.N_FRONT, cfg.num_kv_heads, cfg.resolved_head_dim))] == enc
        assert shapes[((n * fr.B, fr.C, cfg.num_heads, cfg.resolved_head_dim),
                       (n * fr.B, fr.N_FRONT, cfg.num_kv_heads,
                        cfg.resolved_head_dim))] == lps * plan.num_ticks
        assert len(full_calls) == enc + lps * plan.num_ticks
    prm = m.init(torch.Generator().manual_seed(2), device="cpu")
    _, cache = m.forward(prm, toks[:, :16], embeds=front, return_cache=True)
    pad = torch.zeros(*cache["k"].shape[:2], 8, *cache["k"].shape[3:])
    cache = {**cache, "k": torch.cat([cache["k"], pad], 2), "v": torch.cat([cache["v"], pad], 2)}
    with ops.timed_launches("cpu") as frame:
        m.decode_step(prm, cache, toks[:, 16])
    assert Counter(tag for tag, _ in frame["events"]) == {
        "decode_attention": 2 * cfg.num_layers}


@pytest.mark.parametrize("backend", ["torch", "cuda", "paged"])
@pytest.mark.parametrize("queries", [fr.C, fr.N_FRONT], ids=["cross", "encoder"])
def test_full_block_is_the_non_causal_attention(backend, queries):
    """Each backend's ``full_block``, the attention of the encoder's layers
    and of the prefill cross-attention, against the reference's
    ``naive_attention`` with no mask: fp32, ``queries`` queries against
    2 C + 5 keys (the plain version of K1 under ``cuda`` and ``paged`` on
    the CPU), within 1e-5 of max|ref|."""
    import jax.numpy as jnp
    from repro.models import layers as RL
    from repro_torch.core.attention import get_backend

    cfg = fc.smoke(ARCH)
    h, kvh, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((fr.B, queries, h, d), (fr.B, fr.N_FRONT, kvh, d),
                             (fr.B, fr.N_FRONT, kvh, d)))
    got = get_backend(backend).full_block(*map(torch.from_numpy, (q, k, v)))
    want = np.asarray(RL.naive_attention(*map(jnp.asarray, (q, k, v)), causal_offset=None))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_decode_steps_match_reference(reference):
    """From the reference's cache of 2 C + 5 frames' cross K/V and 16
    decoder tokens (the self-attention KV axis padded by 8), 4 decode
    steps: logits within 2e-3 of max|logit|, the cache within 1e-5
    (``frontend_checks.check_decode``); the cross K/V are read, never
    written."""
    cfg = fc.smoke(ARCH)
    fc.check_decode(reference, ARCH, build_model(cfg), fc.params(reference))
    np.testing.assert_array_equal(reference["decode/cache/xk"], reference["decode/cache0/xk"])


def test_init_cache_shape():
    cfg = get_config(ARCH)
    sh = build_model(cfg).init_cache_shape(2, 448)
    assert sh["k"][0] == (12, 2, 448, 12, 64) and sh["xk"][0] == (12, 2, 1500, 12, 64)
    assert sh["pos"] == ((2,), torch.int32)


def test_executor_and_serve_cli_refuse_it():
    """The reference's ``JaxExecutor`` calls the pipeline without embeds,
    so whisper cannot run through it; the port's ``TorchExecutor`` (and the
    serve CLI built on it) refuses it with its own message."""
    cfg = fc.smoke(ARCH)
    run = RunConfig(num_chunks=fr.M, num_stages=4)
    plan = pp.build_plan(cfg, 4, fr.M * fr.C, run)
    staged = init_staged(cfg, plan, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="frame embeddings"):
        TorchExecutor(cfg, staged, run, device="cpu")
    with pytest.raises(ValueError, match="frame embeddings"):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "2",
                    "--seq", "128", "--num-chunks", "8", "--num-stages", "4"])
