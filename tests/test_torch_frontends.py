"""llava-next-34b, the vlm family (the transformer backbone with stub patch
embeddings spliced in front of the text tokens), in the port against the
JAX reference on the CPU:

- the configs, full and smoke, field for field, and ``param_count``;
- ``Model.forward`` with embeds against the reference's forward, every
  position: max rel err < 2e-3 (denominator floor 1e-3);
- ``prefill_pipeline(embeds=)`` against the reference pipeline and its
  forward, the front ``2 C + 5`` embeddings long (not a whole number of
  chunks), mocap under qship and fetch at N = 8 (deep: p2 = 6, so the last
  chunk reads a remote chunk) and N = 4, under the ``torch``, ``cuda`` and
  ``paged`` pools (plain versions on the CPU): logits at max rel err <
  2e-3, the ledger and the telemetry equal (``frontend_checks``); one
  reference subprocess (``tests/helpers/frontend_reference.py``) runs every
  case;
- the splice of a chunk that straddles the front, position by position;
- ``decode_step`` against the reference's over 4 steps (K5's plain version
  at G 2);
- ``TorchExecutor`` serves it text-only, as the reference's
  ``JaxExecutor`` does."""
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_config
from repro.configs.base import get_smoke_config as ref_smoke
from repro_torch.configs import RunConfig, get_config, get_smoke_config
from repro_torch.core import pipeline as pp
from repro_torch.core.staging import init_staged
from repro_torch.models.api import build_model
from repro_torch.runtime.engine import EngineConfig, PrefillEngine, Request, TorchExecutor
from tests.helpers import frontend_checks as fc
from tests.helpers import frontend_reference as fr
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401

ARCH = "llava-next-34b"


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return fr.run(ARCH, tmp_path_factory.mktemp("ref") / "ref.npz")


@pytest.mark.parametrize("full", [True, False], ids=["full", "smoke"])
def test_config_matches_reference(full):
    cfg = get_config(ARCH) if full else get_smoke_config(ARCH)
    rcfg = ref_config(ARCH) if full else ref_smoke(ARCH)
    for field in cfg.__dataclass_fields__:
        got, want = getattr(cfg, field), getattr(rcfg, field)
        if field == "frontend":
            assert (got.kind, got.num_embeds) == (want.kind, want.num_embeds)
        else:
            assert got == want, (field, got, want)
    assert set(cfg.__dataclass_fields__) == set(rcfg.__dataclass_fields__)
    assert cfg.param_count() == rcfg.param_count()
    if full:
        assert cfg.num_heads // cfg.num_kv_heads == 7 and cfg.resolved_head_dim == 128


def test_forward_with_embeds_matches_reference(reference):
    cfg = fc.smoke(ARCH)
    got = build_model(cfg).forward(fc.params(reference), torch.from_numpy(reference["tokens"]),
                                   embeds=torch.from_numpy(reference["embeds"])).numpy()
    want = reference["forward"]
    assert got.shape == want.shape == (fr.B, fr.M * fr.C, want.shape[-1])
    assert fc.rel_err(got, want) < 2e-3


@pytest.mark.parametrize("pool", fc.POOLS)
@pytest.mark.parametrize("case", list(fr.CASES))
def test_pipeline_matches_reference(reference, case, pool):
    fc.check_pipeline(reference, ARCH, case, pool)


def test_splice_of_a_chunk_that_straddles_the_front():
    """``chunk_embed`` of every chunk of a front of 2 C + 5: chunk 2 holds
    5 patch embeddings, then 11 token embeddings; each position equals the
    reference's select (``pos < F ? front : embed[token[pos - F]]``,
    ``repro.core.pipeline``'s tick input) bit for bit."""
    gen = torch.Generator().manual_seed(0)
    embed = torch.randn(64, 8, generator=gen)
    front = torch.randn(fr.B, fr.N_FRONT, 8, generator=gen)
    toks = torch.randint(0, 64, (fr.B, fr.M * fr.C - fr.N_FRONT), generator=gen)
    fpad = -(-fr.N_FRONT // fr.C) * fr.C
    padded = torch.cat([front, torch.zeros(fr.B, fpad - fr.N_FRONT, 8)], dim=1)
    straddles = 0
    for tc in range(fr.M):
        pos = tc * fr.C + torch.arange(fr.C)
        x_tok = embed[toks[:, (pos - fr.N_FRONT).clamp(0, toks.shape[1] - 1)]]
        fstart = min(tc * fr.C, fpad - fr.C)
        want = torch.where((pos < fr.N_FRONT)[None, :, None],
                           padded[:, fstart:fstart + fr.C], x_tok)
        got = pp.chunk_embed(embed, toks, front, tc * fr.C, fr.C)
        assert torch.equal(got, want), tc
        straddles += int(bool((pos < fr.N_FRONT).any() and (pos >= fr.N_FRONT).any()))
    assert straddles == 1


@pytest.mark.parametrize("n_front", [2 * fr.C, fr.C - 3, 5 * fr.C + 1])
def test_pipeline_splice_matches_forward_at_other_fronts(reference, n_front):
    """The port against its own forward (the concatenation) at a front of
    whole chunks, one inside the first chunk and one that ends a chunk
    into the sixth: max rel err < 2e-3, under the ``cuda`` pool."""
    cfg = fc.smoke(ARCH)
    prm = fc.params(reference)
    gen = torch.Generator().manual_seed(n_front)
    front = torch.randn(fr.B, n_front, cfg.d_model, generator=gen) * 0.02
    toks = torch.randint(0, cfg.vocab_size, (fr.B, fr.M * fr.C - n_front), generator=gen)
    want = build_model(cfg).forward(prm, toks, embeds=front)[:, -1]
    run = RunConfig(num_chunks=fr.M, num_stages=8, attn_backend="cuda", pool_backend="cuda")
    plan = pp.build_plan(cfg, 8, fr.M * fr.C, run)
    got = pp.prefill_pipeline(cfg, pp.stage_params(cfg, prm, plan), toks, plan,
                              device="cpu", embeds=front)
    assert fc.rel_err(got, want) < 2e-3


def test_pipeline_refuses_a_wrong_front():
    cfg = fc.smoke(ARCH)
    run = RunConfig(num_chunks=fr.M, num_stages=4)
    plan = pp.build_plan(cfg, 4, fr.M * fr.C, run)
    staged = init_staged(cfg, plan, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.zeros(fr.B, fr.M * fr.C - 5, dtype=torch.long)
    with pytest.raises(ValueError, match="embeds"):
        pp.prefill_pipeline(cfg, staged, toks, plan, device="cpu",
                            embeds=torch.zeros(fr.B, 6, cfg.d_model))
    qcfg = fc.smoke("qwen3-8b")
    qstaged = init_staged(qcfg, plan, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="takes no embeds"):
        pp.prefill_pipeline(qcfg, qstaged, toks, plan, device="cpu",
                            embeds=torch.zeros(fr.B, 5, qcfg.d_model))


def test_decode_steps_match_reference(reference):
    """From the reference's cache of 2 C + 5 patch embeddings and 16 tokens
    (its KV axis padded by 8), 4 decode steps: logits within 2e-3 of
    max|logit|, the cache within 1e-5 (``frontend_checks.check_decode``)."""
    cfg = fc.smoke(ARCH)
    fc.check_decode(reference, ARCH, build_model(cfg), fc.params(reference))


def test_executor_serves_text_only(reference):
    """``TorchExecutor`` (as the reference's ``JaxExecutor``) passes no
    embeddings: a wave of two requests is the pipeline of the tokens
    alone, bit for bit."""
    cfg = fc.smoke(ARCH)
    run = RunConfig(num_chunks=fr.M, num_stages=4, attn_backend="cuda")
    seq = fr.M * fr.C
    plan = pp.build_plan(cfg, 4, seq, run)
    staged = pp.stage_params(cfg, fc.params(reference), plan)
    ex = TorchExecutor(cfg, staged, run, device="cpu")
    eng = PrefillEngine(EngineConfig(model=cfg, num_stages=4, tp=1, num_chunks=fr.M,
                                     max_batch=2, buckets=(seq,), partition="uniform"), ex)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, seq))
    for i in range(2):
        eng.submit(Request(rid=i, seq_len=seq, arrival=0.0, tokens=toks[i]))
    eng.run_until_drained()
    got = np.stack([r.result for r in sorted(eng.done, key=lambda r: r.rid)])
    want = pp.prefill_pipeline(cfg, staged, toks, plan, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)

