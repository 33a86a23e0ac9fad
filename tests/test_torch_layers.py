"""The port's dense model math (``repro_torch.models``) against the JAX
reference (``repro.models``) on the CPU, float32, same numpy inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as ref_smoke
from repro.configs.base import replace as ref_replace
from repro.models import layers as RL
from repro.models.api import build_model
from repro_torch import bridge
from repro_torch.configs import get_smoke_config, replace
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

RTOL, ATOL = 1e-5, 1e-6


def _close(got: torch.Tensor, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_rms_norm(rng):
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    _close(L.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6),
           RL.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))


@pytest.mark.parametrize("batched", [False, True])
def test_rope(rng, batched):
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = np.arange(7)[None] + np.array([[3], [40]]) if batched else np.arange(7) + 11
    cos, sin = L.rope_angles(torch.from_numpy(pos), 16, 1e6)
    rcos, rsin = RL.rope_angles(jnp.asarray(pos), 16, 1e6)
    _close(cos, rcos)
    _close(sin, rsin)
    _close(L.apply_rope(torch.from_numpy(x), cos, sin),
           RL.apply_rope(jnp.asarray(x), rcos, rsin))


def test_swiglu(rng):
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    p = {k: (rng.standard_normal(s) * 0.1).astype(np.float32)
         for k, s in (("wg", (32, 48)), ("wu", (32, 48)), ("wd", (48, 32)))}
    _close(L.swiglu({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x)),
           RL.swiglu({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))


@pytest.mark.parametrize("scale", [1.0, 8.0])
def test_embed_unembed(rng, scale):
    vpad = L.pad_vocab(200)
    assert vpad == RL.pad_vocab(200) == 256
    table = rng.standard_normal((vpad, 32)).astype(np.float32)
    toks = rng.integers(0, 200, (2, 9))
    emb = L.embed_lookup(torch.from_numpy(table), torch.from_numpy(toks))
    ref = RL.embed_lookup(jnp.asarray(table), jnp.asarray(toks))
    _close(emb, ref)
    w = rng.standard_normal((32, vpad)).astype(np.float32)
    got = L.unembed_logits(emb, torch.from_numpy(w), scale=scale)
    assert got.dtype == torch.float32
    _close(got, RL.unembed_logits(ref, jnp.asarray(w), scale=scale), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("offset", [0, 5, None])
def test_naive_attention(rng, offset):
    q = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 11 if offset == 5 else 6, 2, 16)).astype(np.float32)
    v = rng.standard_normal(k.shape).astype(np.float32)
    _close(L.naive_attention(*map(torch.from_numpy, (q, k, v)), causal_offset=offset),
           RL.naive_attention(*map(jnp.asarray, (q, k, v)), causal_offset=offset))


def _ref_params(cfg):
    params = build_model(cfg).init(jax.random.key(0))
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("granite", [False, True])
def test_dense_forward_matches_reference(granite):
    """Whole-sequence forward of the qwen3-8b smoke config (and the same
    config with the granite scalars switched on), params through the
    bridge: last-token logits max rel err < 1e-4 (denominator floor 1e-3)."""
    kw = {}
    if granite:
        kw = dict(embedding_multiplier=12.0, logits_scaling=8.0,
                  residual_multiplier=0.22, attention_multiplier=0.0078125)
    rcfg = ref_replace(ref_smoke("qwen3-8b"), dtype="float32", **kw)
    cfg = replace(get_smoke_config("qwen3-8b"), dtype="float32", **kw)
    tree = _ref_params(rcfg)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 24))
    want = np.asarray(build_model(rcfg).forward(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(toks)))
    params = bridge.params_from_numpy(tree, device="cpu")
    got = T.forward(cfg, params, torch.from_numpy(toks)).numpy()
    assert got.shape == want.shape
    rel = np.abs(got - want) / (np.abs(want) + 1e-3)
    assert rel.max() < 1e-4, rel.max()


@pytest.mark.parametrize("arch", ["qwen3-8b", "qwen2-moe-a2.7b", "granite-moe-3b-a800m"])
def test_init_shapes_and_stds_match_reference(arch):
    """``init`` draws the reference's shapes and stds (the MoE leaves
    router, e_wg / e_wu / e_wd and the shared experts' s_wg / s_wu / s_wd
    included; no lm_head under tied embeddings); padded stage rows
    (``layer_lead`` past L) are exact zeros."""
    cfg = replace(get_smoke_config(arch), dtype="float32", num_layers=3)
    rcfg = ref_replace(ref_smoke(arch), dtype="float32", num_layers=3)
    tree = _ref_params(rcfg)
    p = T.init(cfg, torch.Generator().manual_seed(0), "cpu")
    flat_ref = {"/".join(str(k.key) for k in path): v for path, v in
                jax.tree_util.tree_flatten_with_path(tree)[0]}
    flat = {**{k: v for k, v in p.items() if k != "layers"},
            **{f"layers/{k}": v for k, v in p["layers"].items()}}
    assert set(flat) == set(flat_ref)
    for name, want in flat_ref.items():
        got = flat[name]
        assert tuple(got.shape) == want.shape, name
        if want.std() > 0:
            assert abs(got.std().item() / want.std() - 1) < 0.15, name
    staged = T.init(cfg, torch.Generator().manual_seed(0), "cpu", layer_lead=(2, 2))
    assert staged["layers"]["wq"].shape[:2] == (2, 2)
    for leaf in staged["layers"].values():
        assert bool((leaf[1, 1] == 0).all())
