"""The port's decode path against the JAX reference on the CPU, same numpy
inputs, the reference's parameters (``model.init(jax.random.key(0))``)
carried across with ``repro_torch.bridge``:

- K5's plain version (``kernels.ref.decode_attention_plain``, which
  ``kernels.ops.decode_attention`` takes on the CPU) against the reference
  Pallas flash-decode in interpret mode (``repro.kernels.ops.
  decode_attention``) and the oracle ``decode_attention_ref``, on the grid of
  ``tests/test_kernels.py::test_decode_attention`` at its tolerances (2e-5
  fp32, 3e-2 bf16);
- ``forward(return_cache=True)``'s cache leaf for leaf, the prefill->decode
  bridge of ``tests/test_models.py::test_decode_continues_prefill`` (atol
  2e-3 against the longer forward; max err < 2e-3 of max|logit| against the
  reference ``decode_step`` on the same cache), several steps from
  ``init_cache`` and rows at ragged positions, for qwen3-8b, zamba2-7b and
  mamba2-130m smoke configs in fp32, and one step of each in bf16.

The port's ``decode_step`` updates the cache in place, so every comparison
starts both packages from their own copies of one numpy cache."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs.base import get_smoke_config as ref_smoke
from repro.configs.base import replace as ref_replace
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_k
from repro.models.api import build_model as ref_build
from repro_torch import bridge
from repro_torch.configs import get_smoke_config, replace
from repro_torch.kernels import ops, ref
from repro_torch.models.api import build_model

ARCHS = ("qwen3-8b", "zamba2-7b", "mamba2-130m")
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


# ------------------------------------------------------------------ K5

def _decode_inputs(b, h, kvh, d, s, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, d)).astype(np.float32),
            rng.standard_normal((b, s, kvh, d)).astype(np.float32),
            rng.standard_normal((b, s, kvh, d)).astype(np.float32))


def _both(arrays, dtype):
    """The same numpy arrays as jnp and torch arrays of ``dtype`` (both
    round to bf16 to nearest even)."""
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


DECODE_GRID = [   # (b, h, kvh, d, s): tests/test_kernels.py::test_decode_attention
    (2, 8, 2, 64, 256),
    (3, 4, 4, 32, 100),
    (1, 16, 2, 128, 1024),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kvh,d,s", DECODE_GRID)
def test_decode_plain_matches_pallas_and_oracle(b, h, kvh, d, s, dtype):
    (jq, jk, jv), (q, k, v) = _both(_decode_inputs(b, h, kvh, d, s), dtype)
    kvl = np.random.default_rng(1).integers(1, s + 1, b).astype(np.int32)
    got = ref.decode_attention_plain(q, k, v, torch.from_numpy(kvl))
    assert got.dtype == q.dtype and got.shape == (b, h, d)
    tol = 3e-2 if dtype == "bfloat16" else 2e-5
    for want in (ref_ops.decode_attention(jq, jk, jv, jnp.asarray(kvl)),   # interpret
                 ref_k.decode_attention_ref(jq, jk, jv, jnp.asarray(kvl))):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)


def test_decode_plain_never_reads_the_ragged_tail():
    """Keys and values past kv_len, poisoned with +-1e4, leave the output as
    it was (``tests/test_kernels.py::test_decode_attention_ragged_lengths``)."""
    q, k, v = _decode_inputs(2, 4, 2, 32, 128, seed=2)
    kvl = np.array([17, 64], np.int32)
    k2, v2 = k.copy(), v.copy()
    k2[0, 17:], v2[0, 17:] = 1e4, -1e4
    k2[1, 64:], v2[1, 64:] = -1e4, 1e4
    t = lambda *a: [torch.from_numpy(x) for x in a]   # noqa: E731
    out1 = ref.decode_attention_plain(*t(q, k, v, kvl))
    out2 = ref.decode_attention_plain(*t(q, k2, v2, kvl))
    np.testing.assert_allclose(out2.numpy(), out1.numpy(), atol=1e-6)
    want = ref_ops.decode_attention(*(jnp.asarray(x) for x in (q, k2, v2, kvl)))
    np.testing.assert_allclose(out2.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


def test_decode_plain_empty_row_gives_zeros():
    """kv_len = 0 gives zeros, as the Pallas kernel does (interpret mode);
    the oracle's softmax over an all -inf row gives NaN there instead."""
    q, k, v = _decode_inputs(2, 8, 2, 16, 40, seed=3)
    kvl = np.array([0, 23], np.int32)
    got = ref.decode_attention_plain(*(torch.from_numpy(x) for x in (q, k, v, kvl)))
    assert bool((got[0] == 0).all()) and bool(torch.isfinite(got).all())
    j = [jnp.asarray(x) for x in (q, k, v, kvl)]
    want = np.asarray(ref_ops.decode_attention(*j))
    assert (want[0] == 0).all()
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    assert np.isnan(np.asarray(ref_k.decode_attention_ref(*j))[0]).all()


def test_decode_wrapper_on_cpu_is_the_plain_version():
    """On CPU tensors ``ops.decode_attention`` returns exactly the plain
    version's output and launches nothing, for each head dim and group
    size the kernel takes."""
    ops.reset_launches()
    for i, (h, kvh, d) in enumerate(((4, 2, 16), (4, 4, 112), (8, 2, 128), (8, 1, 16))):
        q, k, v = (torch.from_numpy(a) for a in _decode_inputs(3, h, kvh, d, 37, seed=i))
        kvl = torch.tensor([0, 1, 37], dtype=torch.int32)
        for scale in (None, 0.3):
            got = ops.decode_attention(q, k, v, kvl, scale=scale)
            assert torch.equal(got, ref.decode_attention_plain(q, k, v, kvl, scale=scale))
    assert ops.LAUNCHES["decode_attention"] == 0


DECODE_RULE_CASES = {   # (row lengths, H, KVH, head dim, item size); S = 32768
    "full": ([32768] * 8, 32, 8, 128, 2),          # qwen3-8b's timed decode shape
    "ragged": ([0, 1, 77, 4099, 12345, 20001, 32767, 32768], 32, 8, 128, 2),
    "100x": ([300, 30000, 327, 32768, 310, 31000, 299, 32000], 32, 32, 112, 2),  # zamba2-7b
    "one_key": ([0, 1], 8, 8, 16, 4),
    "short_rows": ([5] * 300, 4, 1, 128, 4),
    "empty": ([0, 0, 0], 8, 4, 128, 2),
}


@pytest.mark.parametrize("blocks", [132, 396])
@pytest.mark.parametrize("case", DECODE_RULE_CASES)
def test_decode_splits_cover_the_cache(case, blocks):
    """K5's split of the work (``ops.decode_ranges``, the rule the kernel
    computes on the device): every key of every row lies in exactly one
    segment, no segment reaches past its row's length (so none past S), and
    no block takes more than one tile of keys above the mean, whatever the
    lengths are (the ragged and 100x cases); a block's segments run in
    sequence order. zamba2-7b's MHA bf16 rows (224 bytes) pair their kv
    heads, qwen3-8b's GQA rows do not."""
    lengths, h, kvh, d, itemsize = DECODE_RULE_CASES[case]
    hp = ops.decode_heads_per_unit(h // kvh, d, itemsize, kvh)
    assert hp == (2 if case == "100x" else 1)
    keys = ops.decode_tile_keys(d, itemsize, hp)
    units = kvh // hp
    span, ranges = ops.decode_ranges(lengths, units, blocks, keys)
    assert len(ranges) == blocks and span % keys == 0
    covered = {}
    for segs in ranges:
        assert segs == sorted(segs)
        for b, u, a, e in segs:
            assert 0 <= a < e <= lengths[b] <= 32768
            covered.setdefault((b, u), []).append((a, e))
    for b, n in enumerate(lengths):
        for u in range(units):
            pos = 0
            for a, e in sorted(covered.pop((b, u), [])):
                assert a == pos
                pos = e
            assert pos == n
    assert not covered
    total = units * sum(lengths)
    loads = [sum(e - a for _, _, a, e in segs) for segs in ranges]
    assert sum(loads) == total
    assert max(loads) < total / blocks + keys
    # the kernel's tiles at the decode shapes (bf16): 32 keys at D 128, 16
    # two-head keys at D 112
    assert ops.decode_tile_keys(128, 2) == 32 and ops.decode_tile_keys(112, 2, 2) == 16


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "kv_dtype", "group", "kv_len_dtype",
                                 "kv_len_shape"])
def test_decode_wrapper_raises_on_what_k5_does_not_take(bad):
    h, kvh, d = {"head_dim": (4, 2, 64), "group": (6, 2, 16)}.get(bad, (4, 2, 16))
    q, k, v = (torch.from_numpy(a) for a in _decode_inputs(2, h, kvh, d, 8))
    kvl = torch.tensor([3, 8], dtype=torch.int32)
    if bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "kv_dtype":
        k, v = k.bfloat16(), v.bfloat16()
    elif bad == "kv_len_dtype":
        kvl = kvl.long()
    elif bad == "kv_len_shape":
        kvl = kvl[:1]
    with pytest.raises((TypeError, ValueError)):
        ops.decode_attention(q, k, v, kvl)


# ------------------------------------------------------------------ models

@functools.lru_cache(maxsize=None)
def _models(arch, dtype="float32"):
    """(reference model, its params as numpy, port model, port params)."""
    rm = ref_build(ref_replace(ref_smoke(arch), dtype=dtype))
    tree = jax.tree.map(np.asarray, rm.init(jax.random.key(0)))
    pm = build_model(replace(get_smoke_config(arch), dtype=dtype))
    return rm, tree, pm, bridge.params_from_numpy(tree, device="cpu")


def _jparams(tree):
    return jax.tree.map(jnp.asarray, tree)


def _numpy_cache(cache):
    """The port's cache as a dict of fresh numpy arrays (ml_dtypes bfloat16
    for bf16 leaves)."""
    return {k: (v.float().numpy().astype(jnp.bfloat16) if v.dtype == torch.bfloat16
                else v.numpy().copy()) for k, v in cache.items()}


def _pad_kv(cache, extra):
    """The reference test's padding of the KV sequence axis (numpy)."""
    if "k" not in cache:
        return cache
    pad = ((0, 0), (0, 0), (0, extra), (0, 0), (0, 0))
    return {**cache, "k": np.pad(cache["k"], pad), "v": np.pad(cache["v"], pad)}


def _held(got, want, rel):
    """max abs err <= rel * max|want| (fp32 views)."""
    g = got.float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape, (g.shape, w.shape)
    err, scale = np.abs(g - w).max(), np.abs(w).max()
    assert err <= rel * max(scale, 1e-30), (err, scale)


def _cache_held(cache, jcache, rel=1e-5):
    """Same keys, shapes and dtypes; pos equal; every float leaf within
    ``rel`` of its own max|ref|."""
    assert set(cache) == set(jcache)
    for key, w in jcache.items():
        g = cache[key]
        assert tuple(g.shape) == w.shape, key
        assert str(g.dtype).split(".")[-1] == str(w.dtype), (key, g.dtype, w.dtype)
        if key == "pos":
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            _held(g, w, rel)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_cache_matches_reference(arch):
    rm, tree, pm, params = _models(arch)
    toks = _tokens(pm.cfg, (2, 16), 1)
    jlogits, jcache = rm.forward(_jparams(tree), jnp.asarray(toks), return_cache=True)
    logits, cache = pm.forward(params, torch.from_numpy(toks), return_cache=True)
    _held(logits, jlogits, 2e-3)
    _cache_held(cache, jax.tree.map(np.asarray, jcache))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_continues_prefill(arch):
    """forward(return_cache) on 16 tokens, the KV axis padded, one
    decode_step: the port against its own forward on 17 tokens, and against
    the reference ``decode_step`` on the reference's cache carried across."""
    rm, tree, pm, params = _models(arch)
    toks = _tokens(pm.cfg, (2, 17), 1)
    full = pm.forward(params, torch.from_numpy(toks))
    _, cache = pm.forward(params, torch.from_numpy(toks[:, :16]), return_cache=True)
    cache = bridge.cache_from_numpy(_pad_kv(_numpy_cache(cache), 16), "cpu")
    logits, new = pm.decode_step(params, cache, torch.from_numpy(toks[:, 16]))
    np.testing.assert_allclose(logits.numpy(), full[:, -1].numpy(), atol=2e-3)
    assert new["pos"].tolist() == [17, 17] and cache["pos"].tolist() == [16, 16]

    jp = _jparams(tree)
    _, jcache = rm.forward(jp, jnp.asarray(toks[:, :16]), return_cache=True)
    jcache = _pad_kv(jax.tree.map(np.asarray, jcache), 16)
    jlogits, _ = rm.decode_step(jp, jax.tree.map(jnp.asarray, jcache), jnp.asarray(toks[:, 16]))
    logits, _ = pm.decode_step(params, bridge.cache_from_numpy(jcache, "cpu"),
                               torch.from_numpy(toks[:, 16]))
    _held(logits, jlogits, 2e-3)


def _step_both(rm, tree, pm, params, jcache, cache, toks):
    """decode_step in both packages for each column of ``toks``; holds the
    logits and every cache leaf after each step."""
    jp = _jparams(tree)
    for t in range(toks.shape[1]):
        jlogits, jcache = rm.decode_step(jp, jcache, jnp.asarray(toks[:, t]))
        logits, cache = pm.decode_step(params, cache, torch.from_numpy(toks[:, t]))
        _held(logits, jlogits, 2e-3)
        _cache_held(cache, jax.tree.map(np.asarray, jcache))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_from_init_cache(arch):
    """Four consecutive steps from an empty cache (``test_archs.py``'s
    decode smoke, held to the reference)."""
    rm, tree, pm, params = _models(arch)
    jcache = rm.init_cache(2, 8)
    cache = pm.init_cache(2, 8, device="cpu")
    _cache_held(cache, jax.tree.map(np.asarray, jcache), rel=0)
    _step_both(rm, tree, pm, params, jcache, cache, _tokens(pm.cfg, (2, 4), 5))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_ragged_positions(arch):
    """Rows at different positions (0, 7, 19) over a cache with random
    contents (k/v and SSM states), two steps in both packages."""
    rm, tree, pm, params = _models(arch)
    rng = np.random.default_rng(7)
    base = jax.tree.map(np.asarray, rm.init_cache(3, 24))
    np_cache = {k: (np.array([0, 7, 19], np.int32) if k == "pos" else
                    (0.5 * rng.standard_normal(v.shape)).astype(v.dtype))
                for k, v in base.items()}
    _step_both(rm, tree, pm, params, jax.tree.map(jnp.asarray, np_cache),
               bridge.cache_from_numpy(np_cache, "cpu"), _tokens(pm.cfg, (3, 2), 8))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_bf16_against_reference(arch):
    """Each smoke model in bf16, one step from the reference's own prefill
    cache: logits and every cache leaf within 3e-2 of max|ref| (the bf16
    tolerance of ``test_kernels.py``). This holds the bf16 Mamba2 decode too
    (``causal_conv_step`` rounds the fp32 conv state to x's dtype before the
    taps; the new states return in fp32). The reference rounds p to bf16
    before PV (``layers.decode_attention_local``); K5 and its plain version
    keep p in fp32, so the two differ by bf16 rounding, not by 1e-5."""
    rm, tree, pm, params = _models(arch, "bfloat16")
    assert params["embed"].dtype == torch.bfloat16
    toks = _tokens(pm.cfg, (2, 17), 1)
    jp = _jparams(tree)
    _, jcache = rm.forward(jp, jnp.asarray(toks[:, :16]), return_cache=True)
    jcache = _pad_kv(jax.tree.map(np.asarray, jcache), 16)
    cache = bridge.cache_from_numpy(jcache, "cpu")
    assert all(cache[k].dtype == torch.bfloat16 for k in ("k", "v") if k in cache)
    jlogits, jnew = rm.decode_step(jp, jax.tree.map(jnp.asarray, jcache),
                                   jnp.asarray(toks[:, 16]))
    logits, new = pm.decode_step(params, cache, torch.from_numpy(toks[:, 16]))
    _held(logits, jlogits, 3e-2)
    _cache_held(new, jax.tree.map(np.asarray, jnew), rel=3e-2)


def test_decode_past_the_cache_raises():
    """A write position at or past max_len raises (the reference's
    dynamic_update_slice would clamp it onto the last slot): the position
    check is an asynchronous assert, which raises at once on the CPU."""
    _, _, pm, params = _models("qwen3-8b")
    cache = pm.init_cache(2, 4, device="cpu")
    cache["pos"] = torch.tensor([1, 4], dtype=torch.int32)
    with pytest.raises(RuntimeError, match="outside a cache of 4"):
        pm.decode_step(params, cache, torch.zeros(2, dtype=torch.int32))


def test_model_entry_points_default_to_the_card(monkeypatch):
    """``init`` and ``init_cache`` with no device need a card and raise
    without one; with ``device="cpu"`` the whole bridge runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in ARCHS:
        model = build_model(replace(get_smoke_config(arch), dtype="float32"))
        with pytest.raises(RuntimeError):
            model.init(torch.Generator().manual_seed(0))
        with pytest.raises(RuntimeError):
            model.init_cache(2, 8)
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
        toks = torch.from_numpy(_tokens(model.cfg, (2, 5), 0))
        _, cache = model.forward(params, toks, return_cache=True)
        if "k" in cache:
            pad = (0, 0, 0, 0, 0, 3)
            cache = {**cache, "k": F.pad(cache["k"], pad), "v": F.pad(cache["v"], pad)}
        logits, cache = model.decode_step(params, cache, toks[:, 0])
        assert logits.shape == (2, params["embed"].shape[0])
        assert bool(torch.isfinite(logits).all()) and cache["pos"].tolist() == [6, 6]
