"""The port's KV page store and static plan tables (``repro_torch.kvstore``,
``repro_torch.core.{mbkr,plan}``) against the JAX reference: codec payloads
bit for bit, page tables and every static plan table equal, scatter/gather
round trips."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig as RefRun
from repro.configs.base import get_smoke_config as ref_smoke
from repro.core import mbkr as ref_mbkr
from repro.core import plan as ref_plan
from repro.kvstore import pages as ref_pages
from repro.kvstore import quant as ref_quant
from repro_torch.configs import RunConfig, get_smoke_config
from repro_torch.core import lbcp, mbkr
from repro_torch.core import plan as port_plan
from repro_torch.kvstore import pages as kvpages
from repro_torch.kvstore import quant as kvquant


def _kv(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("pages", [1, 2, 4])
def test_int8_encode_bit_equal(pages):
    x = _kv((3, 2, 16, 2, 8))
    codec = kvquant.get_codec("int8")
    q, sc = kvquant.encode(codec, torch.from_numpy(x), pages=pages)
    rq, rsc = ref_quant.encode(ref_quant.get_codec("int8"), jnp.asarray(x), pages=pages)
    assert q.dtype == torch.int8 and sc.shape == tuple(rsc.shape)
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_allclose(sc.numpy(), np.asarray(rsc), rtol=1e-7)
    dec = kvquant.decode(q, kvquant.expand_page_scale(sc, 16 // pages))
    ref_dec = ref_quant.decode(rq, ref_quant.expand_page_scale(rsc, 16 // pages))
    np.testing.assert_allclose(dec.numpy(), np.asarray(ref_dec), rtol=1e-7)


@pytest.mark.parametrize("pages", [1, 4])
def test_fp8_encode_byte_equal(pages):
    x = _kv((2, 2, 16, 2, 8), seed=3)
    q, sc = kvquant.encode(kvquant.get_codec("fp8"), torch.from_numpy(x), pages=pages)
    rq, rsc = ref_quant.encode(ref_quant.get_codec("fp8"), jnp.asarray(x), pages=pages)
    assert q.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(q.view(torch.uint8).numpy(),
                                  np.asarray(rq).view(np.uint8))
    np.testing.assert_allclose(sc.numpy(), np.asarray(rsc), rtol=1e-7)


@pytest.mark.parametrize("name", ["auto", "bfloat16", "float32", "int8", "fp8"])
def test_codecs_match(name):
    got = kvquant.get_codec(name, "float32")
    want = ref_quant.get_codec(name, "float32")
    assert (got.name, got.storage_dtype, got.bytes_per_el, got.quantized) == \
        (want.name, want.storage_dtype, want.bytes_per_el, want.quantized)


@pytest.mark.parametrize("chunk,slots,pt", [(16, 4, 0), (16, 4, 4), (12, 3, 5), (8, 1, 8)])
def test_slot_pages_match(chunk, slots, pt):
    geom = kvpages.page_geometry(chunk, slots, pt)
    rgeom = ref_pages.page_geometry(chunk, slots, pt)
    assert (geom.page_tokens, geom.pages_per_chunk, geom.num_pages) == \
        (rgeom.page_tokens, rgeom.pages_per_chunk, rgeom.num_pages)
    tbl = kvpages.build_slot_pages(geom)
    np.testing.assert_array_equal(tbl, ref_pages.build_slot_pages(rgeom))
    kvpages.verify_page_plan(tbl, geom)
    np.testing.assert_array_equal(kvpages.handle_rows(tbl, [1, 0]),
                                  ref_pages.handle_rows(tbl, [1, 0]))


_TABLES = ("own_slot", "host_slot_a", "host_slot_b", "slot_own_chunk",
           "slot_host_chunk_a", "slot_host_chunk_b", "host_slots_used",
           "slot_pages")


@pytest.mark.parametrize("n,m,mode", list(itertools.product(
    (2, 4, 8), (4, 8, 16), ("mocap", "terapipe"))))
def test_plan_tables_match_reference(n, m, mode):
    """Every static table of ``build_plan`` equals the reference's: this
    guards the port's copies of ``mbkr`` and ``plan``."""
    cfg, rcfg = get_smoke_config("qwen3-8b"), ref_smoke("qwen3-8b")
    seq = m * 16
    got = port_plan.build_plan(cfg, n, seq, RunConfig(num_chunks=m, num_stages=n,
                                                      kv_page_tokens=4), mode=mode)
    want = ref_plan.build_plan(rcfg, n, seq, RefRun(num_chunks=m, num_stages=n,
                                                    kv_page_tokens=4), mode=mode)
    for f in ("num_slots", "p2", "layers_per_stage", "chunk_len", "num_ticks",
              "page_tokens", "pages_per_chunk"):
        assert getattr(got, f) == getattr(want, f), f
    for f in _TABLES:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)), err_msg=f)
    if got.p2 < m:
        mbkr.verify_plan(mbkr.plan(m, n))


@pytest.mark.parametrize("m,n", [(8, 8), (16, 4), (5, 2)])
def test_mbkr_plan_matches_reference(m, n):
    got, want = mbkr.plan(m, n), ref_mbkr.plan(m, n)
    assert (got.num_slots, got.p2) == (want.num_slots, want.p2)
    for f in ("own_slot", "host_slot_a", "host_slot_b"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert mbkr.best_p2(m, n) == ref_mbkr.best_p2(m, n)


def test_full_config_plan():
    """The chip's serve geometry: qwen3-8b, N=8, M=8, C=512 — 6 slots,
    p2 = 6 (chunk 7 attends to a remote chunk), host slots [4, 5], 15
    ticks."""
    from repro_torch.configs import get_config
    plan = port_plan.build_plan(get_config("qwen3-8b"), 8, 4096,
                                RunConfig(num_chunks=8, num_stages=8))
    assert (plan.num_slots, plan.p2, plan.num_ticks, plan.layers_per_stage) == (6, 6, 15, 5)
    assert plan.host_slots_used.tolist() == [4, 5]


def test_uniform_partition():
    from repro.core import lbcp as ref_lbcp
    for s, m in ((128, 8), (100, 7), (5, 8)):
        assert lbcp.uniform_partition(s, m) == ref_lbcp.uniform_partition(s, m)


@pytest.mark.parametrize("kv_dtype,pt", [("auto", 0), ("int8", 4), ("fp8", 8)])
def test_scatter_gather_round_trip(kv_dtype, pt):
    """Encode + scatter a chunk into a stage-stacked pool, then gather it
    back (per slot and as a stack): payloads and scales come back exactly
    and decode to within the codec's step."""
    n, lps, b, c, kvh, hd = 2, 2, 2, 16, 2, 8
    geom = kvpages.page_geometry(c, 3, pt)
    tbl = kvpages.build_slot_pages(geom)
    codec = kvquant.get_codec(kv_dtype, "float32")
    pool = kvpages.alloc_pool(geom, codec, lps, b, kvh, hd, stages=n, device="cpu")
    x = torch.from_numpy(_kv((n, lps, b, c, kvh, hd), seed=5))
    kq, ks = kvquant.encode(codec, x, pages=geom.pages_per_chunk)
    vq, vs = kvquant.encode(codec, -x, pages=geom.pages_per_chunk)
    slots = np.array([2, 0])                      # a different slot per stage
    kvpages.scatter_chunk_raw(pool, tbl[slots], kq, vq, ks, vs)
    for layer in range(lps):
        pool_l = (pool.k[:, :, layer], pool.v[:, :, layer],
                  None if ks is None else pool.k_scale[:, :, layer],
                  None if vs is None else pool.v_scale[:, :, layer])
        gk, gv, gks, gvs = kvpages.gather_chunk(*pool_l, tbl[slots])
        assert torch.equal(gk.view(torch.uint8) if gk.dtype == torch.float8_e4m3fn else gk,
                           (kq[:, layer].reshape(n * b, c, kvh, hd).view(torch.uint8)
                            if kq.dtype == torch.float8_e4m3fn
                            else kq[:, layer].reshape(n * b, c, kvh, hd)))
        if ks is not None:
            want = ks[:, :, layer].reshape(ks.shape[0], n * b, 1, kvh, 1)
            assert torch.equal(gks, want)
            dec = kvquant.decode(gk, kvquant.expand_page_scale(gks, geom.page_tokens))
            step = gks.max().item() * (1 if kv_dtype == "int8" else 32)
            assert (dec - x[:, layer].reshape(n * b, c, kvh, hd)).abs().max() <= step
        # the stack gather of the two written slots, stage by stage
        sk, sv, sks, svs = kvpages.gather_chunks(*pool_l, tbl[[2, 0]])
        for st in range(n):
            rows = slice(st * b, (st + 1) * b)
            assert torch.equal(sk[int(st == 1), rows].float(), gk[rows].float())
    # unwritten slot 1 keeps zero payloads (and unit scales)
    unwritten = torch.as_tensor(tbl[1], dtype=torch.long)
    assert bool((pool.k[:, unwritten].float() == 0).all())
    if codec.quantized:
        assert bool((pool.k_scale[:, unwritten] == 1).all())


def test_single_stage_pool_matches_reference_scatter():
    """One stage's pool (no stage axis): the port's in-place scatter gives
    the reference's functional scatter."""
    lps, b, c, kvh, hd = 2, 2, 8, 2, 4
    geom = kvpages.page_geometry(c, 2, 4)
    tbl = kvpages.build_slot_pages(geom)
    codec = kvquant.get_codec("int8")
    x = _kv((lps, b, c, kvh, hd), seed=9)
    pool = kvpages.alloc_pool(geom, codec, lps, b, kvh, hd, device="cpu")
    kq, ks = kvquant.encode(codec, torch.from_numpy(x), pages=2)
    kvpages.scatter_chunk_raw(pool, tbl[1], kq, kq, ks, ks)
    rpool = ref_pages.alloc_pool(ref_pages.page_geometry(c, 2, 4),
                                 ref_quant.get_codec("int8"), lps, b, kvh, hd)
    rpool = ref_pages.scatter_chunk(rpool, jnp.asarray(tbl[1]), jnp.asarray(x),
                                    jnp.asarray(x), ref_quant.get_codec("int8"))
    np.testing.assert_array_equal(pool.k.numpy(), np.asarray(rpool.k))
    np.testing.assert_allclose(pool.k_scale.numpy(), np.asarray(rpool.k_scale), rtol=1e-7)
