"""Cross-request prefix KV reuse and the cold KV tier on the port
(``repro_torch.kvstore.prefix`` / ``tiers``, the prefix path of
``prefill_pipeline``, ``ChunkScheduler``, ``ContinuousEngine`` and
``TorchExecutor``) against the JAX package's.

- Host logic, in-process, on the same inputs: chained chunk hashes, the
  radix index (acquire / release / copy-on-write, leaf-first LRU eviction,
  random traffic with ``verify_prefix_index`` after every step),
  ``DeviceSeedCache``, ``ChunkPlan.build(prefix_hit_chunks=k)`` and shared
  lease pages, the scheduler's admissions, leases and ``prefix_stats`` on
  one request stream: equal exactly (float64 host arithmetic at rtol
  1e-12).
- Device leg on the CPU at the deep smoke geometry of
  ``tests/test_torch_pipeline.py`` (N = M = 8, C = 16, B = 2, fp32 qwen3-8b,
  p2 = 6) under the ``torch``, ``cuda`` and ``paged`` pool backends (the
  kernels' plain versions on the CPU), bf16-width and int8 pages:
  ``return_kv`` leaves the logits bit-identical; a run seeded from that
  pool, with garbage tokens in the hit region, is bit-identical to the
  unseeded one at every hit length up to min(p2, M - 1); ``prefix_hit``
  equals ``prefix_saved_model``; the caller's seed is unchanged.
- One reference subprocess (8 fake host devices) gives the reference's
  seeded logits and ledger at k = 3 and its ``JaxExecutor`` round trip
  (``tests/test_prefix.py``'s stream): the port's ledger equals it (rtol
  1e-6), its logits agree at the pipeline's 2e-3, and its engine seeds the
  same waves and counts the same hits.
- The cold tier: ``plan_tiers`` / ``max_seq_len_for_budget`` on
  ``tests/test_kvstore.py``'s inputs, the ``HostOffloadStager`` round trip
  on the CPU, and ``serve --kv-offload --device cpu``'s summary against the
  reference's.

The reference's seeded run differs from its unseeded one from k = 5 on at
this geometry (its final pool has lent own slots 4 and 5 to the pair's
spill on the first half of the stages); the port keeps those chunks (see
``prefill_pipeline``), so the bit-identity test runs every k, and the
reference comparisons run at k = 3."""
import contextlib
import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs.base import get_config as ref_config
from repro.core import costmodel as ref_cm
from repro.kvstore import prefix as ref_prefix
from repro.kvstore import tiers as ref_tiers
from repro.runtime import engine as ref_engine
from repro.sched import ChunkPlan as RefChunkPlan
from repro.sched.kvlease import chunk_page_bytes as ref_chunk_page_bytes
from repro_torch import bridge
from repro_torch.configs import RunConfig, get_config, get_smoke_config, replace
from repro_torch.core import costmodel as cm
from repro_torch.core import pipeline as pp
from repro_torch.core.staging import init_staged
from repro_torch.kvstore import prefix, tiers
from repro_torch.kvstore.pages import POOL_FIELDS as FIELDS
from repro_torch.kvstore.pages import PagedPool
from repro_torch.obs.telemetry import prefix_saved_model
from repro_torch.runtime import engine
from repro_torch.sched import ChunkPlan
from repro_torch.sched.kvlease import chunk_page_bytes
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
N, M, C, B = 8, 8, 16, 2
REF_K = 3                      # hit length of the reference comparisons
REF_CASES = {"qship": ("qship", "auto"), "fetch_int8": ("fetch", "int8")}


# ------------------------------------------------------------------ hashes

TOKENS = {
    "arange": np.arange(64),
    "tail": np.r_[np.arange(48), np.arange(48, 64) + 1],
    "head": np.r_[[1], np.arange(1, 64)],
    "partial": np.arange(63),
    "random": np.random.default_rng(0).integers(0, 151936, 200),
}


@pytest.mark.parametrize("name", sorted(TOKENS))
@pytest.mark.parametrize("chunks", [16, [16, 16, 16, 16], [32, 32], 0, 7, [8, 40, 16]])
def test_chunk_hashes_match_reference(name, chunks):
    toks = TOKENS[name]
    assert prefix.chunk_hashes(toks, chunks) == ref_prefix.chunk_hashes(toks, chunks)


# ------------------------------------------------------------- radix index

def index_state(cache):
    """Everything a ``PrefixPageCache`` holds, comparable across packages."""
    nodes = {k: (n.parent, n.depth, n.pages, n.refs, n.children, n.last_use)
             for k, n in cache._nodes.items()}
    return (nodes, list(cache._free), cache._next_page, cache._clock,
            sorted((l.rid, l.chain, l.hit_chunks, l.hit_pages, l.new_pages)
                   for l in cache._live.values()), cache.stats())


def lease_fields(lease):
    return (lease.rid, lease.chain, lease.hit_chunks, lease.hit_pages,
            lease.new_pages, lease.released)


def run_both(ops, **kw):
    """The same acquire / release sequence on the port's index and the
    reference's; the states must agree after every step and both verify."""
    caches = (prefix.PrefixPageCache(**kw), ref_prefix.PrefixPageCache(**kw))
    live = ([], [])
    for op, arg in ops:
        for cache, held, mod in zip(caches, live, (prefix, ref_prefix)):
            if op == "acquire":
                held.append(cache.acquire(len(held), arg))
            elif held:
                cache.release(held.pop(arg % len(held)))
            mod.verify_prefix_index(cache)
        assert index_state(caches[0]) == index_state(caches[1])
        assert [lease_fields(l) for l in live[0]] == [lease_fields(l) for l in live[1]]
    return caches


def chain(toks, c):
    return prefix.chunk_hashes(np.asarray(toks), c)


def test_prefix_cache_acquire_release_cow_matches_reference():
    a = chain(np.arange(64), 16)
    b = chain(np.r_[np.arange(32), np.arange(900, 932)], 16)
    ops = [("acquire", a), ("acquire", a), ("acquire", b),
           ("release", 0), ("release", 0), ("release", 0), ("acquire", b)]
    ours, _ = run_both(ops, pages_per_chunk=2, page_bytes=100.0)
    st_ = ours.stats()
    assert st_["prefix_requests"] == 4 and st_["prefix_hits"] == 3
    assert ours.match(a) == 4 and ours.match(b) == 4


def test_prefix_cache_eviction_lru_leaf_first_matches_reference():
    a = chain(np.arange(40), 10)
    b = chain(np.arange(500, 540), 10)
    c = chain(np.arange(700, 720), 10)
    ops = [("acquire", a), ("acquire", b), ("release", 0), ("release", 0),
           ("acquire", c), ("acquire", a), ("release", 1)]
    ours, _ = run_both(ops, pages_per_chunk=1, page_bytes=10.0, capacity_pages=4)
    assert ours.evictions > 0 and ours.resident_pages() <= 4


# the universe of tests/test_prefix_props.py: two root streams and their
# mid-chain divergences, built with the real chained hash
_CHAINS = []
for _root in (0, 1):
    _base = np.arange(24) + _root * 1000
    _CHAINS.append(chain(_base, 4))
    for _d in range(1, 6):
        _CHAINS.append(chain(np.r_[_base[:4 * _d],
                                   np.arange(24 - 4 * _d) + 9000 + _root * 100 + _d * 17], 4))

_OPS = st.lists(st.one_of(
    st.tuples(st.just("acquire"), st.integers(0, len(_CHAINS) - 1)),
    st.tuples(st.just("release"), st.integers(0, 31))), min_size=1, max_size=40)


@settings(max_examples=60, deadline=None)
@given(ops=_OPS, ppc=st.integers(1, 3), cap_chunks=st.one_of(st.none(), st.integers(2, 12)))
def test_random_traffic_matches_reference_and_verifies(ops, ppc, cap_chunks):
    ops = [(op, _CHAINS[arg] if op == "acquire" else arg) for op, arg in ops]
    ours, _ = run_both(ops, pages_per_chunk=ppc, page_bytes=64.0,
                       capacity_pages=None if cap_chunks is None else cap_chunks * ppc)
    if ours.capacity_pages is not None:
        assert ours.resident_pages() <= ours.capacity_pages


def test_device_seed_cache_matches_reference():
    caches = (prefix.DeviceSeedCache(max_entries=2), ref_prefix.DeviceSeedCache(max_entries=2))
    steps = [("put", (1, 2, 3), "A"), ("match", (1, 2, 3)), ("match", (1, 2, 9)),
             ("match", (9, 2, 3)), ("lookup", (1, 2, 9), 2), ("put", (4, 5), "B"),
             ("lookup", (1, 2, 3), 1), ("put", (6, 7), "C"), ("match", (1, 2, 3)),
             ("match", (4, 5, 1)), ("lookup", (4, 5), 2), ("match", (6, 7, 8)),
             ("put", (), "empty"), ("match", ()), ("lookup", (9,), 1)]
    for step in steps:
        got = [getattr(c, step[0])(*step[1:]) if step[0] != "put"
               else c.put(step[1], {"k": step[2]}) for c in caches]
        assert got[0] == got[1], step
    assert caches[0].match((4, 5)) == 0 and caches[0].match((6, 7)) == 2


# ------------------------------------------------- cost, leases, scheduler

@pytest.mark.parametrize("k", [0, 3, 6, 15, 99])
def test_chunk_plan_prefix_hit_matches_reference(k):
    from repro.core import mbkr as ref_mbkr
    from repro_torch.core import mbkr
    got = ChunkPlan.build(32768, [2048] * 16, cm.StageModel.build(get_config("qwen3-8b"), 16, 1),
                          cm.WSC_PAPER, mbkr_plan=mbkr.plan(16, 16), prefix_hit_chunks=k)
    want = RefChunkPlan.build(32768, [2048] * 16,
                              ref_cm.StageModel.build(ref_config("qwen3-8b"), 16, 1),
                              ref_cm.WSC_PAPER, mbkr_plan=ref_mbkr.plan(16, 16),
                              prefix_hit_chunks=k)
    for f in ("dur", "comm", "kvb", "spill_t", "fetch_t", "serve_t"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert (got.chunks, got.p2) == (want.chunks, want.p2)
    if 0 < k < 16:
        assert (got.dur[:min(k, 15)] == 0).all() and got.dur[-1] > 0


@pytest.mark.parametrize("seq_len,shared", [(4096, [2, 1, 0, 0]), (2560, [2, 2, 1, 9]),
                                            (2560, [2, 2, 0, 0]), (None, [1, 0, 0, 0])])
def test_shared_page_bytes_match_reference(seq_len, shared):
    kvb, chunks = [4096.0] * 4, [1024] * 4
    got = chunk_page_bytes(kvb, chunks, seq_len, 512, shared_pages=shared)
    assert got == ref_chunk_page_bytes(kvb, chunks, seq_len, 512, shared_pages=shared)


SEQ_SIM = 32768
PREFIX_CHUNKS = 6


def sim_engine(pkg, **kw):
    ours = pkg is engine
    cfg = (get_config if ours else ref_config)("qwen3-8b")
    hw = (cm if ours else ref_cm).WSC_PAPER
    ec = pkg.EngineConfig(model=cfg, hw=hw, num_stages=16, tp=1, num_chunks=16,
                          max_batch=8, buckets=(SEQ_SIM,), partition="uniform",
                          sa_iters=8, inflight=2, **kw)
    return pkg.ContinuousEngine(ec, pkg.SimExecutor(cfg, hw))


def sim_chains(n_req, n_prefixes=2):
    return [tuple([(i % n_prefixes + 1) * 10_000 + j for j in range(PREFIX_CHUNKS)]
                  + [(i + 1) * 1_000_000 + j for j in range(16 - PREFIX_CHUNKS)])
            for i in range(n_req)]


def close(got, want):
    np.testing.assert_allclose(np.asarray(got, float), np.asarray(want, float),
                               rtol=1e-12, atol=0)


def same_metrics(got, want):
    assert set(got) == set(want)
    for key, v in want.items():
        if isinstance(v, float) and not np.isnan(v):
            assert got[key] == pytest.approx(v, rel=1e-12, abs=0), key
        elif not isinstance(v, float):
            assert got[key] == v, key


@pytest.mark.parametrize("mode,min_pages,n_prefixes", [
    ("on", 1, 2), ("on", 1, 1), ("on", 10 ** 9, 1), ("off", 1, 2)])
def test_scheduler_prefix_stream_matches_reference(mode, min_pages, n_prefixes):
    """Admissions, finish times, lease timelines, metrics and
    ``prefix_stats`` of the same shared-prefix stream: equal to the
    reference's; the index verifies after the run."""
    engines = []
    for pkg in (engine, ref_engine):
        eng = sim_engine(pkg, prefix_cache=mode, prefix_min_pages=min_pages)
        for i, ch in enumerate(sim_chains(8, n_prefixes)):
            eng.submit(pkg.Request(rid=i, arrival=0.01 * i, seq_len=SEQ_SIM,
                                   prefix_hashes=ch))
        eng.run_until_drained()
        engines.append(eng)
    got, want = engines
    assert [r.rid for r in got.done] == [r.rid for r in want.done]
    close([r.finish_time for r in got.done], [r.finish_time for r in want.done])
    close(got.lease.hwm, want.lease.hwm)
    assert got.lease.refusals == want.lease.refusals
    for a, b in zip(got.lease._timeline, want.lease._timeline):
        assert len(a) == len(b)
        close(a, b) if a else None
    same_metrics(got.metrics(), want.metrics())
    assert got.prefix_stats() == pytest.approx(want.prefix_stats(), rel=1e-12)
    if mode == "on":
        prefix.verify_prefix_index(got.prefix_cache)
        assert got.prefix_stats()["prefix_hits"] == 8 - n_prefixes
    else:
        assert got.prefix_cache is None and got.prefix_stats() == {}
    # the fleet signals: a quote with the resident prefix, and its pages
    probe = sim_chains(9, n_prefixes)[-1]
    assert got.estimate_admission(SEQ_SIM, prefix_hashes=probe) == \
        pytest.approx(want.estimate_admission(SEQ_SIM, prefix_hashes=probe), rel=1e-12)
    assert got.prefix_hit_pages(probe) == want.prefix_hit_pages(probe)
    assert isinstance(got, engine.CellHandle)


def test_engine_hashes_submitted_tokens_like_reference():
    toks = np.random.default_rng(2).integers(0, 1000, SEQ_SIM)
    hashes = []
    for pkg in (engine, ref_engine):
        eng = sim_engine(pkg, prefix_cache="on")
        r = pkg.Request(rid=0, arrival=0.0, seq_len=SEQ_SIM - 100, tokens=toks.copy())
        eng.submit(r)
        hashes.append(r.prefix_hashes)
    assert hashes[0] == hashes[1] and len(hashes[0]) == 15     # the partial tail unhashed


# ------------------------------------------------------ the device leg (CPU)

REFERENCE = r"""
import sys
import jax, numpy as np
from repro import compat
from repro.compat import AxisType
from repro.configs.base import RunConfig, get_smoke_config, replace
from repro.core import costmodel as cm
from repro.core import pipeline as pp
from repro.core import transport as tx
from repro.models.api import build_model
from repro.models.topology import Topology
from repro.runtime.engine import ContinuousEngine, EngineConfig, JaxExecutor, Request

N, M, C, B, K = {N}, {M}, {C}, {B}, {K}
CASES = {CASES!r}
cfg = replace(get_smoke_config("qwen3-8b"), dtype="float32")
mesh = compat.make_mesh((N, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
topo = Topology(mesh=mesh)
params = build_model(cfg).init(jax.random.key(0))
toks = np.asarray(jax.random.randint(jax.random.key(1), (B, M * C), 0, cfg.vocab_size))
out = {{"tokens": toks}}
for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
    out["param/" + "/".join(str(k.key) for k in path)] = np.asarray(leaf)
garb = toks.copy()
garb[:, :K * C] = 7
compat.set_mesh(mesh)
for name, (remote, kv) in CASES.items():
    run = RunConfig(num_chunks=M, num_stages=N, remote_attn=remote, attn_backend="jnp",
                    kv_dtype=kv)
    plan = pp.build_plan(cfg, N, M * C, run)
    staged = pp.stage_params(cfg, params, plan)
    logits, pool = jax.jit(lambda st, tk: pp.prefill_pipeline(
        cfg, st, tk, plan, topo, return_kv=True))(staged, toks)
    pool = jax.tree.map(np.asarray, pool)
    seeded, led = jax.jit(lambda st, tk, pl: pp.prefill_pipeline(
        cfg, st, tk, plan, topo, prefix_chunks=K, prefix_pool=pl,
        return_ledger=True))(staged, garb, pool)
    out[name + "/logits"] = np.asarray(logits, np.float32)
    out[name + "/seeded"] = np.asarray(seeded, np.float32)
    for k, v in tx.ledger_to_dict(led).items():
        out[name + "/ledger/" + k] = np.float64(v)

# the JaxExecutor round trip of tests/test_prefix.py
run = RunConfig(num_chunks=M, num_stages=N, remote_attn="fetch")
plan = pp.build_plan(cfg, N, M * C, run)
staged = pp.stage_params(cfg, params, plan)
rng = np.random.default_rng(1)
pref = rng.integers(0, cfg.vocab_size, 64).astype(np.int32)
TOKS = []
for i in range(3):
    t = rng.integers(0, cfg.vocab_size, M * C).astype(np.int32)
    t[:64] = pref
    TOKS.append(t)
ec = EngineConfig(model=cfg, hw=cm.TPU_V5E, num_stages=N, tp=1, num_chunks=M,
                  max_batch=1, buckets=(M * C,), partition="uniform", prefix_cache="on")
ex = JaxExecutor(cfg, staged, topo, run)
eng = ContinuousEngine(ec, ex)
for i, t in enumerate(TOKS):
    eng.submit(Request(rid=i, arrival=0.0, seq_len=M * C, tokens=t.copy()))
eng.run_until_drained()
out["engine/ks"] = np.array([w["prefix_chunks"] for w in ex.waves])
for r in eng.done:
    out["engine/logits/%d" % r.rid] = np.asarray(r.result, np.float32)
for k, v in eng.prefix_stats().items():
    out["engine/stats/" + k] = np.float64(v)
np.savez(sys.argv[1], **out)
print("DONE")
""".format(N=N, M=M, C=C, B=B, K=REF_K, CASES=REF_CASES)


def _unflatten(flat, pfx):
    tree = {}
    for key, val in flat.items():
        if not key.startswith(pfx):
            continue
        *path, leaf = key[len(pfx):].split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = val
    return tree


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "ref.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", REFERENCE, str(path)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and "DONE" in r.stdout, r.stdout + r.stderr
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


CFG = replace(get_smoke_config("qwen3-8b"), dtype="float32")
_STAGED = {}


def setup(remote="qship", pool="cuda", kv="auto"):
    run = RunConfig(num_chunks=M, num_stages=N, remote_attn=remote, kv_dtype=kv,
                    attn_backend="torch" if pool == "torch" else "cuda", pool_backend=pool)
    plan = pp.build_plan(CFG, N, M * C, run)
    if "w" not in _STAGED:
        _STAGED["w"] = init_staged(CFG, plan, torch.Generator().manual_seed(0), device="cpu")
    toks = np.random.default_rng(0).integers(0, CFG.vocab_size, (B, M * C))
    return run, plan, _STAGED["w"], toks


def clone(pool: PagedPool) -> PagedPool:
    return PagedPool(*(None if getattr(pool, f) is None else getattr(pool, f).clone()
                       for f in FIELDS))


def pools_equal(a: PagedPool, b: PagedPool) -> bool:
    return all((getattr(a, f) is None and getattr(b, f) is None)
               or torch.equal(getattr(a, f), getattr(b, f)) for f in FIELDS)


@pytest.mark.parametrize("kv", ["auto", "int8"])
@pytest.mark.parametrize("pool", ["torch", "cuda", "paged"])
@pytest.mark.parametrize("remote", ["qship", "fetch"])
def test_seeded_garbage_run_is_bit_identical(remote, pool, kv):
    """``return_kv`` leaves the logits bit-identical; seeded from that pool,
    with garbage in the first k chunks, every k in 1..min(p2, M-1) gives
    the unseeded logits bit for bit, charges ``prefix_hit`` its closed form,
    and leaves the caller's seed as it was; without the seed (k = 0) the
    garbage moves the logits."""
    _, plan, staged, toks = setup(remote, pool, kv)
    assert plan.p2 == 6 and min(plan.p2, M - 1) == 6
    base = pp.prefill_pipeline(CFG, staged, toks, plan, device="cpu")
    logits, kvp = pp.prefill_pipeline(CFG, staged, toks, plan, device="cpu", return_kv=True)
    assert torch.equal(logits, base)
    assert kvp.k.shape[:4] == (N, plan.slot_pages.size, plan.layers_per_stage, B)
    assert (kvp.k_scale is None) == (kv == "auto")
    seed = clone(kvp)
    for k in range(1, 7):
        garb = toks.copy()
        garb[:, :k * C] = 7
        out, led = pp.prefill_pipeline(CFG, staged, garb, plan, device="cpu",
                                       prefix_chunks=k, prefix_pool=kvp, return_ledger=True)
        assert torch.equal(out, base), (k, float((out - base).abs().max()))
        model = prefix_saved_model(plan, plan.layers_per_stage, B, C, CFG.num_kv_heads,
                                   CFG.resolved_head_dim, k)
        assert led["prefix_hit"] == model["ledger_bytes"] > 0
        assert pools_equal(kvp, seed), "the caller's seed pool changed"
    witness = pp.prefill_pipeline(CFG, staged, garb, plan, device="cpu", prefix_chunks=0,
                                  prefix_pool=kvp)
    assert float((witness - base).abs().max()) > 1e-2 * float(base.abs().max())


@pytest.mark.parametrize("arch,mode", [("qwen2-moe-a2.7b", "mocap"),
                                       ("granite-3-2b", "mocap"), ("qwen3-8b", "terapipe")])
def test_seeded_run_bit_identical_moe_granite_terapipe(arch, mode):
    """The other pool families and terapipe (p2 = M, so k reaches M - 1):
    every k bit-identical to the unseeded run, ``prefix_hit`` at its
    closed form."""
    cfg = replace(get_smoke_config(arch), dtype="float32")
    run = RunConfig(num_chunks=M, num_stages=N, mbkr=mode == "mocap", attn_backend="cuda",
                    pool_backend="paged")
    plan = pp.build_plan(cfg, N, M * C, run, mode=mode)
    staged = init_staged(cfg, plan, torch.Generator().manual_seed(0), device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, M * C))
    base, kvp = pp.prefill_pipeline(cfg, staged, toks, plan, device="cpu", return_kv=True)
    top = min(plan.p2, M - 1)
    assert top == (7 if mode == "terapipe" else 6)
    for k in range(1, top + 1):
        garb = toks.copy()
        garb[:, :k * C] = 5
        out, led = pp.prefill_pipeline(cfg, staged, garb, plan, device="cpu",
                                       prefix_chunks=k, prefix_pool=kvp, return_ledger=True)
        assert torch.equal(out, base), k
        assert led["prefix_hit"] == prefix_saved_model(
            plan, plan.layers_per_stage, B, C, cfg.num_kv_heads, cfg.resolved_head_dim,
            k)["ledger_bytes"]


def test_seeded_run_returns_a_reseedable_pool():
    """The pool a seeded run returns seeds the next run as well: two
    chained seeded runs with garbage hit regions stay bit-identical."""
    _, plan, staged, toks = setup("fetch", "paged", "int8")
    base, kvp = pp.prefill_pipeline(CFG, staged, toks, plan, device="cpu", return_kv=True)
    garb = toks.copy()
    garb[:, :6 * C] = 3
    out, kv2 = pp.prefill_pipeline(CFG, staged, garb, plan, device="cpu", prefix_chunks=6,
                                   prefix_pool=kvp, return_kv=True)
    out3 = pp.prefill_pipeline(CFG, staged, garb, plan, device="cpu", prefix_chunks=6,
                               prefix_pool=kv2)
    assert torch.equal(out, base) and torch.equal(out3, base)


@pytest.mark.parametrize("case", sorted(REF_CASES))
def test_prefix_ledger_and_logits_match_reference(reference, case):
    remote, kv = REF_CASES[case]
    run = RunConfig(num_chunks=M, num_stages=N, remote_attn=remote, kv_dtype=kv,
                    attn_backend="cuda", pool_backend="paged")
    plan = pp.build_plan(CFG, N, M * C, run)
    params = bridge.params_from_numpy(_unflatten(reference, "param/"), device="cpu")
    staged = pp.stage_params(CFG, params, plan)
    toks = reference["tokens"]
    base, kvp = pp.prefill_pipeline(CFG, staged, toks, plan, device="cpu", return_kv=True)
    garb = toks.copy()
    garb[:, :REF_K * C] = 7
    out, led = pp.prefill_pipeline(CFG, staged, garb, plan, device="cpu",
                                   prefix_chunks=REF_K, prefix_pool=kvp, return_ledger=True)
    assert torch.equal(out, base)
    for key, value in led.items():
        np.testing.assert_allclose(value, reference[f"{case}/ledger/{key}"], rtol=1e-6,
                                   err_msg=key)
    model = prefix_saved_model(plan, plan.layers_per_stage, B, C, CFG.num_kv_heads,
                               CFG.resolved_head_dim, REF_K)
    assert led["prefix_hit"] == model["ledger_bytes"]
    want = reference[f"{case}/seeded"]
    np.testing.assert_array_equal(want, reference[f"{case}/logits"])
    rel = np.abs(out.numpy() - want) / (np.abs(want) + 1e-3)
    if kv == "int8":
        assert (out.numpy().argmax(-1) == want.argmax(-1)).all()
        assert np.percentile(rel, 99) < 1e-2, np.percentile(rel, 99)
    else:
        assert rel.max() < 2e-3, rel.max()


def test_prefix_pipeline_refusals():
    _, plan, staged, toks = setup()
    _, kvp = pp.prefill_pipeline(CFG, staged, toks, plan, device="cpu", return_kv=True)
    with pytest.raises(ValueError):          # a hit needs a seed
        pp.prefill_pipeline(CFG, staged, toks, plan, device="cpu", prefix_chunks=2)
    with pytest.raises(ValueError):          # beyond min(p2, M - 1)
        pp.prefill_pipeline(CFG, staged, toks, plan, device="cpu", prefix_chunks=7,
                            prefix_pool=kvp)
    with pytest.raises(ValueError):          # a seed of another geometry
        pp.prefill_pipeline(CFG, staged, toks[:1], plan, device="cpu", prefix_chunks=2,
                            prefix_pool=kvp)
    gplan = pp.build_plan(CFG, N, M * C, RunConfig(num_chunks=2, num_stages=N), mode="gpipe")
    with pytest.raises(ValueError):
        pp.prefill_pipeline(CFG, staged, toks, gplan, device="cpu", return_kv=True)
    scfg = replace(get_smoke_config("mamba2-130m"), dtype="float32")
    splan = pp.build_plan(scfg, N, M * C, RunConfig(num_chunks=M, num_stages=N))
    sstaged = init_staged(scfg, splan, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError):
        pp.prefill_pipeline(scfg, sstaged, toks, splan, device="cpu", return_kv=True)


def serve_stream(run, staged, toks_list, mode, max_batch, kv="auto"):
    ec = engine.EngineConfig(model=CFG, hw=cm.TPU_V5E, num_stages=N, tp=1, num_chunks=M,
                             max_batch=max_batch, buckets=(M * C,), partition="uniform",
                             prefix_cache=mode, kv_dtype=kv)
    ex = engine.TorchExecutor(CFG, staged, run, device="cpu")
    eng = engine.ContinuousEngine(ec, ex)
    for i, t in enumerate(toks_list):
        eng.submit(engine.Request(rid=i, arrival=0.0, seq_len=M * C, tokens=t.copy()))
    eng.run_until_drained()
    return eng, ex


def test_engine_round_trip_matches_reference(reference):
    """``tests/test_prefix.py``'s JaxExecutor round trip on the port's
    TorchExecutor: off and on bit-identical per request; the same waves
    seeded (cold, then k = 4) and the same ``prefix_stats`` as the
    reference's; logits within the pipeline's 2e-3 of the reference's."""
    run = RunConfig(num_chunks=M, num_stages=N, remote_attn="fetch", attn_backend="cuda",
                    pool_backend="cuda")
    plan = pp.build_plan(CFG, N, M * C, run)
    params = bridge.params_from_numpy(_unflatten(reference, "param/"), device="cpu")
    staged = pp.stage_params(CFG, params, plan)
    rng = np.random.default_rng(1)
    pref = rng.integers(0, CFG.vocab_size, 64).astype(np.int32)
    toks = []
    for _ in range(3):
        t = rng.integers(0, CFG.vocab_size, M * C).astype(np.int32)
        t[:64] = pref
        toks.append(t.astype(np.int64))
    off, ex_off = serve_stream(run, staged, toks, "off", 1)
    on, ex_on = serve_stream(run, staged, toks, "on", 1)
    assert all(w["prefix_chunks"] == 0 for w in ex_off.waves)
    ks = [w["prefix_chunks"] for w in ex_on.waves]
    assert ks == reference["engine/ks"].tolist() == [0, 4, 4]
    assert ex_on.prefix_device_hit_chunks == 8
    res_off = {r.rid: r.result for r in off.done}
    for r in on.done:
        np.testing.assert_array_equal(r.result, res_off[r.rid])
        want = reference[f"engine/logits/{r.rid}"]
        assert (np.abs(r.result - want) / (np.abs(want) + 1e-3)).max() < 2e-3
    want = {k[len("engine/stats/"):]: float(v) for k, v in reference.items()
            if k.startswith("engine/stats/")}
    assert on.prefix_stats() == pytest.approx(want, rel=1e-12)
    for w in ex_on.waves[1:]:
        assert w["seed_bytes"] == w["snap_bytes"] > 0 and w["seed_h2d_s"] >= 0
    cache = ex_on._seed_caches[(M * C, M)]
    snap = cache.lookup(on.done[0].prefix_hashes, 4)
    assert all(x is None or (x.device.type == "cpu" and x.shape[3] == plan.page_tokens)
               for x in snap.values())


@pytest.mark.parametrize("kv", ["auto", "int8"])
def test_engine_shared_prefix_waves_seed_six_chunks(kv):
    """Six requests sharing their first 6 chunks, two a wave: the first wave
    cold, every later one seeded with k = 6; every request's logits equal
    the prefix-off run's bit for bit; the hits equal the analytic
    scheduler's on the same stream."""
    run, plan, staged, _ = setup("qship", "paged", kv)
    rng = np.random.default_rng(4)
    common = rng.integers(0, CFG.vocab_size, 6 * C)
    toks = []
    for _ in range(6):
        t = rng.integers(0, CFG.vocab_size, M * C)
        t[:6 * C] = common
        toks.append(t)
    off, _ = serve_stream(run, staged, toks, "off", 2, kv)
    on, ex = serve_stream(run, staged, toks, "on", 2, kv)
    assert [w["prefix_chunks"] for w in ex.waves] == [0, 6, 6]
    res_off = {r.rid: r.result for r in off.done}
    for r in on.done:
        np.testing.assert_array_equal(r.result, res_off[r.rid])
    assert on.prefix_stats()["prefix_hits"] == 5
    sim = engine.ContinuousEngine(on.ec, engine.SimExecutor(CFG, cm.TPU_V5E))
    for i, t in enumerate(toks):
        sim.submit(engine.Request(rid=i, arrival=0.0, seq_len=M * C, tokens=t.copy()))
    sim.run_until_drained()
    assert sim.prefix_stats() == on.prefix_stats()


# ---------------------------------------------------------------- cold tier

def _tier_inputs(pkg_mbkr, pkg_pages, pkg_quant, kv):
    pl = pkg_mbkr.plan(16, 16)
    geom = pkg_pages.page_geometry(128, pl.num_slots, 32)
    return pl, geom, pkg_pages.build_slot_pages(geom), pkg_quant.get_codec(kv)


@pytest.mark.parametrize("kv", ["int8", "bfloat16", "fp8"])
@pytest.mark.parametrize("hot_frac,cold_bw,host", [(0.5, 1e12, False), (0.5, 1.0, False),
                                                   (0.25, 1e12, True), (2.0, 0.0, False)])
def test_plan_tiers_matches_reference(kv, hot_frac, cold_bw, host):
    from repro.core import mbkr as ref_mbkr
    from repro.kvstore import pages as ref_pages
    from repro.kvstore import quant as ref_quant
    from repro_torch.core import mbkr
    from repro_torch.kvstore import pages, quant
    dims = dict(lps=4, b=1, kvh=8, hd=128)
    plans = []
    for mods, tmod in (((mbkr, pages, quant), tiers), ((ref_mbkr, ref_pages, ref_quant),
                                                       ref_tiers)):
        pl, geom, tbl, codec = _tier_inputs(*mods, kv)
        cb = tmod.chunk_page_bytes(geom, codec, **dims)
        host_slots = (np.unique(np.concatenate([pl.host_slot_a[pl.p2:],
                                                pl.host_slot_b[pl.p2:]])) if host else None)
        spec = tmod.TierSpec(hot_bytes=cb * pl.p2 * hot_frac, cold_bw=cold_bw)
        plans.append((cb, tmod.plan_tiers(geom, codec, tbl, pl.own_slot, pl.p2, 16, spec,
                                          **dims, tick_s=np.full(16, 1e-3),
                                          host_slots=host_slots)))
    (cb, got), (cb_ref, want) = plans
    assert cb == cb_ref
    np.testing.assert_array_equal(got.tier_of, want.tier_of)
    assert got.summary() == want.summary()
    assert [(o.chunk, o.pages, o.due_tick, o.issue_tick, o.nbytes) for o in got.prefetch] == \
        [(o.chunk, o.pages, o.due_tick, o.issue_tick, o.nbytes) for o in want.prefetch]


@pytest.mark.parametrize("kv", ["bfloat16", "int8", "fp8"])
@pytest.mark.parametrize("mbkr", [True, False])
def test_max_seq_len_for_budget_matches_reference(kv, mbkr):
    from repro.kvstore import quant as ref_quant
    from repro_torch.kvstore import quant
    kw = dict(kv_token_bytes=4096.0, num_chunks=16, num_stages=16, page_tokens=64,
              head_dim=128, mbkr=mbkr)
    got = tiers.max_seq_len_for_budget(1e9, codec=quant.get_codec(kv), **kw)
    assert got == ref_tiers.max_seq_len_for_budget(1e9, codec=ref_quant.get_codec(kv), **kw)
    assert got > 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8, torch.float8_e4m3fn])
def test_host_offload_stager_round_trip_cpu(dtype):
    """Pages go to host memory and come back byte-equal; the offloaded
    pages read zero in between, the rest are untouched; another device's
    tensor is refused."""
    gen = torch.Generator().manual_seed(0)
    pages = (torch.randn((8, 2, 4, 2, 8), generator=gen) * 20).to(dtype)
    ref = pages.clone()
    st_ = tiers.HostOffloadStager(device="cpu")
    parked = st_.offload("k", pages, [1, 5, 6])
    assert parked is pages and st_.host_bytes() == 3 * ref[0].numel() * ref.element_size()
    raw = parked.view(torch.uint8) if dtype == torch.float8_e4m3fn else parked
    assert (raw[[1, 5, 6]] == 0).all()
    keep = [0, 2, 3, 4, 7]
    assert torch.equal(raw[keep], (ref.view(torch.uint8) if dtype == torch.float8_e4m3fn
                                   else ref)[keep])
    back = st_.restore("k", parked)
    assert torch.equal(back.view(torch.uint8), ref.view(torch.uint8))
    assert st_.host_bytes() == 0
    with pytest.raises(ValueError):
        tiers.HostOffloadStager(device="cpu")._ids(torch.empty(0, device="meta"), [0])


def test_serve_kv_offload_prints_the_reference_tier_summary():
    """``serve --kv-offload --device cpu``: the tier summary line of the
    reference's ``_print_tier_summary`` on the same model and engine
    geometry, after the port's header (analytic, the profile's name, the
    reference's TPU link)."""
    from repro.configs.base import get_smoke_config as ref_smoke
    from repro.launch.serve import _print_tier_summary
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--smoke", "--device", "cpu",
           "--requests", "2", "--seq", "128", "--num-chunks", "8", "--num-stages", "8",
           "--kv-offload", "--kv-dtype", "int8"]
    r = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    line = next(x for x in r.stdout.splitlines() if x.startswith("[kv-offload]"))
    assert "analytic (tpu-v5e" in line and "REF_TPU_H2D_BW" in line
    ec = ref_engine.EngineConfig(model=ref_smoke("qwen3-8b"), hw=ref_cm.TPU_V5E, num_stages=8,
                                 tp=1, num_chunks=8, buckets=(128,), partition="uniform")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _print_tier_summary(ec.model, ec, "int8", 0)
    want = buf.getvalue().strip()
    body = lambda s: s[s.index("bucket "):]
    assert body(line) == body(want), (line, want)
    assert re.search(r"pages \{'hot': \d+, 'warm': \d+, 'cold': \d+\}", line)


def test_serve_cli_prefix_cache_on_cpu():
    """``--scheduler continuous --prefix-cache on --shared-prefix``: the
    stats printed, five hits of six, the later waves seeded with 6 chunks."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--smoke", "--device", "cpu",
           "--requests", "6", "--seq", "128", "--num-chunks", "8", "--num-stages", "8",
           "--scheduler", "continuous", "--max-batch", "2", "--prefix-cache", "on",
           "--shared-prefix", "96", "--pool-backend", "paged"]
    r = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "'prefix_hits': 5" in r.stdout
    assert "[prefix] seeded chunks per wave: 0 6 6" in r.stdout
