"""The three chunk-attention kernels' plain versions (``repro_torch.kernels
.ref``, which the CPU wrappers in ``repro_torch.kernels.ops`` take) against
the reference Pallas kernels run as the JAX tests run them (interpret mode
off the TPU), plus the stage-group axis, the invalid-slot identity and the
three ``pool_scan`` traversal orders.

Tolerances: atol 1e-5 on m, l, acc and out for float pages and 1e-4 for
int8/fp8 pages (both sides dequantize the same payloads; the gap is fp32
summation order); the traversal orders agree to 1e-6 (DESIGN.md §3.5)."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import chunk_attn as ref_ca
from repro.kernels import ops as ref_ops
from repro_torch.core import attention as A
from repro_torch.kernels import ops, ref
from repro_torch.kvstore import pages as kvpages
from repro_torch.kvstore import quant as kvquant
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401

B, C, H, KVH, D = 2, 16, 4, 2, 16          # GQA g = 2
NEG_INF = -1e30
# (H, KVH, D) of the plain-vs-Pallas cases: the smoke head shape (G 2,
# D 16); D 64 with G 3 (granite-moe-3b-a800m's grouping); D 80, MHA
# (stablelm-3b)
HEAD_SHAPES = {"d16": (H, KVH, D), "d64_g3": (6, 2, 64), "d80": (2, 2, 80)}


def _randn(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _quant(x: np.ndarray, kind: str, axes):
    """A payload (numpy for the reference, torch for the port) and fp32
    scales with amax over ``axes``: the page store's codecs."""
    target = kvquant.INT8_MAX if kind == "int8" else kvquant.FP8_MAX
    sc = np.maximum(np.abs(x).max(axis=axes, keepdims=True), 1e-6) / target
    t = torch.from_numpy(x / sc)
    if kind == "int8":
        q = torch.clamp(torch.round(t), -127, 127).to(torch.int8)
        return q, jnp.asarray(q.numpy()), sc.astype(np.float32)
    q = t.to(torch.float8_e4m3fn)
    return q, jnp.asarray(q.view(torch.uint8).numpy().view(jnp.float8_e4m3fn)), \
        sc.astype(np.float32)


def _close(got, want, atol, scaled=False):
    """Each output within ``atol``; ``scaled``: within ``atol`` of its own
    max|ref| when that exceeds 1 (the HEAD_SHAPES cases past the smoke
    one, whose l reaches ~15 at D 80, where fp32 summation order alone
    moves it by more than 1e-5)."""
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        tol = atol * max(1.0, float(np.abs(w).max())) if scaled else atol
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0, atol=tol)


# ------------------------------------------------------------------ K1

@pytest.mark.parametrize("heads", list(HEAD_SHAPES))
@pytest.mark.parametrize("offset,t,kv_len", [(0, C, C), (C, 2 * C, 2 * C),
                                             (C, 2 * C, 2 * C - 5), (0, C, C - 3)])
def test_chunk_attention_plain_matches_pallas(offset, t, kv_len, heads):
    h, kvh, d = HEAD_SHAPES[heads]
    q, k, v = _randn(B, C, h, d), _randn(B, t, kvh, d, seed=1), _randn(B, t, kvh, d, seed=2)
    want = ref_ca.chunk_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal_offset=offset,
        kv_len=kv_len, block_q=C, block_k=min(t, 16), interpret=True, return_state=True)
    got = ops.chunk_attention(*map(torch.from_numpy, (q, k, v)), causal_offset=offset,
                              kv_len=kv_len, return_state=True)
    _close(got, want, 1e-5, scaled=heads != "d16")
    assert ops.LAUNCHES["chunk_attention"] == 0      # the CPU never launches


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_chunk_attention_quantized_matches_pallas(kind):
    q = _randn(B, C, H, D)
    kq, rkq, ks = _quant(_randn(B, C, KVH, D, seed=3), kind, (1, 3))
    vq, rvq, vs = _quant(_randn(B, C, KVH, D, seed=4), kind, (1, 3))
    ks = np.broadcast_to(ks, (B, C, KVH, 1))[..., 0].copy()
    vs = np.broadcast_to(vs, (B, C, KVH, 1))[..., 0].copy()
    want = ref_ops.chunk_attention(jnp.asarray(q), rkq, rvq, causal_offset=C,
                                   return_state=True, k_scale=jnp.asarray(ks),
                                   v_scale=jnp.asarray(vs))
    got = ops.chunk_attention(torch.from_numpy(q), kq, vq, causal_offset=C,
                              return_state=True, k_scale=torch.from_numpy(ks),
                              v_scale=torch.from_numpy(vs))
    _close(got, want, 1e-4)


def test_full_attention_is_offset_past_last_key():
    q, k, v = _randn(B, C, H, D), _randn(B, 24, KVH, D, seed=1), _randn(B, 24, KVH, D, seed=2)
    got = ops.full_attention(*map(torch.from_numpy, (q, k, v)))
    want = ref_ops.full_attention(*map(jnp.asarray, (q, k, v)))
    _close([got], [want], 1e-5)


# ------------------------------------------ K1's tensor-core tile algorithm

def _online_tiles(qf, tiles, scale, split):
    """The consumer warpgroup's arithmetic of the tensor-core body
    (``csrc/chunk_attn_tc.cuh``) over a sequence of 64-key tiles, in torch
    on the CPU. qf [b, c, kvh, g, d] fp32 (values exact in bf16); each tile
    (kt, vt, ksc, vsc, visible): k/v values [b, n, kvh, d] fp32 (bf16, or
    int8 / fp8 payloads), per-key scales [b, n, kvh] or None, and the keys
    each query sees, broadcastable to [c, n]. S in fp32, the k scale on
    the score columns and the mask before the exponential with a running
    max; l of the unscaled p; the v scale folded into p, then P·V as
    hi·V + lo·V with hi = bf16(p), lo = bf16(p - hi) (``split``), or P
    rounded once to bf16. Returns (m, l) [b, kvh, g, c] and acc
    [b, kvh, g, c, d] fp32."""
    b, c, kvh, g, d = qf.shape
    m = torch.full((b, kvh, g, c), NEG_INF)
    l = torch.zeros((b, kvh, g, c))
    acc = torch.zeros((b, kvh, g, c, d))
    for kt, vt, ksc, vsc, visible in tiles:
        s = torch.einsum("bckgd,btkd->bkgct", qf, kt) * scale
        if ksc is not None:
            s = s * ksc.transpose(1, 2)[:, :, None, None, :]
        s = torch.where(visible, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        m_safe = torch.where(m_new < NEG_INF / 2, torch.zeros_like(m_new), m_new)
        corr = torch.exp(m - m_safe)
        p = torch.exp(s - m_safe[..., None])
        l = l * corr + p.sum(-1)
        if vsc is not None:
            p = p * vsc.transpose(1, 2)[:, :, None, None, :]
        hi = p.bfloat16().float()
        pv = torch.einsum("bkgct,btkd->bkgcd", hi, vt)
        if split:
            pv = pv + torch.einsum("bkgct,btkd->bkgcd", (p - hi).bfloat16().float(), vt)
        acc = acc * corr[..., None] + pv
        m = m_new
    return m, l, acc


def _as_kernel_state(m, l, acc):
    """[b, kvh, g, c(, d)] -> (m, l) [b, H, c] and acc [b, c, H, d]."""
    b, kvh, g, c, d = acc.shape
    return (m.reshape(b, kvh * g, c), l.reshape(b, kvh * g, c),
            acc.permute(0, 3, 1, 2, 4).reshape(b, c, kvh * g, d))


def _tile_emulation(q, k, v, k_scale=None, v_scale=None, *, causal_offset, kv_len,
                    split=True):
    """K1's tensor-core body on the CPU (``_online_tiles``): the 64-key
    tiles of k/v [B,T,KVH,D] up to the last key a query of the chunk sees,
    the causal mask and kv_len before the exponential. Returns (m, l)
    [B,H,C] and acc [B,C,H,D] fp32, as the kernel does."""
    b, c, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, c, kvh, h // kvh, d)
    qpos = torch.arange(c)[:, None] + causal_offset
    rows = max(0, min(kv_len, c + causal_offset))

    def tiles():
        for k0 in range(0, rows, 64):
            keys = slice(k0, min(k0 + 64, t))
            kpos = torch.arange(k0, keys.stop)[None, :]
            yield (k[:, keys].float(), v[:, keys].float(),
                   None if k_scale is None else k_scale[:, keys],
                   None if v_scale is None else v_scale[:, keys],
                   (kpos <= qpos) & (kpos < kv_len))
    return _as_kernel_state(*_online_tiles(qf, tiles(), 1.0 / math.sqrt(d), split))


def _stack_emulation(q, k, v, valid, k_scale=None, v_scale=None, *, kv_len, split=True):
    """K2's tensor-core body on the CPU (``_online_tiles``): for the rows of
    each group g, the 64-key tiles below kv_len of each valid slot of
    ``valid[g]``, slot by slot (SlotCursor), every such key visible, the
    ragged tail tile masked before the exponential. q [G*B,C,H,D]; k/v
    [S,G*B,T,KVH,D], scales [S,G*B,T,KVH]. Returns (m, l) [G*B,H,C] and acc
    [G*B,C,H,D] fp32; a group with no valid slot keeps (-1e30, 0, 0)."""
    gb, c, h, d = q.shape
    t, kvh = k.shape[2], k.shape[3]
    ng = valid.shape[0]
    rows_g = gb // ng
    parts = []
    for g in range(ng):
        rows = slice(g * rows_g, (g + 1) * rows_g)
        qf = q[rows].float().reshape(rows_g, c, kvh, h // kvh, d)

        def tiles():
            for s in np.flatnonzero(np.asarray(valid[g])):
                for k0 in range(0, kv_len, 64):
                    keys = slice(k0, min(k0 + 64, t))
                    kpos = torch.arange(k0, keys.stop)[None, :]
                    yield (k[s, rows, keys].float(), v[s, rows, keys].float(),
                           None if k_scale is None else k_scale[s, rows, keys],
                           None if v_scale is None else v_scale[s, rows, keys],
                           kpos < kv_len)
        parts.append(_as_kernel_state(*_online_tiles(qf, tiles(), 1.0 / math.sqrt(d), split)))
    return tuple(torch.cat(x) for x in zip(*parts))


def _k1_inputs(kind, b, c, h, kvh, d, t):
    """bf16 q and k/v (bf16, or int8 / fp8 payloads with per-token scales
    [B,T,KVH] from the page codecs' rule), made with numpy from a seed."""
    q = torch.from_numpy(_randn(b, c, h, d, seed=31)).bfloat16()
    k, v = _randn(b, t, kvh, d, seed=32), _randn(b, t, kvh, d, seed=33)
    if kind == "bf16":
        return q, torch.from_numpy(k).bfloat16(), torch.from_numpy(v).bfloat16(), None, None
    kq, _, ks = _quant(k, kind, (3,))
    vq, _, vs = _quant(v, kind, (3,))
    return q, kq, vq, torch.from_numpy(ks[..., 0]), torch.from_numpy(vs[..., 0])


# (causal_offset, T, kv_len) in units of C: a causal self block, a fully
# visible stored chunk, and a prefix with kv_len < T, T no multiple of 64
K1_MASKS = {"causal": lambda c: (0, c, c), "full": lambda c: (c, c, c),
            "prefix": lambda c: (c, 2 * c - 37, 2 * c - 77)}


# every mask x K/V kind with the hi/lo split; and P rounded once to bf16 (a
# plain tensor-core P·V), which must miss the card's 1e-3 check
K1_CASES = [(mask, kind, True) for mask in K1_MASKS for kind in ("bf16", "int8", "fp8")] \
    + [("causal", "bf16", False)]
# (H, KVH, D) of the models whose K1 runs the tensor-core body: qwen3-8b
# (and qwen2-moe-a2.7b's D 128), granite-3-2b, granite-moe-3b-a800m (G 3),
# stablelm-3b (D 80, MHA)
K1_HEADS = {"qwen3-8b": (32, 8, 128), "granite-3-2b": (32, 8, 64),
            "granite-moe-3b-a800m": (24, 8, 64), "stablelm-3b": (32, 32, 80)}


@pytest.mark.parametrize("heads", list(K1_HEADS))
@pytest.mark.parametrize("mask,kind,split", K1_CASES)
def test_k1_tile_algorithm_matches_plain(mask, kind, split, heads):
    """K1's tensor-core tile algorithm (hi/lo P·V, k scale on the scores, v
    scale in p) against ``chunk_attention_plain`` at each model's head
    shape (B and C cut to 1 and 128): acc, m and l within 1e-5 of their
    max|ref| — 100x inside the card's 1e-3 check. Without the split
    (``split=False``) acc is off by more than that 1e-3 of max|acc|: the
    split is what keeps K1 inside the check."""
    c = 128
    h, kvh, d = K1_HEADS[heads]
    off, t, kv_len = K1_MASKS[mask](c)
    q, k, v, ks, vs = _k1_inputs(kind, 1, c, h, kvh, d, t)
    got = _tile_emulation(q, k, v, ks, vs, causal_offset=off, kv_len=kv_len, split=split)
    _, *want = ref.chunk_attention_plain(q, k, v, causal_offset=off, kv_len=kv_len,
                                         k_scale=ks, v_scale=vs)
    if not split:
        assert (got[2] - want[2]).abs().max().item() > 1e-3 * want[2].abs().max().item()
        return
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= 1e-5 * w.abs().max().item()


def test_k1_tile_algorithm_matches_pallas():
    """The same emulation against the reference Pallas kernel (interpret
    mode) at a small size: two 64-key tiles, a prefix offset, kv_len < T."""
    b, c, h, kvh, d, t, off, kv_len = 1, 64, 4, 2, 32, 128, 64, 120
    q, k, v, _, _ = _k1_inputs("bf16", b, c, h, kvh, d, t)
    want = ref_ca.chunk_attention_pallas(
        *(jnp.asarray(x.float().numpy()) for x in (q, k, v)), causal_offset=off,
        kv_len=kv_len, block_q=c, block_k=16, interpret=True, return_state=True)
    got = _tile_emulation(q, k, v, causal_offset=off, kv_len=kv_len)
    for g, w in zip(got, want[1:]):
        w = np.asarray(w, np.float32)
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()


# ------------------------------------------ K2's tensor-core tile algorithm

K2_VALID = {"mixed": [[1, 0, 1, 1], [0, 1, 0, 0]], "none": [[0, 0, 0, 0], [0, 0, 0, 0]],
            "all": [[1, 1, 1, 1], [1, 1, 1, 1]]}


def _k2_inputs(kind, gb, c, h, kvh, d, s, t):
    """bf16 q [G*B,C,H,D] and k/v [S,G*B,T,KVH,D] (bf16, or int8 / fp8
    payloads with per-token scales [S,G*B,T,KVH]), made with numpy from a
    seed."""
    q = torch.from_numpy(_randn(gb, c, h, d, seed=41)).bfloat16()
    k, v = _randn(s, gb, t, kvh, d, seed=42), _randn(s, gb, t, kvh, d, seed=43)
    if kind == "bf16":
        return q, torch.from_numpy(k).bfloat16(), torch.from_numpy(v).bfloat16(), None, None
    kq, _, ks = _quant(k, kind, (4,))
    vq, _, vs = _quant(v, kind, (4,))
    return q, kq, vq, torch.from_numpy(ks[..., 0]), torch.from_numpy(vs[..., 0])


def _state_held(got, want, rel):
    """Entries where ``want`` holds the empty-row sentinel m = -1e30 are
    equal; every other entry of m, l and acc lies within ``rel`` of its
    tensor's max|want| (as ``chip_smoke.compare`` holds the card)."""
    for g, w in zip(got, want):
        empty = w <= NEG_INF / 10
        assert torch.equal(g[empty], w[empty])
        g, w = g[~empty], w[~empty]
        if w.numel():
            assert (g - w).abs().max().item() <= rel * w.abs().max().item()


# every valid pattern x K/V kind with the hi/lo split; and P rounded once to
# bf16 (a plain tensor-core P·V), which must miss the card's 1e-3 check
K2_CASES = [(vd, kind, True) for vd in K2_VALID for kind in ("bf16", "int8", "fp8")] \
    + [("all", "bf16", False)]


@pytest.mark.parametrize("vd,kind,split", K2_CASES)
def test_k2_tile_algorithm_matches_plain(vd, kind, split):
    """K2's tensor-core tile algorithm (64-key tiles walked slot by slot
    over the valid slots of each group, hi/lo P·V, the k scale on the
    scores and the v scale in p, kv_len < T with a ragged tail tile)
    against ``pool_attention_plain`` at qwen3-8b's head shape (H 32, KVH 8,
    D 128; 2 groups of 1 row, C 64, 4 slots of T 200, kv_len 150): m, l and
    acc within 1e-5 of their max|ref|, 100x inside the card's 1e-3 check;
    an all-invalid group exactly (-1e30, 0, 0). Without the split acc is
    off by more than 1e-3 of max|acc|."""
    valid = torch.tensor(K2_VALID[vd])
    q, k, v, ks, vs = _k2_inputs(kind, 2, 64, 32, 8, 128, 4, 200)
    got = _stack_emulation(q, k, v, valid, ks, vs, kv_len=150, split=split)
    want = ref.pool_attention_plain(q, k, v, valid, kv_len=150, k_scale=ks, v_scale=vs)
    if not split:
        assert (got[2] - want[2]).abs().max().item() > 1e-3 * want[2].abs().max().item()
        return
    _state_held(got, want, 1e-5)
    for gi, row in enumerate(K2_VALID[vd]):
        if not any(row):
            m, l, acc = (x[gi:gi + 1] for x in got)
            assert bool((m == NEG_INF).all() and (l == 0).all() and (acc == 0).all())


def test_k2_tile_algorithm_matches_pallas():
    """The same emulation against the reference Pallas pool kernel
    (interpret mode) at a small size: one group, three slots of which two
    are valid, two 64-key tiles a slot, kv_len < T."""
    b, c, h, kvh, d, s, t, kv_len = 1, 64, 4, 2, 32, 3, 128, 120
    q, k, v, _, _ = _k2_inputs("bf16", b, c, h, kvh, d, s, t)
    valid = np.array([1, 0, 1], np.int32)
    want = ref_ca.pool_attention_pallas(
        *(jnp.asarray(x.float().numpy()) for x in (q, k, v)), jnp.asarray(valid[:, None]),
        kv_len=kv_len, block_q=c, block_k=16, interpret=True)
    got = _stack_emulation(q, k, v, valid[None], kv_len=kv_len)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()


def _paged_emulation(q, kp, vp, handles, valid, ks=None, vs=None, *, ppc, kv_len):
    """K3's tensor-core body on the CPU: K2's walk over the valid slots of
    each group, but each 64-key tile assembled as ``PagedCursor`` loads it
    from the page store [G,P,B,pt,KVH,D] through the handles: one box of a
    page (pt a multiple of 64) or 64 / pt boxes of whole pages, a page past
    the chunk's last replaced by the last page (its keys are masked);
    per-page scales [G,P,B,1,KVH,1]. Returns (m, l) [G*B,H,C], acc
    [G*B,C,H,D]."""
    gb, c, h, d = q.shape
    ng, _, b, pt, kvh, _ = kp.shape
    sub = min(pt, 64)
    parts = []
    for g in range(ng):
        qf = q[g * b:(g + 1) * b].float().reshape(b, c, kvh, h // kvh, d)

        def tiles():
            for s in np.flatnonzero(np.asarray(valid[g])):
                for k0 in range(0, kv_len, 64):
                    rows = []
                    for r in range(64 // sub):
                        tok = k0 + r * sub
                        page = tok // pt
                        hnd = int(handles[s * ppc + min(page, ppc - 1)])
                        tin = tok % pt if page < ppc else 0
                        rows.append((hnd, slice(tin, tin + sub)))
                    kt = torch.cat([kp[g, hh, :, tt] for hh, tt in rows], 1).float()
                    vt = torch.cat([vp[g, hh, :, tt] for hh, tt in rows], 1).float()
                    ksc = vsc = None
                    if ks is not None:
                        ksc = torch.cat([ks[g, hh, :, 0, :, 0][:, None].expand(b, sub, kvh)
                                         for hh, _ in rows], 1)
                        vsc = torch.cat([vs[g, hh, :, 0, :, 0][:, None].expand(b, sub, kvh)
                                         for hh, _ in rows], 1)
                    kpos = torch.arange(k0, k0 + 64)[None, :]
                    yield kt, vt, ksc, vsc, kpos < kv_len
        parts.append(_as_kernel_state(*_online_tiles(qf, tiles(), 1.0 / math.sqrt(d), True)))
    return tuple(torch.cat(x) for x in zip(*parts))


@pytest.mark.parametrize("pt", [128, 16])
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_k3_tile_algorithm_matches_plain(pt, kind):
    """K3's tensor-core tile walk over pages read in place (``PagedCursor``
    in ``csrc/chunk_attn_tc.cuh``): pages of 128 tokens (a tile within a
    page) and of 16 (four pages a tile), shuffled handles, a partial last
    page (kv_len 200 of 256), two groups with mixed valid slots, against
    ``pool_attention_paged_plain`` at qwen3-8b's head shape within 1e-5 of
    max|ref| (m, l, acc); a group with no valid slot exactly (-1e30, 0,
    0). The same sums as K2's walk over the gathered stack."""
    ng, b, c, h, kvh, d, s, t = 2, 1, 64, 32, 8, 128, 3, 256
    ppc = t // pt
    npages = (s + 1) * ppc
    handles = torch.from_numpy(np.random.default_rng(3).permutation(npages)[: s * ppc]
                               .astype(np.int32))
    q = torch.from_numpy(_randn(ng * b, c, h, d, seed=51)).bfloat16()
    k, v = _randn(ng, npages, b, pt, kvh, d, seed=52), _randn(ng, npages, b, pt, kvh, d, seed=53)
    ks = vs = None
    if kind == "bf16":
        kp, vp = torch.from_numpy(k).bfloat16(), torch.from_numpy(v).bfloat16()
    else:
        kp, _, ks = _quant(k, kind, (3, 5))
        vp, _, vs = _quant(v, kind, (3, 5))
        ks, vs = torch.from_numpy(ks), torch.from_numpy(vs)
    for valid in ([[1, 0, 1], [0, 1, 1]], [[0, 0, 0], [1, 1, 0]]):
        valid = torch.tensor(valid)
        got = _paged_emulation(q, kp, vp, handles, valid, ks, vs, ppc=ppc, kv_len=200)
        want = ref.pool_attention_paged_plain(q, kp, vp, handles, valid, ppc=ppc, kv_len=200,
                                              k_scale=ks, v_scale=vs)
        _state_held(got, want, 1e-5)


# ------------------------------------------------------------------ K2

VALIDS = [np.array([1, 0, 1]), np.array([0, 0, 0]), np.array([1, 1, 1])]


@pytest.mark.parametrize("heads", list(HEAD_SHAPES))
@pytest.mark.parametrize("valid", VALIDS, ids=["mixed", "none", "all"])
@pytest.mark.parametrize("kind", ["float32", "int8", "fp8"])
def test_pool_attention_plain_matches_pallas(valid, kind, heads):
    s = valid.shape[0]
    h, kvh, d = HEAD_SHAPES[heads]
    q = _randn(B, C, h, d)
    k, v = _randn(s, B, C, kvh, d, seed=5), _randn(s, B, C, kvh, d, seed=6)
    if kind == "float32":
        args, rargs, kw, rkw, tol = (k, v), (k, v), {}, {}, 1e-5
        args = tuple(map(torch.from_numpy, args))
        rargs = tuple(map(jnp.asarray, rargs))
    else:
        kq, rkq, ks = _quant(k, kind, (2, 4))
        vq, rvq, vs = _quant(v, kind, (2, 4))
        ks = np.broadcast_to(ks, (s, B, C, kvh, 1))[..., 0].copy()
        vs = np.broadcast_to(vs, (s, B, C, kvh, 1))[..., 0].copy()
        args, rargs, tol = (kq, vq), (rkq, rvq), 1e-4
        kw = dict(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
        rkw = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    want = ref_ops.pool_attention(jnp.asarray(q), *rargs, jnp.asarray(valid), **rkw)
    got = ops.pool_attention(torch.from_numpy(q), *args, torch.from_numpy(valid), **kw)
    _close(got, want, tol, scaled=heads != "d16")
    if not valid.any():
        m, l, acc = got
        assert bool((m == NEG_INF).all() and (l == 0).all() and (acc == 0).all())


def test_pool_attention_group_axis():
    """valid [G, S] with G = 2 stage groups equals two single-group calls."""
    s, g = 3, 2
    q = torch.from_numpy(_randn(g * B, C, H, D))
    k = torch.from_numpy(_randn(s, g * B, C, KVH, D, seed=7))
    v = torch.from_numpy(_randn(s, g * B, C, KVH, D, seed=8))
    valid = torch.tensor([[1, 0, 1], [0, 1, 1]])
    got = ops.pool_attention(q, k, v, valid, kv_len=C - 4)
    for gi in range(g):
        rows = slice(gi * B, (gi + 1) * B)
        one = ops.pool_attention(q[rows], k[:, rows], v[:, rows], valid[gi], kv_len=C - 4)
        for a, b in zip(got, one):
            assert torch.equal(a[rows], b)


# ------------------------------------------------------------------ K3

def _page_store(npages, pt, g=None, seed=11, kvh=KVH, d=D):
    lead = () if g is None else (g,)
    k = _randn(*lead, npages, 2, B, pt, kvh, d, seed=seed)     # [.., P, lps, B, pt, K, D]
    v = _randn(*lead, npages, 2, B, pt, kvh, d, seed=seed + 1)
    return k, v


@pytest.mark.parametrize("heads", list(HEAD_SHAPES))
@pytest.mark.parametrize("ppc", [1, 2])
@pytest.mark.parametrize("kind", ["float32", "int8", "fp8"])
def test_paged_plain_matches_pallas(ppc, kind, heads):
    """Shuffled handles, a partial last page (kv_len < ppc*pt), a mixed
    valid row; the port reads a strided layer view of a 2-layer store."""
    s, pt = 3, C // ppc
    h, kvh, d = HEAD_SHAPES[heads]
    npages = (s + 1) * ppc
    handles = np.random.default_rng(2).permutation(npages)[: s * ppc].astype(np.int32)
    valid = np.array([1, 0, 1], np.int32)
    kv_len = C - 5
    q = _randn(B, C, h, d)
    k, v = _page_store(npages, pt, kvh=kvh, d=d)
    kw, rkw, tol = {}, {}, 1e-5
    if kind == "float32":
        kt, vt = torch.from_numpy(k), torch.from_numpy(v)
        rk, rv = jnp.asarray(k[:, 1]), jnp.asarray(v[:, 1])
    else:
        kt, rk, ks = _quant(k, kind, (3, 5))
        vt, rv, vs = _quant(v, kind, (3, 5))
        rk, rv = rk[:, 1], rv[:, 1]
        kw = dict(k_scale=torch.from_numpy(ks)[:, 1], v_scale=torch.from_numpy(vs)[:, 1])
        rkw = dict(k_scale=jnp.asarray(ks[:, 1]), v_scale=jnp.asarray(vs[:, 1]))
        tol = 1e-4
    want = ref_ops.pool_attention_paged(
        jnp.asarray(q), rk, rv, jnp.asarray(handles), jnp.asarray(valid), ppc=ppc,
        kv_len=kv_len, **rkw)
    k_l, v_l = kt[:, 1], vt[:, 1]                       # strided views, not copies
    assert not k_l.is_contiguous()
    got = ops.pool_attention_paged(torch.from_numpy(q), k_l, v_l,
                                   torch.from_numpy(handles), torch.from_numpy(valid),
                                   ppc=ppc, kv_len=kv_len, **kw)
    _close(got, want, tol, scaled=heads != "d16")


def test_paged_invalid_slots_are_exact_identity():
    k, v = _page_store(4, C)
    got = ops.pool_attention_paged(
        torch.from_numpy(_randn(B, C, H, D)), torch.from_numpy(k)[:, 0],
        torch.from_numpy(v)[:, 0], torch.tensor([2, 0, 1]), torch.zeros(3), ppc=1)
    m, l, acc = got
    assert bool((m == NEG_INF).all() and (l == 0).all() and (acc == 0).all())


def test_paged_group_axis_reads_each_stage_pages():
    """A stage-stacked store [G, P, lps, B, pt, K, D], one layer's strided
    view, valid [G, S]: equal to G single-stage calls on each stage's own
    pages (a wrong stride would read another stage's or layer's pages)."""
    g, s, ppc, pt = 2, 3, 2, 8
    npages = (s + 1) * ppc
    k, v = _page_store(npages, pt, g=g)
    k[1] += 3.0                                          # stages differ visibly
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    handles = torch.tensor([5, 0, 7, 2, 1, 6], dtype=torch.int32)
    valid = torch.tensor([[1, 1, 0], [0, 1, 1]])
    q = torch.from_numpy(_randn(g * B, C, H, D))
    got = ops.pool_attention_paged(q, kt[:, :, 1], vt[:, :, 1], handles, valid,
                                   ppc=ppc, kv_len=13)
    for gi in range(g):
        rows = slice(gi * B, (gi + 1) * B)
        one = ops.pool_attention_paged(q[rows], kt[gi, :, 1], vt[gi, :, 1], handles,
                                       valid[gi], ppc=ppc, kv_len=13)
        for a, b in zip(got, one):
            assert torch.equal(a[rows], b)


def _masked_stack(q, k, v, valid, kv_len, k_scale=None, v_scale=None):
    """K2's plain version as it was first written: every (group, slot) of
    the stack scored, the invalid ones and the keys past kv_len masked to
    -1e30 before the softmax."""
    gb, c, h, d = q.shape
    s_n, _, t, kvh, _ = k.shape
    ok = (valid[None] if valid.ndim == 1 else valid) != 0
    ok = ok.repeat_interleave(gb // ok.shape[0], dim=0)
    tok = torch.arange(t) < kv_len
    mask = (ok[:, :, None] & tok[None, None, :]).reshape(gb, 1, 1, 1, s_n * t)

    def flat(x, sc):
        x = x.float() if sc is None else x.float() * sc[..., None]
        return x.permute(1, 0, 2, 3, 4).reshape(gb, s_n * t, kvh, d)
    return ref._state(q, flat(k, k_scale), flat(v, v_scale), mask, 1.0 / math.sqrt(d))


@pytest.mark.parametrize("valid", [[[1, 0, 1, 1], [0, 0, 0, 0], [0, 1, 0, 0]],
                                   [[1, 1, 1, 1]] * 3, [[0, 0, 1, 0]] * 3],
                         ids=["mixed", "all", "one_slot"])
@pytest.mark.parametrize("kind", ["float32", "int8"])
def test_k2_k3_plain_score_only_the_valid_pairs(valid, kind):
    """K2's and K3's plain versions score each group's valid slots only
    (K3 on float pages); their state equals the masked whole stack's (``_masked_stack``) to
    1e-6 of each output's max|ref| (fp32 summation order over fewer
    terms), and an all-invalid group's is exactly (-1e30, 0, 0)."""
    g, s, kv_len = 3, 4, C - 3
    valid = torch.tensor(valid)
    q = torch.from_numpy(_randn(g * B, C, H, D))
    k = torch.from_numpy(_randn(s, g * B, C, KVH, D, seed=3))
    v = torch.from_numpy(_randn(s, g * B, C, KVH, D, seed=4))
    kw = {}
    if kind == "int8":
        (k, _, ks), (v, _, vs) = (_quant(x.numpy(), kind, (2, 4)) for x in (k, v))
        kw = dict(k_scale=torch.from_numpy(ks[..., 0].repeat(C, 2)),
                  v_scale=torch.from_numpy(vs[..., 0].repeat(C, 2)))
    want = _masked_stack(q, k, v, valid, kv_len, **kw)
    got = ops.pool_attention(q, k, v, valid, kv_len=kv_len, **kw)
    outs = [got]
    if kind == "float32":   # K3 over the same slots: a page of C tokens a slot and stage
        pages = lambda x: x.reshape(s, g, B, C, KVH, D).transpose(0, 1)   # noqa: E731
        outs.append(ops.pool_attention_paged(q, pages(k), pages(v), torch.arange(s),
                                             valid, ppc=1, kv_len=kv_len))
    for out in outs:
        _close(out, [w.numpy() for w in want], 1e-6, scaled=True)
    dead = ~valid.any(1).repeat_interleave(B)
    m, l, acc = got
    assert bool((m[dead] == NEG_INF).all() and (l[dead] == 0).all()
                and (acc[dead] == 0).all())


# --------------------------------------------------------- wrapper checks

def test_wrappers_refuse_what_the_kernels_do_not_take():
    q = torch.zeros(B, C, H, D)
    k = torch.zeros(B, C, KVH, D)
    with pytest.raises(TypeError):
        ops.chunk_attention(q, k.to(torch.bfloat16), k.to(torch.bfloat16))
    with pytest.raises(ValueError):
        ops.chunk_attention(q, k.to(torch.int8), k.to(torch.int8))   # no scales
    with pytest.raises(ValueError):
        ops.chunk_attention(torch.zeros(B, C, H, 24), torch.zeros(B, C, KVH, 24),
                            torch.zeros(B, C, KVH, 24))             # head dim 24
    with pytest.raises(ValueError):
        ops.chunk_attention(q, k, k, kv_len=C + 1)
    with pytest.raises(ValueError):
        ops.pool_attention(q, k[None], k[None], torch.ones(2))      # 2 valid, 1 slot


@pytest.mark.parametrize("h,kvh,d,refused",
                         [(4, 2, 64, True), (8, 2, 80, True), (6, 2, 16, True),
                          (24, 8, 64, False), (10, 2, 16, False), (6, 2, 112, True),
                          (2, 2, 80, False), (14, 2, 128, False)],
                         ids=["d64", "d80", "g3", "d64_g3", "g5_taken", "d112_g3",
                              "d80_g1_taken", "d128_g7_taken"])
def test_k5_refuses_head_dims_and_groups_of_k1_to_k3_alone(h, kvh, d, refused):
    """K1-K3 take any group at head dims 16, 64, 80, 112 and 128; K5 is
    built only for its decode paths' (D, G) pairs (``_DECODE_GROUPS``) and
    refuses the others (here G 2 at D 64, G 4 at D 80, G 3 at D 16 and
    112) with its own message on the CPU already (never reaching the CUDA
    side's cudaErrorInvalidValue), while K1 takes the same q / k / v. It
    takes G 3 at D 64 (granite-moe-3b-a800m), G 1 at D 80 (stablelm-3b),
    G 7 at D 128 (llava-next-34b) and G 5 at D 16 (the smoke qwen3-14b)."""
    q = torch.zeros(2, h, d)
    k = torch.zeros(2, 8, kvh, d)
    kv_len = torch.tensor([3, 8], dtype=torch.int32)
    if refused:
        with pytest.raises(ValueError, match="K5 decode attention"):
            ops.decode_attention(q, k, k, kv_len)
    else:
        assert ops.decode_attention(q, k, k, kv_len).shape == (2, h, d)
    out = ops.chunk_attention(q[:, None], k, k, causal_offset=7)
    assert out.shape == (2, 1, h, d)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g,d", [(5, 128), (12, 128), (16, 128), (5, 16), (7, 128),
                                 (1, 64), (3, 64), (4, 64), (1, 80)],
                         ids=["g5", "g12", "g16", "g5_d16", "g7", "d64_g1", "d64_g3",
                              "d64_g4", "d80_g1"])
def test_k5_plain_matches_pallas_at_the_new_groups(g, d, dtype):
    """K5's plain version (what ``ops.decode_attention`` takes on the CPU)
    against the reference Pallas flash-decode in interpret mode at GQA
    groups 5, 12 and 16 (qwen3-14b; mistral-123b; qwen3-235b and
    llama3-405b), 7 (llava-next-34b), and at head dims 64 (G 1, 3, 4:
    whisper-small, granite-moe-3b-a800m, granite-3-2b) and 80 (G 1:
    stablelm-3b), 2 kv heads, ragged lengths with the tail past each
    length set to 1e4: 2e-5 in fp32, 3e-2 in bf16 (the tolerances of
    ``tests/test_kernels.py::test_decode_attention``)."""
    b, kvh, s = 3, 2, 192
    rng = np.random.default_rng(g)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, g * kvh, d), (b, s, kvh, d), (b, s, kvh, d)))
    kv_len = np.array([1, 77, s], dtype=np.int32)
    for i, n in enumerate(kv_len):
        k[i, n:], v[i, n:] = 1e4, -1e4
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "float32"
                else (torch.bfloat16, jnp.bfloat16))
    got = ops.decode_attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                               torch.from_numpy(kv_len))
    want = ref_ops.decode_attention(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                                    jnp.asarray(kv_len))
    tol = 2e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# ------------------------------------------------------ traversal orders

@pytest.mark.parametrize("kind,slots", [("float32", None), ("float32", [3, 1]),
                                        ("int8", None)])
def test_pool_scan_traversal_orders_agree(kind, slots):
    """Per-slot ``torch``, batched ``cuda`` (K2's plain version) and
    ``paged`` (K3's plain version) over a stage-stacked pool with a
    different phase per stage: 1e-6 on float pages, 2e-5 on int8 pages."""
    n, nslots, pt = 2, 4, 8
    geom = kvpages.page_geometry(C, nslots, pt)
    tbl = kvpages.build_slot_pages(geom)
    codec = kvquant.get_codec(kind if kind == "int8" else "auto", "float32")
    pool = kvpages.alloc_pool(geom, codec, 1, B, KVH, D, stages=n, device="cpu")
    for s in range(nslots):
        kv = torch.from_numpy(_randn(n, 1, B, C, KVH, D, seed=20 + s))
        kq, ks = kvquant.encode(codec, kv, pages=geom.pages_per_chunk)
        vq, vs = kvquant.encode(codec, -0.5 * kv, pages=geom.pages_per_chunk)
        kvpages.scatter_chunk_raw(pool, np.stack([tbl[s]] * n), kq, vq, ks, vs)
    pool_l = (pool.k[:, :, 0], pool.v[:, :, 0],
              None if pool.k_scale is None else pool.k_scale[:, :, 0],
              None if pool.v_scale is None else pool.v_scale[:, :, 0])
    slot_chunk = np.array([0, 1, 2, 3, -1])
    limit = np.array([2, 4])                             # per stage
    qg = A.group_queries(torch.from_numpy(_randn(n * B, C, H, D, seed=9)), KVH)
    scale = 1.0 / math.sqrt(D)
    outs = {}
    for name in ("torch", "cuda", "paged"):
        st = A.pool_scan(A.get_backend(name), qg, pool_l, tbl, slot_chunk, limit, scale,
                         A.attn_init(n * B, C, KVH, H // KVH, D), slots=slots)
        outs[name] = (A.attn_finish(st, torch.float32), st)
    tol = 1e-6 if kind == "float32" else 2e-5
    for name in ("cuda", "paged"):
        np.testing.assert_allclose(outs[name][0].numpy(), outs["torch"][0].numpy(),
                                   atol=tol, rtol=tol)
        np.testing.assert_array_equal(outs[name][1][0].numpy(), outs["torch"][1][0].numpy())
