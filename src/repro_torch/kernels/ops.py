"""Public wrappers of the CUDA kernels, the counterparts of
``repro.kernels.ops``: the three attention kernels K1-K3
(``csrc/chunk_attn.cu``), the Mamba2 SSD scan K4 (``csrc/ssd.cu``) and the
flash-decode attention K5 (``csrc/decode_attn.cu``).

Each wrapper checks device, dtype, shape and layout and raises on what the
kernel does not take, allocates its outputs with ``torch.empty`` and
launches on the current stream. A tensor on the CPU goes to the plain
version in ``kernels.ref``; a CUDA tensor launches the kernel or raises —
there is no fallback. ``LAUNCHES`` counts kernel launches per tag, and only
those.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import ref

LAUNCHES = {"chunk_attention": 0, "pool_attention": 0,
            "pool_attention_paged": 0, "ssd": 0, "decode_attention": 0}

_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
             torch.float8_e4m3fn: 3}
# (q, kv) dtype combination -> the part of csrc/chunk_attn.cu that holds it
# (``-DKV_COMBO``, see kernels/build.py)
_COMBOS = {(torch.float32, torch.float32): 0, (torch.float32, torch.int8): 1,
           (torch.float32, torch.float8_e4m3fn): 2,
           (torch.bfloat16, torch.bfloat16): 3, (torch.bfloat16, torch.int8): 4,
           (torch.bfloat16, torch.float8_e4m3fn): 5}
# K1-K3's head dims: smoke; granite-3-2b and granite-moe-3b-a800m;
# stablelm-3b; zamba2-7b's shared block; qwen3-8b and qwen2-moe-a2.7b
_HEAD_DIMS = (16, 64, 80, 112, 128)
_MAX_SLOTS = 1024
# the tensor-core body of K1-K3 (bf16 q at these head dims) and K2's and K3's
# limits on valid [G, S] there (MAX_GROUPS, MAX_WORDS in csrc/chunk_attn_tc.cuh)
_TC_HEAD_DIMS, _TC_MAX_GROUPS, _TC_MAX_WORDS = (64, 80, 112, 128), 64, 1024

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "chunk_attention_launch": [_P] * 9 + [_I] * 10 + [_F, _P],
    "pool_attention_launch": [_P] * 9 + [_I] * 11 + [_F, _P],
    "pool_attention_paged_launch": [_P] * 10 + [_I] * 13 + [_LL] * 9 + [_F, _P],
    "ssd_launch": [_P] * 9 + [_I] * 9 + [_LL] * 6 + [_P],
    "decode_attention_launch": [_P] * 7 + [_I] * 7 + [_F, _P],
}
_SSD_CODES = {torch.float32: 0, torch.bfloat16: 1}
# (P, N) = (head dim, state size): smoke; zamba2-7b; mamba2-130m
_SSD_SHAPES = ((16, 16), (64, 64), (64, 128))
_SSD_MAX_CHUNK = 256


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _fn(lib_name: str, name: str):
    from repro_torch.kernels import build
    fn = getattr(build.lib(lib_name), name)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
    return fn


def _call(lib_name: str, name: str, tag: str, on, *args) -> None:
    """Launches ``name`` of library ``lib_name`` on the current stream of
    the card that holds the tensor ``on``; counts it under ``tag``."""
    stream = torch._C._cuda_getCurrentRawStream(on.get_device())
    err = _fn(lib_name, name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} failed: CUDA error {err}")
    LAUNCHES[tag] += 1


def _attn_lib(q_dtype: torch.dtype, kv_dtype: torch.dtype) -> str:
    return f"chunk_attn.{_COMBOS[(q_dtype, kv_dtype)]}"


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _on_card(*ts) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises on a mix or on
    another device type."""
    devs = {t.device for t in ts if t is not None}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"


def _check_types(q, k, v, k_scale, v_scale) -> None:
    if q.dtype not in _Q_CODES:
        raise TypeError(f"q dtype {q.dtype} not in {list(_Q_CODES)}")
    if k.dtype not in _KV_CODES or v.dtype != k.dtype:
        raise TypeError(f"k/v dtypes {k.dtype}/{v.dtype} not supported")
    quantized = k.dtype in (torch.int8, torch.float8_e4m3fn)
    if quantized != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError("int8/fp8 K/V need k_scale and v_scale; float K/V take none")
    if not quantized and k.dtype != q.dtype:
        raise TypeError(f"float K/V must match q's dtype ({k.dtype} vs {q.dtype})")
    for sc in (k_scale, v_scale):
        if sc is not None and sc.dtype != torch.float32:
            raise TypeError("scales must be float32")
    d = q.shape[-1]
    if d not in _HEAD_DIMS or k.shape[-1] != d:
        raise ValueError(f"head dim {d} (k: {k.shape[-1]}) not in K1-K3's {_HEAD_DIMS}")
    if q.shape[2] % k.shape[-2]:
        raise ValueError(f"{q.shape[2]} query heads do not group over {k.shape[-2]} kv heads")


def _check_dense(*ts) -> None:
    for t in ts:
        if t is not None and (not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError("kernel inputs must be contiguous and 16-byte aligned")


def _check_tc_groups(q: torch.Tensor, ng: int, s: int) -> None:
    """K2 and K3 with bf16 q at head dim 64, 80, 112 or 128 (the tensor-core body)
    take at most 64 groups and G x ceil(S / 32) <= 1024 words of valid
    bits (``MAX_GROUPS``, ``MAX_WORDS`` in ``csrc/chunk_attn_tc.cuh``)."""
    if q.dtype == torch.bfloat16 and q.shape[-1] in _TC_HEAD_DIMS and (
            ng > _TC_MAX_GROUPS or ng * -(-s // 32) > _TC_MAX_WORDS):
        raise ValueError(f"{ng} groups x {s} slots: the tensor-core body takes at most "
                         f"{_TC_MAX_GROUPS} groups and {_TC_MAX_WORDS} words of valid bits")


def _valid_groups(valid: torch.Tensor, gb: int, s: int) -> torch.Tensor:
    """``valid`` as [G, S] bool (one byte a slot, as the kernels read it;
    no copy when it is one already)."""
    valid = valid if valid.ndim == 2 else valid[None]
    if valid.shape[1] != s or gb % valid.shape[0]:
        raise ValueError(f"valid {tuple(valid.shape)} does not fit {gb} rows x {s} slots")
    if s > _MAX_SLOTS:
        raise ValueError(f"{s} slots > {_MAX_SLOTS}")
    return (valid if valid.dtype == torch.bool else valid != 0).contiguous()


# -------------------------------------------------------------------- K1

def chunk_attention(q, k, v, *, causal_offset: int = 0,
                    scale: Optional[float] = None,
                    kv_len: Optional[int] = None, return_state: bool = False,
                    k_scale=None, v_scale=None):
    """Chunked-prefill flash attention (K1). q [B,C,H,D]; k/v [B,T,KVH,D]
    in q's dtype, or int8/fp8 payloads with per-token fp32 scales
    [B,T,KVH]. Key j is visible to query i iff j <= i + causal_offset and
    j < kv_len (default T). Returns out [B,C,H,D] (q's dtype) and, with
    ``return_state``, also (m, l) [B,H,C] and acc [B,C,H,D] fp32.

    On the card the route is static: bf16 q with bf16, int8 or fp8 K/V at
    head dim 64, 80, 112 or 128 runs the tensor-core body (``csrc/
    chunk_attn_tc.cuh``: wgmma on TMA-fed tiles, P·V split hi + lo); fp32
    q and head dim 16 run the CUDA-core body (``flash_block``). Neither
    falls back on the other."""
    b, c, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kv_len = t if kv_len is None else int(kv_len)
    if not 0 <= kv_len <= t or k.shape != (b, t, kvh, d) or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} kv_len {kv_len}")
    _check_types(q, k, v, k_scale, v_scale)
    if k_scale is not None and (k_scale.shape != (b, t, kvh) or v_scale.shape != k_scale.shape):
        raise ValueError(f"scales must be [B, T, KVH] = {(b, t, kvh)}")
    if not _on_card(q, k, v, k_scale, v_scale):
        res = ref.chunk_attention_plain(
            q, k, v, causal_offset=causal_offset, scale=scale, kv_len=kv_len,
            k_scale=k_scale, v_scale=v_scale)
        return res if return_state else res[0]
    _check_dense(q, k, v, k_scale, v_scale)
    out = torch.empty_like(q)
    m = l = acc = None
    if return_state:
        m = torch.empty((b, h, c), device=q.device)
        l = torch.empty((b, h, c), device=q.device)
        acc = torch.empty((b, c, h, d), device=q.device)
    _call(_attn_lib(q.dtype, k.dtype), "chunk_attention_launch", "chunk_attention", q,
          _ptr(q), _ptr(k), _ptr(v), _ptr(k_scale), _ptr(v_scale), _ptr(out),
          _ptr(m), _ptr(l), _ptr(acc), _Q_CODES[q.dtype], _KV_CODES[k.dtype],
          b, c, h, t, kvh, d, int(causal_offset), kv_len, float(scale))
    return (out, m, l, acc) if return_state else out


def full_attention(q, k, v, *, scale: Optional[float] = None):
    """Non-causal K1: every query sees every key (a causal offset past the
    last key) — the encoder-decoder cross-attention shape."""
    return chunk_attention(q, k, v, causal_offset=int(k.shape[1]), scale=scale)


# -------------------------------------------------------------------- K2

def pool_attention(q, k, v, valid, *, scale: Optional[float] = None,
                   kv_len: Optional[int] = None, k_scale=None, v_scale=None):
    """Pool attention over a stack of stored chunks in one launch (K2).
    q [G*B,C,H,D]; k/v [S,G*B,T,KVH,D] (scales [S,G*B,T,KVH]); ``valid``
    [S] (G = 1) or [G,S] gates each (group, slot). Returns the fp32 state
    (m, l) [G*B,H,C] and acc [G*B,C,H,D].

    On the card the route is static: bf16 q with bf16, int8 or fp8 K/V at
    head dim 64, 80, 112 or 128 runs the tensor-core body (``csrc/
    chunk_attn_tc.cuh``, K1's kernel over K2's unit walk: wgmma on TMA-fed
    tiles of the valid slots, P·V split hi + lo; there at most 64 groups and
    G x ceil(S / 32) <= 1024); fp32 q and head dim 16 run the CUDA-core
    body (``flash_block``). Neither falls back on the other."""
    gb, c, h, d = q.shape
    s, _, t, kvh, _ = k.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kv_len = t if kv_len is None else int(kv_len)
    if not 0 <= kv_len <= t or k.shape != (s, gb, t, kvh, d) or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} kv_len {kv_len}")
    _check_types(q, k, v, k_scale, v_scale)
    if k_scale is not None and (k_scale.shape != (s, gb, t, kvh)
                                or v_scale.shape != k_scale.shape):
        raise ValueError(f"scales must be [S, G*B, T, KVH] = {(s, gb, t, kvh)}")
    valid = _valid_groups(torch.as_tensor(valid, device=q.device), gb, s)
    if not _on_card(q, k, v, valid, k_scale, v_scale):
        return ref.pool_attention_plain(q, k, v, valid, scale=scale,
                                        kv_len=kv_len, k_scale=k_scale,
                                        v_scale=v_scale)
    _check_dense(q, k, v, k_scale, v_scale)
    ng = valid.shape[0]
    _check_tc_groups(q, ng, s)
    m = torch.empty((gb, h, c), device=q.device)
    l = torch.empty((gb, h, c), device=q.device)
    acc = torch.empty((gb, c, h, d), device=q.device)
    _call(_attn_lib(q.dtype, k.dtype), "pool_attention_launch", "pool_attention", q,
          _ptr(q), _ptr(k), _ptr(v), _ptr(k_scale), _ptr(v_scale), _ptr(valid),
          _ptr(m), _ptr(l), _ptr(acc), _Q_CODES[q.dtype], _KV_CODES[k.dtype],
          ng, gb // ng, c, h, s, t, kvh, d, kv_len, float(scale))
    return m, l, acc


# -------------------------------------------------------------------- K3

def pool_attention_paged(q, k_pages, v_pages, handles, valid, *, ppc: int,
                         scale: Optional[float] = None,
                         kv_len: Optional[int] = None, k_scale=None,
                         v_scale=None):
    """Paged pool attention straight off the page store (K3), one launch.

    q [G*B,C,H,D]; ``k_pages``/``v_pages`` [P,B,pt,KVH,D] or, for G stage
    groups, [G,P,B,pt,KVH,D] — any strides with a contiguous head dim, so a
    layer slice of the stage-stacked pool (``pool.k[:, :, l]``) is read in
    place, never copied. ``handles`` [S*ppc] int32 page handles of the
    visited slots; ``valid`` [S] or [G,S]; per-page scales [P,B,1,KVH,1] /
    [G,P,B,1,KVH,1] (any strides). ``kv_len`` (default ppc*pt) drops
    trailing empty pages and masks a partial last page. Returns the fp32
    state like ``pool_attention``.

    On the card the route is static: bf16 q with bf16, int8 or fp8 pages at
    head dim 64, 80, 112 or 128 runs the tensor-core body of K1 / K2 over the pages
    in place (``PagedWalk`` in ``csrc/chunk_attn_tc.cuh``: TMA boxes of
    whole pages through a 5-D map of the strided store) when the pages fill
    whole 64-key tiles (pt a multiple of 64, or a multiple of 8 dividing 64)
    and the group stride is P page strides or B batch strides
    (``tc::paged_tc_fits``), so that K2 and K3 sum a slot stack in the same
    order; fp32 q, head dim 16 and other page shapes run the CUDA-core
    body (``flash_block``). Neither falls back on the other."""
    gb, c, h, d = q.shape
    grouped = k_pages.ndim == 6
    kp = k_pages if grouped else k_pages[None]
    vp = v_pages if grouped else v_pages[None]
    ks = vs = None
    if k_scale is not None:
        ks = k_scale if grouped else k_scale[None]
        vs = v_scale if grouped else v_scale[None]
    ng, npages, b, pt, kvh, _ = kp.shape
    handles = torch.as_tensor(handles, device=q.device)
    s = handles.numel() // ppc
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kv_len = ppc * pt if kv_len is None else int(kv_len)
    if (handles.numel() != s * ppc or ng * b != gb or vp.shape != kp.shape
            or not 0 <= kv_len <= ppc * pt):
        raise ValueError(f"shapes q {tuple(q.shape)} pages {tuple(kp.shape)} "
                         f"handles {handles.numel()} ppc {ppc} kv_len {kv_len}")
    _check_types(q, kp, vp, ks, vs)
    if ks is not None and (ks.shape != (ng, npages, b, 1, kvh, 1) or vs.shape != ks.shape):
        raise ValueError(f"scales must be [G, P, B, 1, KVH, 1] = {(ng, npages, b, 1, kvh, 1)}")
    valid = _valid_groups(torch.as_tensor(valid, device=q.device), gb, s)
    if not _on_card(q, kp, vp, handles, valid, ks, vs):
        return ref.pool_attention_paged_plain(
            q, kp, vp, handles, valid, ppc=ppc, scale=scale, kv_len=kv_len,
            k_scale=ks, v_scale=vs)
    handles = handles.to(torch.int32).contiguous()
    _check_dense(q)
    st = kp.stride()
    if vp.stride() != st or st[5] != 1:
        raise ValueError("k/v page stores need equal strides and a contiguous head dim")
    align = 16 // kp.element_size()
    if any(x % align for x in st[:5]) or kp.data_ptr() % 16 or vp.data_ptr() % 16:
        raise ValueError("page rows must be 16-byte aligned")
    _check_tc_groups(q, ng, s)
    sst = (0, 0, 0, 0)
    if ks is not None:
        if vs.stride() != ks.stride():
            raise ValueError("k/v scales need equal strides")
        sst = (ks.stride(0), ks.stride(1), ks.stride(2), ks.stride(4))
    m = torch.empty((gb, h, c), device=q.device)
    l = torch.empty((gb, h, c), device=q.device)
    acc = torch.empty((gb, c, h, d), device=q.device)
    _call(_attn_lib(q.dtype, kp.dtype), "pool_attention_paged_launch",
          "pool_attention_paged", q,
          _ptr(q), _ptr(kp), _ptr(vp), _ptr(ks), _ptr(vs), _ptr(handles),
          _ptr(valid), _ptr(m), _ptr(l), _ptr(acc), _Q_CODES[q.dtype],
          _KV_CODES[kp.dtype], ng, b, c, h, s, npages, ppc, pt, kvh, d, kv_len,
          st[0], st[1], st[2], st[3], st[4], *sst, float(scale))
    return m, l, acc


# -------------------------------------------------------------------- K4

def ssd_chunk(t: int, chunk: int) -> int:
    """The chunk the scan runs at (the reference's rule): min(chunk, T),
    halved until it divides T."""
    ck = min(chunk, t)
    while t % ck:
        ck //= 2
    return ck


def ssd_strides(t: torch.Tensor) -> Tuple[int, int]:
    """(row, position) element strides of x [R,T,H,P] or b / c [R,T,G,N] as
    K4 reads them in place: a position's heads (groups) and the last dim
    dense, the row and position strides whole multiples of 16 bytes and the
    data 16-byte aligned — so the Mamba2 block's views into its conv output
    [R, T, d_in + 2 G N] are taken as they are. Raises on another layout."""
    _, _, a, d = t.shape
    item = t.element_size()
    dense = (d == 1 or t.stride(3) == 1) and (a == 1 or t.stride(2) == d)
    if not dense or any(s * item % 16 for s in t.stride()[:2]) or t.data_ptr() % 16:
        raise ValueError(f"K4 takes [R,T,heads,dim] views with heads and dim dense and "
                         f"16-byte rows; got shape {tuple(t.shape)} strides {t.stride()}")
    return t.stride(0), t.stride(1)


def ssd(x, dt, a_log, b, c, d_skip, *, chunk: int = 128, init_state=None):
    """Mamba2 chunked SSD scan (K4). x [R,T,H,P] and b, c [R,T,G,N] in
    bf16 or fp32 (G divides H), read in place at their own row and
    position strides (``ssd_strides``); dt [R,T,H] fp32 (after softplus);
    a_log and d_skip [H], or [Gs,H] for Gs equal stage groups of rows (one
    layer per pipeline stage); init_state [R,H,P,N] fp32 or None. Runs at
    ``ssd_chunk(T, chunk)``. Returns (y [R,T,H,P] in x's dtype, final state
    [R,H,P,N] fp32).

    On the card the route is static: bf16 at (P, N) = (64, 64) or
    (64, 128) with a chunk of 256 (every launch of the bf16 serve paths)
    runs the tensor-core body (``ssd_tc_kernel`` in ``csrc/ssd.cu``: wgmma
    on TMA-fed tiles, the masked half skipped, the state update split
    hi + lo); fp32, (16, 16) and other chunks run the CUDA-core body
    (``ssd_kernel``). Neither falls back on the other."""
    r, t, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    a2 = a_log if a_log.ndim == 2 else a_log[None]
    d2 = d_skip if d_skip.ndim == 2 else d_skip[None]
    gs = a2.shape[0]
    if (dt.shape != (r, t, h) or b.shape != (r, t, g, n) or c.shape != b.shape
            or h % g or a2.shape != (gs, h) or d2.shape != a2.shape or r % gs
            or (init_state is not None and init_state.shape != (r, h, p, n))):
        raise ValueError(f"shapes x {tuple(x.shape)} dt {tuple(dt.shape)} "
                         f"b {tuple(b.shape)} c {tuple(c.shape)} a_log "
                         f"{tuple(a_log.shape)} d_skip {tuple(d_skip.shape)}")
    ck = ssd_chunk(t, chunk)
    if not _on_card(x, dt, a_log, b, c, d_skip, init_state):
        return ref.ssd_plain(x, dt, a_log, b, c, d_skip, chunk=ck,
                             init_state=init_state)
    if x.dtype not in _SSD_CODES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"x/b/c dtypes {x.dtype}/{b.dtype}/{c.dtype}: one of "
                        f"{list(_SSD_CODES)} for all three")
    for name, w in (("dt", dt), ("a_log", a2), ("d_skip", d2),
                    ("init_state", init_state)):
        if w is not None and w.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {w.dtype}")
    if (p, n) not in _SSD_SHAPES:
        raise ValueError(f"(head dim, state) ({p}, {n}) not in {_SSD_SHAPES}")
    if ck > _SSD_MAX_CHUNK:
        raise ValueError(f"chunk {ck} > {_SSD_MAX_CHUNK}")
    a2, d2 = a2.contiguous(), d2.contiguous()
    _check_dense(dt, a2, d2, init_state)
    strides = [s for v in (x, b, c) for s in ssd_strides(v)]
    y = torch.empty((r, t, h, p), device=x.device, dtype=x.dtype)
    final = torch.empty((r, h, p, n), device=x.device)
    _call("ssd", "ssd_launch", "ssd", x, _ptr(x), _ptr(dt), _ptr(a2), _ptr(b),
          _ptr(c), _ptr(d2), _ptr(init_state), _ptr(y), _ptr(final),
          _SSD_CODES[x.dtype], r, t, h, p, g, n, ck, gs, *strides)
    return y, final


# -------------------------------------------------------------------- K5

_DECODE_GROUPS = (1, 2, 4, 8)     # G = H / KVH the kernel is built for
_DECODE_HEAD_DIMS = (16, 112, 128)   # K5's own head dims (not K1-K3's 64 and 80)
# csrc/decode_attn.cu: threads a block, keys a row group takes from a tile
_DECODE_THREADS, _DECODE_U = 128, 4
_DECODE_CAP_PER_SM = 4            # the grid's most blocks an SM (the scratch is sized for it)
_DECODE_SCRATCH: dict = {}        # device -> [grid cap, fp32 partials, int32 pair counters]


def decode_heads_per_unit(g: int, d: int, itemsize: int, kvh: int) -> int:
    """Kv heads one unit of K5's work takes (``PAIR_HEADS`` in
    ``csrc/decode_attn.cu``): 2 when G = 1, a head's key row is no whole
    number of 64-byte DRAM bursts (bf16 at D 16 or 112) and KVH is even,
    so that a key's rows of the two heads are one contiguous span; else 1."""
    return 2 if g == 1 and (d * itemsize) % 64 and kvh % 2 == 0 else 1


def decode_tile_keys(d: int, itemsize: int, hp: int = 1) -> int:
    """Keys in one of K5's tiles at head dim ``d``, element size
    ``itemsize`` and ``hp`` kv heads a unit: one row group holds a head's
    key row in 16-byte pieces (padded to a power of two of threads), hp
    row groups a key, and each takes U keys a tile (``Geo`` in
    ``csrc/decode_attn.cu``)."""
    tpr = d * itemsize // 16
    tpr_p = 2
    while tpr_p < tpr:
        tpr_p *= 2
    return _DECODE_THREADS // tpr_p // hp * _DECODE_U


def decode_ranges(lengths, kvh: int, blocks: int, keys: int):
    """K5's split of the work, as the kernel computes it on the device. The
    keys of every (row, unit) pair, laid end to end (row-major, then unit,
    then position; ``kvh`` units a row, each one kv head or two
    (``decode_heads_per_unit``); row b has ``lengths[b]`` keys per unit,
    already clamped to [0, S]), are cut into ``blocks`` ranges of L keys,
    L = ceil(total / blocks) rounded up to a whole tile of ``keys`` keys.
    Returns (L, ranges): per block, its segments (row, unit, first
    position, end position), a range cut at pair boundaries."""
    lengths = [int(x) for x in lengths]
    total = kvh * sum(lengths)
    per = -(-total // blocks)
    span = max(keys, -(-per // keys) * keys)
    pairs = [(b, h, n) for b, n in enumerate(lengths) for h in range(kvh) if n]
    ranges, starts, pos = [], [], 0
    for b, h, n in pairs:
        starts.append(pos)
        pos += n
    for j in range(blocks):
        lo, hi = j * span, min((j + 1) * span, total)
        segs = []
        for (b, h, n), s0 in zip(pairs, starts):
            a, e = max(lo, s0), min(hi, s0 + n)
            if a < e:
                segs.append((b, h, a - s0, e - s0))
        ranges.append(segs)
    return span, ranges


def _decode_scratch(device, g: int, d: int, pairs: int):
    """(cap, partials, counters) for a launch on ``device``: the grid's most
    blocks, the cached fp32 partial-state scratch ((2 cap + pairs) x G x
    (D + 2) floats: a slot per segment, of up to two kv heads' G x (D + 2))
    and int32 pair counters (zero: each launch leaves them zero), grown
    when a call needs more."""
    entry = _DECODE_SCRATCH.get(device)
    if entry is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        entry = _DECODE_SCRATCH[device] = [_DECODE_CAP_PER_SM * sms, None, None]
    cap, part, cnt = entry
    need = (2 * cap + pairs) * g * (d + 2)
    if part is None or part.numel() < need:
        entry[1] = part = torch.empty(need, device=device)
    if cnt is None or cnt.numel() < pairs:
        entry[2] = cnt = torch.zeros(pairs, dtype=torch.int32, device=device)
    return cap, part, cnt


def decode_attention(q, k, v, kv_len, *, scale: Optional[float] = None):
    """Flash-decode attention (K5): one query token per batch row against a
    KV cache. q [B,H,D]; k/v [B,S,KVH,D] in q's dtype (fp32 or bf16), with
    H / KVH in (1, 2, 4, 8); kv_len [B] int32 valid lengths, clamped to
    [0, S] and read on the device (no host sync). Returns out [B,H,D] in
    q's dtype: the softmax over the first kv_len[b] keys, p in fp32, one
    normalisation by max(l, 1e-30), so a row with kv_len = 0 gives zeros.
    Unlike the reference wrapper there is no lane padding and no block
    halving: the kernel masks the ragged tail of any S.

    On the card one launch of ``csrc/decode_attn.cu``: a grid sized to the
    card splits the keys of all rows into equal ranges on the device
    (``decode_ranges``), streams K/V through a ``cp.async`` ring in shared
    memory and merges a pair's partial states in the block that finishes
    it last. Its scratch is cached per device, so launches of it are
    ordered on one stream."""
    b, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    if (k.shape != (b, s, kvh, d) or v.shape != k.shape or tuple(kv_len.shape) != (b,)
            or s == 0 or h % kvh):
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} kv_len {tuple(kv_len.shape)}")
    if q.dtype not in _Q_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: one of "
                        f"{list(_Q_CODES)} for all three")
    if kv_len.dtype != torch.int32:
        raise TypeError(f"kv_len must be int32, got {kv_len.dtype}")
    if d not in _DECODE_HEAD_DIMS:
        raise ValueError(f"K5 decode attention: head dim {d} not in {_DECODE_HEAD_DIMS}")
    if h // kvh not in _DECODE_GROUPS:
        raise ValueError(f"K5 decode attention: {h} query heads over {kvh} kv heads: "
                         f"group {h // kvh} not in {_DECODE_GROUPS}")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if not _on_card(q, k, v, kv_len):
        return ref.decode_attention_plain(q, k, v, kv_len, scale=scale)
    _check_dense(q, k, v)
    if not kv_len.is_contiguous():
        raise ValueError("kv_len must be contiguous")
    cap, part, cnt = _decode_scratch(q.device, h // kvh, d, b * kvh)
    out = torch.empty_like(q)
    _call("decode_attn", "decode_attention_launch", "decode_attention", q,
          _ptr(q), _ptr(k), _ptr(v), _ptr(kv_len), _ptr(part), _ptr(cnt), _ptr(out),
          _Q_CODES[q.dtype], b, h, kvh, d, s, cap, float(scale))
    return out
