"""Page-table KV store: the byte layer under the MBKR slot plan (mirrors
``repro.kvstore.pages``).

A chunk occupies ``pages_per_chunk`` pages of ``page_tokens`` tokens; the
static table ``slot_pages [slots+1, ppc]`` maps each MBKR slot to its
physical page handles. Layouts (P = pages incl. the scratch slot's):

    one stage        k / v  [P, lps, B, pt, K, D]      scales [P, lps, B, 1, K, 1]
    stage-stacked    k / v  [N, P, lps, B, pt, K, D]   scales [N, P, lps, B, 1, K, 1]

The pipeline keeps the stage-stacked pool (the N stages run as a leading
axis on one GPU). Scatter and gather take page handles ``[ppc]`` for one
stage or ``[N, ppc]`` (one row per stage) for a stage-stacked pool. Unlike
the reference's functional ``.at[].set``, scatters update the pool in
place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kvstore import quant as Q


@dataclass(frozen=True)
class PageGeometry:
    """Static page layout of one stage's pool."""
    chunk_len: int
    page_tokens: int
    pages_per_chunk: int
    num_slots: int            # excl. scratch
    num_pages: int            # (num_slots + 1) * pages_per_chunk

    @property
    def scratch_slot(self) -> int:
        return self.num_slots


def page_geometry(chunk_len: int, num_slots: int,
                  kv_page_tokens: int = 0) -> PageGeometry:
    """``kv_page_tokens`` 0 (or >= chunk) means one page per chunk; otherwise
    it is rounded down to the largest divisor of ``chunk_len``."""
    pt = kv_page_tokens if 0 < kv_page_tokens < chunk_len else chunk_len
    while chunk_len % pt:
        pt -= 1
    ppc = chunk_len // pt
    return PageGeometry(chunk_len, pt, ppc, num_slots, (num_slots + 1) * ppc)


def build_slot_pages(geom: PageGeometry) -> np.ndarray:
    """slot -> physical page handles, [slots+1, ppc] int32. Pages of one
    slot are strided across the physical array (handle = j * (slots+1) +
    slot), so every read and write has to go through the table."""
    s1 = geom.num_slots + 1
    tbl = np.empty((s1, geom.pages_per_chunk), np.int32)
    for s in range(s1):
        for j in range(geom.pages_per_chunk):
            tbl[s, j] = j * s1 + s
    return tbl


def handle_rows(slot_pages: np.ndarray, slots=None) -> np.ndarray:
    """The [S, ppc] page-handle rows of the visited slots: all non-scratch
    slots, or the ``slots`` subset (creditor scan)."""
    rows = (slot_pages[:-1] if slots is None
            else slot_pages[np.asarray(slots, np.int64)])
    return np.asarray(rows, np.int32)


def verify_page_plan(slot_pages: np.ndarray, geom: PageGeometry) -> None:
    """Page handles must be a bijection onto [0, num_pages)."""
    flat = slot_pages.ravel()
    assert flat.size == geom.num_pages, (flat.size, geom.num_pages)
    assert flat.min() >= 0 and flat.max() < geom.num_pages
    assert np.unique(flat).size == flat.size, "page handle collision"


# --------------------------------------------------------------------- pool

@dataclass
class PagedPool:
    """Device-resident paged KV pool (scales None when passthrough)."""
    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None


POOL_FIELDS = ("k", "v", "k_scale", "v_scale")


def alloc_pool(geom: PageGeometry, codec: Q.KVCodec, lps: int, b: int,
               kvh: int, hd: int, *, stages: Optional[int] = None,
               device=None) -> PagedPool:
    """Zero payloads (and unit scales when quantized); ``stages`` adds the
    leading stage axis of the stage-stacked pool."""
    lead = () if stages is None else (stages,)
    shape = lead + (geom.num_pages, lps, b, geom.page_tokens, kvh, hd)
    dt = codec.torch_dtype
    k = torch.zeros(shape, dtype=dt, device=device)
    v = torch.zeros(shape, dtype=dt, device=device)
    if not codec.quantized:
        return PagedPool(k, v)
    sshape = lead + (geom.num_pages, lps, b, 1, kvh, 1)
    return PagedPool(k, v, torch.ones(sshape, device=device),
                     torch.ones(sshape, device=device))


def _index(idx, device) -> torch.Tensor:
    return torch.as_tensor(np.array(idx), dtype=torch.long, device=device)


# ----------------------------------------------------------- write (scatter)

def _paginate(x: torch.Tensor, ppc: int) -> torch.Tensor:
    """[N, lps, B, C, K, D] -> [N, ppc, lps, B, pt, K, D]."""
    n, lps, b, c, kvh, hd = x.shape
    x = x.reshape(n, lps, b, ppc, c // ppc, kvh, hd)
    return x.permute(0, 3, 1, 2, 4, 5, 6)


def scatter_chunk_raw(pool: PagedPool, pages, kq: torch.Tensor,
                      vq: torch.Tensor, ks: Optional[torch.Tensor],
                      vs: Optional[torch.Tensor]) -> PagedPool:
    """Scatter already-encoded chunk KV in place.

    One stage: ``pages`` [ppc], payloads [lps, B, C, K, D], scales
    [ppc, lps, B, 1, K, 1]. Stage-stacked: ``pages`` [N, ppc] (each
    stage's target), payloads [N, lps, B, C, K, D], scales
    [ppc, N, lps, B, 1, K, 1] (``encode``'s layout). Page handles of one
    slot are disjoint by the table bijection."""
    pages = _index(pages, pool.k.device)
    stacked = pages.ndim == 2
    k_pool, v_pool = pool.k, pool.v
    k_sc, v_sc = pool.k_scale, pool.v_scale
    if not stacked:
        pages = pages[None]
        kq, vq = kq[None], vq[None]
        k_pool, v_pool = k_pool[None], v_pool[None]
        if ks is not None:
            ks, vs = ks[:, None], vs[:, None]
            k_sc, v_sc = k_sc[None], v_sc[None]
    n, ppc = pages.shape
    stage = torch.arange(n, device=pages.device)[:, None]
    Q.as_bytes(k_pool)[stage, pages] = Q.as_bytes(_paginate(kq, ppc).to(k_pool.dtype))
    Q.as_bytes(v_pool)[stage, pages] = Q.as_bytes(_paginate(vq, ppc).to(v_pool.dtype))
    if k_sc is not None:
        k_sc[stage, pages] = ks.transpose(0, 1).to(k_sc.dtype)
        v_sc[stage, pages] = vs.transpose(0, 1).to(v_sc.dtype)
    return pool


# ------------------------------------------------------------ read (gather)

def gather_chunk(k_l: torch.Tensor, v_l: torch.Tensor,
                 ks_l: Optional[torch.Tensor], vs_l: Optional[torch.Tensor],
                 pages) -> Tuple[torch.Tensor, torch.Tensor,
                                 Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Gather one slot's chunk from layer-sliced pool arrays — the reference
    feed (per-slot scan and the streamed fetch wire), not a perf path.

    One stage: k_l [P, B, pt, K, D], ``pages`` [ppc] -> payload [B, C, K, D]
    + per-page scales [ppc, B, 1, K, 1]. Stage-stacked: k_l
    [N, P, B, pt, K, D], ``pages`` [N, ppc] -> [N*B, C, K, D] and
    [ppc, N*B, 1, K, 1] (the stage axis folds into the batch)."""
    pages = _index(pages, k_l.device)
    if pages.ndim == 1:
        k_l, v_l, pages = k_l[None], v_l[None], pages[None]
        if ks_l is not None:
            ks_l, vs_l = ks_l[None], vs_l[None]
    n, ppc = pages.shape
    stage = torch.arange(n, device=pages.device)[:, None]

    def pay(x):
        y = Q.as_bytes(x)[stage, pages]          # [N, ppc, B, pt, K, D]
        _, _, b, pt, kvh, hd = y.shape
        y = y.permute(0, 2, 1, 3, 4, 5).reshape(n * b, ppc * pt, kvh, hd)
        return y.view(x.dtype)

    def sc(x):
        x = x[stage, pages]                      # [N, ppc, B, 1, K, 1]
        return x.transpose(0, 1).reshape(ppc, -1, *x.shape[3:])

    ks = vs = None
    if ks_l is not None:
        ks, vs = sc(ks_l), sc(vs_l)
    return pay(k_l), pay(v_l), ks, vs


def gather_chunks(k_l: torch.Tensor, v_l: torch.Tensor,
                  ks_l: Optional[torch.Tensor], vs_l: Optional[torch.Tensor],
                  page_rows) -> Tuple[torch.Tensor, torch.Tensor,
                                      Optional[torch.Tensor], Optional[torch.Tensor]]:
    """``gather_chunk`` over a stack of slots: ``page_rows`` [S, ppc] (the
    same rows for every stage) -> payloads [S, B, C, K, D] + scales
    [S, ppc, B, 1, K, 1]; stage-stacked k_l gives [S, N*B, ...]. This
    materializes the dense slot stack: the feed of the slot-stack kernel
    (K2), which the paged kernel (K3) exists to avoid."""
    rows = _index(page_rows, k_l.device)
    s, ppc = rows.shape
    flat = rows.reshape(-1)
    single = k_l.ndim == 5
    if single:
        k_l, v_l = k_l[None], v_l[None]
        if ks_l is not None:
            ks_l, vs_l = ks_l[None], vs_l[None]
    n = k_l.shape[0]

    def pay(x):
        y = Q.as_bytes(x)[:, flat]               # [N, S*ppc, B, pt, K, D]
        _, _, b, pt, kvh, hd = y.shape
        y = y.reshape(n, s, ppc, b, pt, kvh, hd).permute(1, 0, 3, 2, 4, 5, 6)
        return y.reshape(s, n * b, ppc * pt, kvh, hd).view(x.dtype)

    def sc(x):
        x = x[:, flat]                           # [N, S*ppc, B, 1, K, 1]
        x = x.reshape(n, s, ppc, *x.shape[2:]).permute(1, 2, 0, 3, 4, 5, 6)
        return x.reshape(s, ppc, -1, *x.shape[4:])

    ks = vs = None
    if ks_l is not None:
        ks, vs = sc(ks_l), sc(vs_l)
    return pay(k_l), pay(v_l), ks, vs


# ------------------------------------------------------- whole-page copies

def take_pages(pool: PagedPool, stages, pages) -> PagedPool:
    """Copies of the pages ``pages`` [n, ppc] of the stages ``stages`` [n]
    of a stage-stacked pool, every layer and batch row, scales included:
    payloads [n, ppc, lps, B, pt, K, D]."""
    st = _index(stages, pool.k.device)[:, None]
    pg = _index(pages, pool.k.device)
    return PagedPool(*(None if getattr(pool, f) is None
                       else Q.as_bytes(getattr(pool, f))[st, pg] for f in POOL_FIELDS))


def put_pages(pool: PagedPool, stages, pages, taken: PagedPool) -> PagedPool:
    """Inverse of ``take_pages``: writes ``taken`` back to the pages
    ``pages`` [n, ppc] of the stages ``stages`` [n], in place. ``taken``
    may come from another pool of the same layout (on any device)."""
    st = _index(stages, pool.k.device)[:, None]
    pg = _index(pages, pool.k.device)
    for f in POOL_FIELDS:
        dst, src = getattr(pool, f), getattr(taken, f)
        if dst is not None:
            Q.as_bytes(dst)[st, pg] = src.to(dst.device)
    return pool
