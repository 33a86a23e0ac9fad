"""Cross-request prefix KV reuse: a radix index over paged KV (mirrors
``repro.kvstore.prefix``; DESIGN.md §11).

Production prefill traffic is dominated by shared system prompts and few-shot
prefixes.  The page table (``kvstore.pages``) already decouples MBKR slots
from physical storage, so sharing is an indexing + accounting layer:

- ``chunk_hashes``    — CHAINED content hashes per chunk: ``h[i]`` commits to
  every token of chunks ``0..i``, so a flat dict keyed by ``h[i]`` IS a radix
  trie — equal keys mean equal full prefixes, and the first miss walking the
  chain is the divergence point.
- ``PrefixPageCache`` — the index: one node per cached chunk holding its
  physical page handles and a refcount of live leases.  A request whose
  prefix is resident ACQUIRES the hit nodes (refcount++) and allocates fresh
  pages only for its novel suffix — copy-on-write at chunk granularity: a
  diverging request never writes a shared page, it gets new handles from the
  free list.  Refcount-0 nodes stay cached (that IS the cache) and are
  evicted leaf-first in LRU order under capacity pressure; a node with live
  readers or resident children is never evicted, and pages return to the
  free list only at eviction — never while refcount > 0.
- ``verify_prefix_index`` — the ``pages.verify_page_plan`` discipline
  extended to the shared store: node pages and the free list partition the
  allocated handle space, refcounts equal live-lease membership, and
  resident bytes equal the analytic node-count model.
- ``DeviceSeedCache`` — host-side per-request pool snapshots for the device
  path: ``prefill_pipeline(..., return_kv=True)`` yields the final paged
  pool; a later request with a matching prefix seeds its pool from the
  snapshot while ``prefix_chunks=k`` redirects its first ``k`` chunk writes
  to the scratch slot, so the cached pages stay authoritative. The
  ``TorchExecutor`` keeps each snapshot as torch tensors in host memory
  (pinned when the pool lives on the card); the cache itself only indexes
  them.

Handles here are CACHE-LOCAL accounting handles (the scheduler's view of the
shared store), allocated from a free list disjoint from the device scratch
slot by construction — the device pool keeps its own table.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["chunk_hashes", "PrefixLease", "PrefixPageCache",
           "verify_prefix_index", "DeviceSeedCache"]


def chunk_hashes(tokens: Sequence[int], chunks) -> Tuple[int, ...]:
    """Chained per-chunk content hashes over a token stream.

    ``chunks`` is either a per-chunk length sequence (an LBCP split) or a
    single uniform chunk length.  Only chunks FULLY covered by the token
    stream are hashed — a partial trailing chunk can never be shared.
    ``h[i]`` commits to all tokens of chunks ``0..i`` (chained), so two
    requests agree on ``h[i]`` iff their first ``i+1`` chunks are identical
    under the same split.
    """
    toks = np.asarray(tokens).ravel()
    if np.ndim(chunks) == 0:
        cl = int(chunks)
        if cl <= 0:
            return ()
        lens = [cl] * (len(toks) // cl)
    else:
        lens = [int(c) for c in chunks]
    out: List[int] = []
    prev = b""
    start = 0
    for c in lens:
        if c <= 0 or start + c > len(toks):
            break
        h = hashlib.blake2b(digest_size=8)
        h.update(prev)
        h.update(np.ascontiguousarray(toks[start:start + c],
                                      dtype=np.int64).tobytes())
        prev = h.digest()
        out.append(int.from_bytes(prev, "big"))
        start += c
    return tuple(out)


@dataclass
class PrefixLease:
    """One request's hold on the index: the node chain it references (hit
    prefix + the novel suffix it inserted) and the pages it WROTE — shared
    pages are read-only to the holder (copy-on-write)."""
    rid: int
    chain: Tuple[int, ...]          # node keys, root-first
    hit_chunks: int                 # leading chunks served from the index
    hit_pages: int
    new_pages: Tuple[int, ...]      # pages this request allocated (wrote)
    released: bool = False


@dataclass
class _Node:
    key: int
    parent: Optional[int]
    depth: int                      # chunks from the root, 1-based
    pages: Tuple[int, ...]
    refs: int = 0                   # live leases referencing this node
    children: int = 0               # resident child nodes
    last_use: int = 0


class PrefixPageCache:
    """Refcounted radix page index keyed by chained chunk-content hash.

    ``pages_per_chunk`` and ``page_bytes`` fix the accounting geometry (one
    node = one chunk = ``ppc`` pages of ``page_bytes`` each).
    ``capacity_pages`` bounds residency: when allocation would exceed it and
    no refcount-0 leaf can be evicted, the novel tail of the request is
    simply not indexed (its lease charges full price regardless, so the
    budget math never depends on insertion succeeding).
    """

    def __init__(self, pages_per_chunk: int, page_bytes: float,
                 capacity_pages: Optional[int] = None):
        self.pages_per_chunk = int(pages_per_chunk)
        self.page_bytes = float(page_bytes)
        self.capacity_pages = capacity_pages
        self._nodes: Dict[int, _Node] = {}
        self._free: List[int] = []
        self._next_page = 0
        self._clock = 0
        self._live: Dict[int, PrefixLease] = {}
        self.requests = 0
        self.hits = 0
        self.misses = 0
        self.hit_chunks_total = 0
        self.hit_pages_total = 0
        self.saved_bytes = 0.0
        self.evictions = 0

    # ------------------------------------------------------------- queries

    def match(self, hashes: Sequence[int]) -> int:
        """Longest resident prefix, in chunks.  Pure — no refcount effects."""
        k = 0
        for h in hashes:
            if h not in self._nodes:
                break
            k += 1
        return k

    def hit_pages(self, hashes: Sequence[int]) -> int:
        return self.match(hashes) * self.pages_per_chunk

    def resident_pages(self) -> int:
        return len(self._nodes) * self.pages_per_chunk

    def resident_bytes(self) -> float:
        return self.resident_pages() * self.page_bytes

    def live_shared_bytes(self) -> float:
        """Refcount-weighted bytes the index serves to live leases: what the
        lease manager would have charged WITHOUT sharing, minus what it does
        charge, summed over holders of shared nodes."""
        return sum(l.hit_pages for l in self._live.values()) * self.page_bytes

    def stats(self) -> dict:
        n = max(self.requests, 1)
        return {"prefix_requests": self.requests, "prefix_hits": self.hits,
                "prefix_misses": self.misses,
                "prefix_hit_rate": self.hits / n,
                "prefix_hit_chunks": self.hit_chunks_total,
                "prefix_hit_pages": self.hit_pages_total,
                "prefix_saved_bytes": self.saved_bytes,
                "prefix_resident_bytes": self.resident_bytes(),
                "prefix_evictions": self.evictions}

    # ------------------------------------------------------------ lifecycle

    def acquire(self, rid: int, hashes: Sequence[int]) -> PrefixLease:
        """Reference the resident prefix (refcount++) and index the novel
        suffix under freshly allocated pages (copy-on-write: shared pages
        are never handed to a writer)."""
        self._clock += 1
        self.requests += 1
        hashes = tuple(hashes)
        hit = self.match(hashes)
        chain: List[int] = []
        new_pages: List[int] = []
        parent = None
        for i, h in enumerate(hashes):
            if i < hit:
                node = self._nodes[h]
                node.refs += 1
                node.last_use = self._clock
                chain.append(h)
            else:
                pages = self._alloc_chunk()
                if pages is None:
                    break               # capacity: stop indexing the tail
                node = _Node(key=h, parent=parent, depth=i + 1,
                             pages=pages, refs=1, last_use=self._clock)
                self._nodes[h] = node
                if parent is not None:
                    self._nodes[parent].children += 1
                chain.append(h)
                new_pages.extend(pages)
            parent = h
        hp = hit * self.pages_per_chunk
        if hit > 0:
            self.hits += 1
        else:
            self.misses += 1
        self.hit_chunks_total += hit
        self.hit_pages_total += hp
        self.saved_bytes += hp * self.page_bytes
        lease = PrefixLease(rid=rid, chain=tuple(chain), hit_chunks=hit,
                            hit_pages=hp, new_pages=tuple(new_pages))
        self._live[id(lease)] = lease
        return lease

    def release(self, lease: PrefixLease) -> None:
        """Drop the lease's references.  Nodes stay resident at refcount 0
        (cached for future hits) until evicted under pressure."""
        if lease.released:
            return
        lease.released = True
        self._live.pop(id(lease), None)
        for h in lease.chain:
            node = self._nodes.get(h)
            if node is not None and node.refs > 0:
                node.refs -= 1

    # ------------------------------------------------------------ internals

    def _alloc_chunk(self) -> Optional[Tuple[int, ...]]:
        ppc = self.pages_per_chunk
        if self.capacity_pages is not None:
            while (self.resident_pages() + ppc > self.capacity_pages
                   and self._evict_one()):
                pass
            if self.resident_pages() + ppc > self.capacity_pages:
                return None
        out = []
        for _ in range(ppc):
            if self._free:
                out.append(self._free.pop())
            else:
                out.append(self._next_page)
                self._next_page += 1
        return tuple(out)

    def _evict_one(self) -> bool:
        """Evict the LRU refcount-0 LEAF (no resident children): its pages
        go back on the free list.  Never touches a node with live readers."""
        victim = None
        for node in self._nodes.values():
            if node.refs == 0 and node.children == 0:
                if victim is None or node.last_use < victim.last_use:
                    victim = node
        if victim is None:
            return False
        del self._nodes[victim.key]
        if victim.parent is not None and victim.parent in self._nodes:
            self._nodes[victim.parent].children -= 1
        self._free.extend(victim.pages)
        self.evictions += 1
        return True


def verify_prefix_index(cache: PrefixPageCache) -> None:
    """``pages.verify_page_plan`` extended to the shared store.  Raises on:
    node pages + free list not partitioning the allocated handle space
    (double-grant / leak), refcounts diverging from live-lease membership,
    a live lease's WRITTEN pages overlapping another live lease's, stale
    child counts, or resident bytes off the node-count model."""
    owned: List[int] = []
    for node in cache._nodes.values():
        assert len(node.pages) == cache.pages_per_chunk, node
        assert node.refs >= 0 and node.children >= 0, node
        owned.extend(node.pages)
    all_handles = owned + list(cache._free)
    assert len(set(all_handles)) == len(all_handles), "page handle collision"
    assert len(all_handles) == cache._next_page, \
        (len(all_handles), cache._next_page)
    # refcounts == live-lease membership, per node
    refs: Dict[int, int] = {}
    writers: Dict[int, int] = {}
    for lease in cache._live.values():
        for h in lease.chain:
            refs[h] = refs.get(h, 0) + 1
        for p in lease.new_pages:
            assert p not in writers, \
                f"page {p} written by rids {writers[p]} and {lease.rid}"
            writers[p] = lease.rid
    for key, node in cache._nodes.items():
        assert node.refs == refs.get(key, 0), (key, node.refs, refs.get(key))
    # child counts match the resident parent->child edges
    kids: Dict[int, int] = {}
    for node in cache._nodes.values():
        if node.parent is not None and node.parent in cache._nodes:
            kids[node.parent] = kids.get(node.parent, 0) + 1
    for key, node in cache._nodes.items():
        assert node.children == kids.get(key, 0), (key, node.children)
    # analytic residency model
    model = len(cache._nodes) * cache.pages_per_chunk * cache.page_bytes
    assert abs(cache.resident_bytes() - model) <= 1e-9 * max(model, 1.0)


class DeviceSeedCache:
    """Host-side pool snapshots for the DEVICE prefix path (TorchExecutor).

    One entry per request: the request's batch element of the final paged
    pool (``return_kv=True``), stage-stacked, keyed by its full hash chain.
    ``lookup(chain, k)`` returns any snapshot agreeing on the first ``k``
    chunks — pages past ``k`` are garbage to the new request, which is safe
    because its own writes for phases ``>= prefix_chunks`` overwrite them
    in lockstep.  Bounded LRU: snapshots are whole-pool sized.
    """

    def __init__(self, max_entries: int = 8):
        self.max_entries = int(max_entries)
        self._snaps: "OrderedDict[Tuple[int, ...], dict]" = OrderedDict()
        self._by_prefix: Dict[Tuple[int, ...], Tuple[int, ...]] = {}

    def put(self, chain: Sequence[int], element: dict) -> None:
        key = tuple(chain)
        if not key:
            return
        self._snaps[key] = element
        self._snaps.move_to_end(key)
        while len(self._snaps) > self.max_entries:
            self._snaps.popitem(last=False)
        self._reindex()

    def match(self, chain: Sequence[int]) -> int:
        """Longest seedable prefix of ``chain``, in chunks."""
        chain = tuple(chain)
        k = 0
        while k < len(chain) and chain[:k + 1] in self._by_prefix:
            k += 1
        return k

    def lookup(self, chain: Sequence[int], k: int) -> Optional[dict]:
        key = self._by_prefix.get(tuple(chain)[:k])
        if key is None:
            return None
        self._snaps.move_to_end(key)
        return self._snaps[key]

    def _reindex(self) -> None:
        self._by_prefix = {}
        for key in self._snaps:
            for j in range(1, len(key) + 1):
                self._by_prefix.setdefault(key[:j], key)
