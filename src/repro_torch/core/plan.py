"""Static pipeline planning: everything decided before the tick loop runs
(mirrors ``repro.core.plan``; the TP lowering knob is dropped — the port
runs tp = 1).

A ``PipelinePlan`` pins the pipeline geometry (N stages x M chunks x C
tokens), the MBKR slot plan and its static numpy lookup tables, the KV page
layout, and the policy knobs every lower layer reads: ``remote_attn``
(fetch | qship), ``attn_backend`` (torch | cuda) and ``pool_backend``
(torch | cuda | paged) and ``ssm_backend`` (torch | cuda, the SSD inner
loop of the ssm / hybrid stage programs). A ``gpipe`` plan (the
microbatch baseline, ``core.gpipe``) has no chunks and no pool: chunk_len
0, num_chunks = the number of microbatches M.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core import mbkr
from repro_torch.kvstore import pages as kvpages
from repro_torch.kvstore import quant as kvquant


@dataclass(frozen=True)
class PipelinePlan:
    mode: str                 # mocap | terapipe | gpipe
    num_stages: int           # N
    num_chunks: int           # M
    chunk_len: int            # C
    layers_per_stage: int     # lps = ceil(L / N); hybrid: groups per stage
    num_slots: int            # KV pool size (excl. scratch)
    p2: int                   # spill threshold (chunks >= p2 spill); M if no MBKR
    remote_attn: str = "qship"
    attn_backend: str = "torch"
    pool_backend: str = "torch"  # resolved, never "auto"
    ssm_backend: str = "torch"
    spill_dtype: str = "bfloat16"
    ship_dtype: str = "bfloat16"
    kv_dtype: str = "bfloat16"   # resolved storage knob
    page_tokens: int = 0
    pages_per_chunk: int = 1
    own_slot: Any = None          # [M] chunk -> own slot (scratch if spilled)
    host_slot_a: Any = None       # [M] chunk -> host slot (first-half hosts)
    host_slot_b: Any = None
    slot_own_chunk: Any = None    # [slots+1] slot -> own chunk (-1 none)
    slot_host_chunk_a: Any = None  # [slots+1] slot -> hosted pair chunk (-1)
    slot_host_chunk_b: Any = None
    host_slots_used: Any = None   # [H] slots the host tables touch
    slot_pages: Any = None        # [slots+1, ppc] slot -> physical page ids

    @property
    def scratch(self) -> int:
        return self.num_slots

    @property
    def codec(self) -> kvquant.KVCodec:
        return kvquant.get_codec(self.kv_dtype)

    @property
    def page_geometry(self) -> kvpages.PageGeometry:
        return kvpages.PageGeometry(
            self.chunk_len, self.page_tokens, self.pages_per_chunk,
            self.num_slots, (self.num_slots + 1) * self.pages_per_chunk)

    @property
    def num_ticks(self) -> int:
        return self.num_chunks + self.num_stages - 1

    @property
    def pair_shift(self) -> int:
        return self.num_stages // 2


def _invert(table: np.ndarray, num_slots: int, lo: int, hi: int) -> np.ndarray:
    inv = np.full(num_slots + 1, -1, np.int32)
    for chunk in range(lo, hi):
        s = int(table[chunk])
        if s <= num_slots:
            inv[s] = chunk
    return inv


def build_plan(cfg: ModelConfig, num_stages: int, seq_len: int,
               run: RunConfig, *, mode: Optional[str] = None) -> PipelinePlan:
    """Derive the static pipeline plan for one (arch, shape, run) cell."""
    mode = mode or ("mocap" if run.mbkr else "terapipe")
    if mode not in ("mocap", "terapipe", "gpipe"):
        raise ValueError(f"unknown mode {mode!r} (mocap | terapipe | gpipe)")
    if run.attn_backend not in ("torch", "cuda"):
        raise ValueError(f"unknown attn_backend {run.attn_backend!r}")
    pool_backend = (run.attn_backend if run.pool_backend in ("auto", "", None)
                    else run.pool_backend)
    if pool_backend not in ("torch", "cuda", "paged"):
        raise ValueError(f"unknown pool_backend {run.pool_backend!r}")
    if run.ssm_backend not in ("torch", "cuda"):
        raise ValueError(f"unknown ssm_backend {run.ssm_backend!r}")
    m = run.num_chunks
    if mode == "gpipe":
        return PipelinePlan(mode, num_stages, m, 0,
                            _layers_per_stage(cfg, num_stages), 0, m,
                            attn_backend=run.attn_backend,
                            pool_backend=pool_backend,
                            ssm_backend=run.ssm_backend)
    assert seq_len % m == 0, f"seq_len {seq_len} must divide into {m} chunks"
    c = seq_len // m
    use_mbkr = mode == "mocap" and not cfg.attn_free and num_stages >= 2 and m >= 2
    mp = mbkr.plan(m, num_stages, mbkr=use_mbkr)
    codec = kvquant.get_codec(run.kv_dtype, cfg.dtype)
    geom = kvpages.page_geometry(c, mp.num_slots, run.kv_page_tokens)
    slot_pages = kvpages.build_slot_pages(geom)
    kvpages.verify_page_plan(slot_pages, geom)
    return PipelinePlan(
        mode=mode, num_stages=num_stages, num_chunks=m, chunk_len=c,
        layers_per_stage=_layers_per_stage(cfg, num_stages),
        num_slots=mp.num_slots, p2=mp.p2,
        remote_attn=run.remote_attn,
        attn_backend=run.attn_backend,
        pool_backend=pool_backend,
        ssm_backend=run.ssm_backend,
        spill_dtype=run.kv_spill_dtype,
        ship_dtype=cfg.dtype,
        kv_dtype=codec.name, page_tokens=geom.page_tokens,
        pages_per_chunk=geom.pages_per_chunk, slot_pages=slot_pages,
        own_slot=mp.own_slot, host_slot_a=mp.host_slot_a,
        host_slot_b=mp.host_slot_b,
        slot_own_chunk=_invert(mp.own_slot, mp.num_slots, 0, mp.p2),
        slot_host_chunk_a=_invert(mp.host_slot_a, mp.num_slots, mp.p2, m),
        slot_host_chunk_b=_invert(mp.host_slot_b, mp.num_slots, mp.p2, m),
        host_slots_used=np.unique(np.concatenate(
            [mp.host_slot_a[mp.p2:], mp.host_slot_b[mp.p2:]])).astype(np.int32)
        if mp.p2 < m else np.zeros((0,), np.int32),
    )


def _layers_per_stage(cfg: ModelConfig, n: int) -> int:
    if cfg.family == "hybrid":
        nl = cfg.hybrid.num_groups + 1  # +1 pseudo-group for the SSM tail
    else:
        nl = cfg.num_layers
    return -(-nl // n)
