"""Quantized KV page codec: int8 and fp8 encode-on-write, dequant-on-read
(mirrors ``repro.kvstore.quant``).

- ``auto`` / a float dtype name — passthrough: pages store the model dtype.
- ``int8``  — symmetric per-(page, layer, batch, kv-head) scale: amax over
  the token and head-dim axes, payload = round(kv / scale) clipped to ±127
  (``torch.round`` rounds half to even, like ``jnp.round``).
- ``fp8``   — the same scale maps amax to the e4m3 range and the payload is
  cast to ``torch.float8_e4m3fn`` (round to nearest even).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

FP8_MAX = 448.0          # float8_e4m3fn finite max
INT8_MAX = 127.0


@dataclass(frozen=True)
class KVCodec:
    """How KV pages are stored. ``quantized`` implies a per-head fp32 scale
    array rides along with each page."""
    name: str
    storage_dtype: str
    bytes_per_el: float
    quantized: bool

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.storage_dtype)


_FLOAT_BYTES = {"float32": 4.0, "bfloat16": 2.0, "float16": 2.0}

_TORCH_DTYPES = {
    "float32": torch.float32, "bfloat16": torch.bfloat16,
    "float16": torch.float16, "int8": torch.int8,
    "float8_e4m3fn": torch.float8_e4m3fn,
}


def torch_dtype(name) -> torch.dtype:
    """A dtype name of the reference (``"bfloat16"``...) as a torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    return _TORCH_DTYPES[str(name)]


def list_codecs() -> Tuple[str, ...]:
    return ("auto", "bfloat16", "float32", "int8", "fp8")


def get_codec(name: str, model_dtype: str = "bfloat16") -> KVCodec:
    """Resolve a ``kv_dtype`` knob value against the model dtype."""
    if name in ("auto", "", None):
        name = model_dtype
    if name in _FLOAT_BYTES:
        return KVCodec(name, name, _FLOAT_BYTES[name], quantized=False)
    if name == "int8":
        return KVCodec("int8", "int8", 1.0, quantized=True)
    if name == "fp8":
        return KVCodec("fp8", "float8_e4m3fn", 1.0, quantized=True)
    raise ValueError(f"unknown kv_dtype {name!r}; choose from {list_codecs()}")


def _amax_scale(kv: torch.Tensor, target: float) -> torch.Tensor:
    """Per-(.., kv-head) scale: amax over the token (-3) and head-dim (-1)
    axes of a [..., T, K, D] tensor, floored to avoid div-by-zero."""
    amax = kv.float().abs().amax(dim=(-3, -1), keepdim=True)
    return torch.clamp(amax, min=1e-6) / target


def encode(codec: KVCodec, kv: torch.Tensor, pages: int = 1
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """kv [..., T, K, D] -> (payload in storage dtype, per-PAGE scales
    [pages, ..., 1, K, 1] fp32 or None)."""
    if not codec.quantized:
        return kv, None
    *lead, t, k, d = kv.shape
    paged = kv.reshape(*lead, pages, t // pages, k, d)
    paged = torch.movedim(paged, -4, 0)          # [pages, ..., pt, K, D]
    if codec.name == "int8":
        scale = _amax_scale(paged, INT8_MAX)
        q = torch.clamp(torch.round(paged.float() / scale),
                        -INT8_MAX, INT8_MAX).to(torch.int8)
    else:
        scale = _amax_scale(paged, FP8_MAX)
        q = (paged.float() / scale).to(torch.float8_e4m3fn)
    q = torch.movedim(q, 0, -4).reshape(kv.shape)
    return q, scale


def as_bytes(x: torch.Tensor) -> torch.Tensor:
    """A uint8 view of an fp8 tensor (other dtypes pass through): CUDA
    builds of torch lack some data-movement ops (``roll``, ``index_put``)
    for float8, and moving the bytes is the same thing."""
    return x.view(torch.uint8) if x.dtype == torch.float8_e4m3fn else x


def stack(ts, dim: int = 0) -> torch.Tensor:
    """``torch.stack`` that moves fp8 payloads as bytes."""
    return torch.stack([as_bytes(t) for t in ts], dim).view(ts[0].dtype)


def expand_page_scale(scale: torch.Tensor, page_tokens: int) -> torch.Tensor:
    """[pages, ..., 1, K, 1] per-page scales -> [..., T, K, 1] per-token
    (T = pages * page_tokens)."""
    pages = scale.shape[0]
    s = torch.movedim(scale, 0, -4)              # [..., pages, 1, K, 1]
    tgt = s.shape[:-4] + (pages, page_tokens) + s.shape[-2:]
    s = s.expand(tgt)
    return s.reshape(s.shape[:-4] + (pages * page_tokens,) + s.shape[-2:])


def decode(payload: torch.Tensor, scale: Optional[torch.Tensor],
           out_dtype=None) -> torch.Tensor:
    """Inverse of ``encode``; works for every codec (scale None = identity)."""
    if scale is None:
        return payload if out_dtype is None else payload.to(out_dtype)
    out = payload.float() * scale
    return out if out_dtype is None else out.to(out_dtype)


def kv_compress_factor(codec: KVCodec, *, model_dtype: str = "bfloat16",
                       page_tokens: int = 0, head_dim: int = 0) -> float:
    """Stored-bytes ratio vs the model-dtype pool (lease accounting uses
    this to count quantized bytes). Includes the per-head scale overhead
    when the page/head geometry is known: one fp32 per (page, head) against
    ``page_tokens * head_dim`` payload elements."""
    base = _FLOAT_BYTES.get(model_dtype, 2.0)
    f = codec.bytes_per_el / base
    if codec.quantized and page_tokens and head_dim:
        f += 4.0 / (page_tokens * head_dim * base)
    return f
