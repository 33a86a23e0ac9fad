"""Model facade, the counterpart of ``repro.models.api`` for the families the
port registers (dense, moe, ssm, hybrid): ``build_model(cfg)`` returns a `Model`
whose methods are plain functions over parameter dicts. Entry points run on
the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch import device as device_mod
from repro_torch.configs.base import ModelConfig
from repro_torch.models import hybrid, ssm, transformer
from repro_torch.models import layers as L

_FAMILIES = {"dense": transformer, "moe": transformer, "ssm": ssm, "hybrid": hybrid}


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    @property
    def _mod(self):
        if self.cfg.family not in _FAMILIES:
            raise KeyError(f"family {self.cfg.family!r} is not ported; "
                           f"ported: {sorted(_FAMILIES)}")
        return _FAMILIES[self.cfg.family]

    def init(self, generator: torch.Generator, device=None):
        """Random weights drawn from ``generator`` (on the same device)."""
        return self._mod.init(self.cfg, generator, device_mod.resolve(device))

    def forward(self, params, tokens: torch.Tensor, return_cache: bool = False, **kw):
        """fp32 logits [B, S, Vpad] and, with ``return_cache``, the cache
        (the SSM state for the ssm family) that ``decode_step`` continues."""
        return self._mod.forward(self.cfg, params, tokens, return_cache=return_cache, **kw)

    def decode_step(self, params, cache, tokens: torch.Tensor):
        """One token per row: (logits [B, Vpad], cache); the cache tensors
        are updated in place, ``pos + 1`` is a new tensor."""
        return self._mod.decode_step(self.cfg, params, cache, tokens)

    def init_cache_shape(self, batch: int, max_len: int):
        """{leaf: (shape, dtype)}; the ssm family's state has no length."""
        return self._mod.init_cache_shape(self.cfg, batch, max_len)

    def init_cache(self, batch: int, max_len: int, device=None):
        return L.zeros(self.init_cache_shape(batch, max_len), device_mod.resolve(device))


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
