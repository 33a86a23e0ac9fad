"""Model facade, the counterpart of ``repro.models.api`` for every family
(dense, moe and vlm on the transformer, ssm, hybrid, encdec on whisper):
``build_model(cfg)`` returns a `Model` whose methods are plain functions
over parameter dicts. Entry points run on the card unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch

from repro_torch import device as device_mod
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import hybrid, ssm, transformer, whisper
from repro_torch.models import layers as L

_FAMILIES = {"dense": transformer, "moe": transformer, "vlm": transformer,
             "ssm": ssm, "hybrid": hybrid, "encdec": whisper}


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

    def abstract_params(self):
        """Shape-only weights on the meta device (the counterpart of
        ``jax.eval_shape(model.init)``): no memory, and no random number is
        drawn, since a ``torch.Generator`` cannot be bound to meta."""
        return self._mod.init(self.cfg, None, torch.device("meta"))

    def forward(self, params, tokens: torch.Tensor, return_cache: bool = False,
                embeds=None, **kw):
        """fp32 logits [B, S, Vpad] and, with ``return_cache``, the cache
        (the SSM state for the ssm family) that ``decode_step`` continues.
        ``embeds`` [B, F, d]: the vlm's patch embeddings (spliced in front
        of the tokens) or the encdec's frame embeddings (the encoder's
        input)."""
        if embeds is not None:
            kw["embeds"] = embeds
        return self._mod.forward(self.cfg, params, tokens, return_cache=return_cache, **kw)

    def loss(self, params, tokens: torch.Tensor, labels: torch.Tensor, *,
             impl: str = "xla_flash", remat: bool = True, **kw) -> torch.Tensor:
        """Mean next-token cross-entropy (fp32 scalar) of ``forward`` on
        ``tokens`` against ``labels`` [B, St], with the reference's
        ``model.loss`` defaults (the blocked flash attention, remat). The
        vlm's patches and the encdec's frames (``embeds=``) carry no
        labels: only the last St positions are scored."""
        logits = self.forward(params, tokens, impl=impl, remat=remat, **kw)
        if logits.shape[1] != labels.shape[1]:
            logits = logits[:, logits.shape[1] - labels.shape[1]:]
        return L.cross_entropy(logits, labels, self.cfg.vocab_size)

    def decode_step(self, params, cache, tokens: torch.Tensor):
        """One token per row: (logits [B, Vpad], cache); the cache tensors
        are updated in place, ``pos + 1`` is a new tensor."""
        return self._mod.decode_step(self.cfg, params, cache, tokens)

    def init_cache_shape(self, batch: int, max_len: int):
        """{leaf: (shape, dtype)}; the ssm family's state has no length."""
        return self._mod.init_cache_shape(self.cfg, batch, max_len)

    def init_cache(self, batch: int, max_len: int, device=None):
        return L.zeros(self.init_cache_shape(batch, max_len), device_mod.resolve(device))

    # ----------------------------------------------------------- dry-run
    def input_specs(self, shape: ShapeConfig) -> Dict[str, Any]:
        """Meta-tensor stand-ins for every input of a (this arch x shape)
        cell, where the reference returns ``ShapeDtypeStruct``s: the same
        keys, shapes and dtypes (int32 tokens; the vlm's patch and the
        encdec's frame ``embeds`` in bf16; a decode ``cache``).

        The reference's ``input_sharding_specs`` has no counterpart: on one
        card no input is sharded over a device mesh."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        meta = torch.device("meta")
        front = cfg.frontend
        out: Dict[str, Any] = {}
        if shape.kind in ("train", "prefill"):
            s_tok = s - front.num_embeds if front.kind == "vision_stub" else s
            out["tokens"] = torch.empty((b, s_tok), dtype=torch.int32, device=meta)
            if front.kind in ("vision_stub", "audio_stub"):
                out["embeds"] = torch.empty((b, front.num_embeds, cfg.d_model),
                                            dtype=torch.bfloat16, device=meta)
            if shape.kind == "train":
                out["labels"] = torch.empty((b, s_tok), dtype=torch.int32, device=meta)
        else:
            out["tokens"] = torch.empty((b,), dtype=torch.int32, device=meta)
            out["cache"] = L.zeros(self.init_cache_shape(b, s), meta)
        return out


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
