"""Train step: CE loss, gradients by autograd, grad accumulation, AdamW
(mirrors ``repro.train.step`` on one device).

The reference's ``train_state_specs`` and its ``topo`` argument are
sharding specs for a jax mesh (FSDP over "data", Megatron TP over
"model"); one card has no mesh, so neither is ported. Remat is inside the
model's forward (``layers.remat_call`` around each layer body).

No kernel of ``kernels.ops`` lies on this path, as no Pallas kernel lies on
the reference's: the forward's attention is ``layers.flash_attention_xla``
and the SSD the ``torch`` scan, plain torch ops that autograd
differentiates.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch import device as device_mod
from repro_torch.models.api import Model
from repro_torch.train.optim import AdamWConfig, adamw_init, adamw_update, leaves, tree_map

TrainState = Dict[str, Any]  # {"params", "opt": {"m", "v", "step"}}


def init_train_state(model: Model, generator: torch.Generator, device=None) -> TrainState:
    """Random params drawn from ``generator`` (on ``device``: the card
    unless the caller asks for the CPU) and zero fp32 moments."""
    params = model.init(generator, device_mod.resolve(device))
    return {"params": params, "opt": adamw_init(params)}


def make_train_step(
    model: Model,
    opt_cfg: AdamWConfig = AdamWConfig(),
    *,
    grad_accum: int = 1,
    remat: bool = True,
) -> Callable[[TrainState, Dict[str, torch.Tensor]],
              Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    batch: {"tokens": [B, S], "labels": [B, S], ("embeds": [B, F, d])}.
    ``grad_accum`` > 1 takes B // grad_accum rows at a time, in order, and
    sums their gradients in fp32 (``acc + g.float()``), then divides by
    ``grad_accum``; the loss is their mean. metrics: {"loss",
    "grad_norm", "lr"}, fp32 scalars on the state's device (nothing is
    read back to the host). The state's params and moments are updated IN
    PLACE (see ``optim.adamw_update``) and returned in a new dict."""

    def loss_and_grads(params, tokens, labels, embeds):
        tree = tree_map(lambda p: p.detach().requires_grad_(True), params)
        kw = {} if embeds is None else {"embeds": embeds}
        with torch.enable_grad():
            loss = model.loss(tree, tokens, labels, remat=remat, **kw)
            grads = torch.autograd.grad(loss, leaves(tree), allow_unused=True,
                                        materialize_grads=True)
        return loss.detach(), grads

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = state["params"]
        tokens, labels = batch["tokens"], batch["labels"]
        embeds = batch.get("embeds")
        flat = leaves(params)
        if grad_accum == 1:
            loss, grads = loss_and_grads(params, tokens, labels, embeds)
        else:
            b = tokens.shape[0]
            assert b % grad_accum == 0
            mb = b // grad_accum
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in flat]
            loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
            for i in range(grad_accum):
                sl = slice(i * mb, (i + 1) * mb)
                l, g = loss_and_grads(params, tokens[sl], labels[sl],
                                      None if embeds is None else embeds[sl])
                for a, x in zip(acc, g):
                    a.add_(x)
                del g
                loss = loss + l
            grads = [a.div_(grad_accum) for a in acc]
            loss = loss / grad_accum
        new_params, new_opt, om = adamw_update(
            opt_cfg, _like(params, grads), state["opt"], params)
        return {"params": new_params, "opt": new_opt}, {"loss": loss, **om}

    return train_step


def _like(tree: Any, flat) -> Any:
    """The list ``flat`` (in ``leaves`` order) as a tree shaped like ``tree``."""
    it = iter(flat)

    def fill(t):
        if isinstance(t, dict):
            return {k: fill(t[k]) for k in sorted(t)}
        return next(it)
    return fill(tree)
