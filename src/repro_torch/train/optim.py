"""AdamW + the cosine LR schedule, hand-rolled (mirrors
``repro.train.optim``).

The optimizer state is a dict mirroring the params, {"m", "v": fp32
moments, "step": int32 scalar}, so it checkpoints through
``runtime.checkpoint`` like any other tree. Every quantity is computed in
the order and the dtype the reference computes it (fp32 moments and
update, cast back to the parameter's dtype; the LR taken at the step
before the increment, the bias corrections after it), one torch op per
jnp op.

``adamw_update`` writes the new params and moments IN PLACE into the
tensors of ``params`` and ``state`` and returns them (a functional copy
of an 8B model's params and moments does not fit on the card beside
them); ``step`` is a new tensor.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import torch

Params = Any


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def leaves(tree: Params) -> List[torch.Tensor]:
    """The tensors of a nested dict in sorted key order (``jax.tree.leaves``'
    order)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    return [tree]


def tree_map(fn, tree: Params, *rest: Params) -> Params:
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to min_lr_frac * lr, as an fp32
    scalar on ``step``'s device (``step``: an int32 tensor)."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = cfg.lr * (step + 1).float() / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps).float()
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.lr * (cfg.min_lr_frac + (1 - cfg.min_lr_frac)
                    * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params: Params) -> Dict[str, Any]:
    zeros = lambda p: tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                                     device=x.device), p)
    first = leaves(params)[0]
    return {"m": zeros(params), "v": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


def _global_norm(tree: Params) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.float())) for x in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def adamw_update(cfg: AdamWConfig, grads: Params, state: Dict[str, Any],
                 params: Params) -> Tuple[Params, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step with global-norm clipping and decoupled weight decay,
    which applies where ``p.ndim > 1`` (so to the stacked [L, d] norm
    weights too, as in the reference). Returns (params, state, {"grad_norm",
    "lr"}); params, m and v are the input tensors, updated in place."""
    with torch.no_grad():
        step = state["step"] + 1
        gnorm = _global_norm(grads)
        clip = torch.clamp(gnorm.new_tensor(cfg.grad_clip)
                           / torch.clamp(gnorm, min=1e-9), max=1.0)
        lr = cosine_lr(cfg, state["step"])
        b1c = 1 - cfg.b1 ** step.float()
        b2c = 1 - cfg.b2 ** step.float()

        def upd(g, m, v, p):
            g = g.float() * clip
            m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
            update = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
            if p.ndim > 1:
                update.add_(cfg.weight_decay * p.float())
            p.copy_(p.float() - lr * update)

        tree_map(upd, grads, state["m"], state["v"], params)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, {"m": state["m"], "v": state["v"], "step": step}, metrics
