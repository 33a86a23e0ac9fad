"""Cell builder: one (arch x shape x mode) -> a step on meta tensors, the
counterpart of ``repro.launch.cells`` for one H100.

The reference builds a jit-able step and ``ShapeDtypeStruct`` arguments
sharded over a 16 x 16 pod mesh, which the dry run lowers. The port's
dry run runs the step itself on meta tensors (``roofline.op_graph.count``):
``Cell.fn(*Cell.args)`` is what one card would do, with no memory and no
kernel launched. The pod's 16 stages are the default; a stage is a tensor
dimension on the card, so the mesh has no counterpart.

Shape -> step function:
  train_4k     ``train.step.make_train_step`` (AdamW, remat, the
               reference's grad_accum 1) through autograd on meta.
  prefill_32k  mocap / terapipe / gpipe: ``prefill_pipeline`` (the run's
               attention and pool backends, ``cuda`` for the kernels);
               baseline_tp: ``Model.forward``'s last token, the
               conventional lowering, on one card without TP;
               mocap_opt: the manual kv_split lowering at an emulated tp
               (``pad_q_heads`` / ``pad_experts``, ``shard_params``).
  decode_32k   ``Model.decode_step`` against a cache of ``seq_len``, each
  long_500k    row at its last position (its ``kv_len`` made from host
               data, which the counter keeps); long_500k only for the
               sub-quadratic archs.

``enumerate_cell_meshes`` has no counterpart: the fleet's cells share the
one card since the fleet was ported.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import (RunConfig, ShapeConfig, SHAPES, get_config,
                                      replace)
from repro_torch.core import pipeline as pp
from repro_torch.core import transport
from repro_torch.core.staging import (TPLayout, init_staged, manual_tp_plan,
                                      shard_params)
from repro_torch.models.api import Model, build_model
from repro_torch.obs.telemetry import occupancy_model
from repro_torch.train.optim import AdamWConfig
from repro_torch.train.step import init_train_state, make_train_step

META = torch.device("meta")


@dataclass
class Cell:
    arch: str
    shape: ShapeConfig
    mode: str
    fn: Callable                      # fn(*args): one step
    args: Tuple[Any, ...]             # meta tensor pytrees
    meta: Dict[str, Any] = field(default_factory=dict)


class SkipCell(Exception):
    """This (arch x shape) combination is intentionally not runnable."""


def build_cell(arch: str, shape_name: str, *, mode: str = "auto",
               run: Optional[RunConfig] = None, num_stages: int = 16,
               tp: int = 16) -> Cell:
    """The cell's step and its meta arguments. ``tp``: the emulated tp
    degree of ``mocap_opt``'s kv_split view (the pod's 16); every other
    mode runs each stage whole on the card."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    run = run or RunConfig(num_stages=num_stages, attn_backend="cuda")
    model = build_model(cfg)

    if shape.kind == "decode" and shape.seq_len >= 200_000 and not cfg.subquadratic:
        raise SkipCell(
            f"{arch} x {shape_name}: full-attention arch skips the 500k "
            f"decode shape (quadratic; DESIGN.md §4 shape-skips)")

    if shape.kind == "train":
        return _train_cell(model, shape)
    if shape.kind == "prefill":
        m = "mocap" if mode == "auto" else mode
        if m == "baseline_tp":
            return _prefill_baseline_cell(model, shape)
        if m == "mocap_opt":
            return _prefill_pipeline_cell(model, shape, run, num_stages, "mocap", tp)
        return _prefill_pipeline_cell(model, shape, run, num_stages, m, 1)
    return _decode_cell(model, shape)


# ------------------------------------------------------------------- train

def _train_cell(model: Model, shape: ShapeConfig) -> Cell:
    state = init_train_state(model, None, device=META)
    step = make_train_step(model, AdamWConfig(), grad_accum=1, remat=True)
    return Cell(model.cfg.arch, shape, "train", step, (state, model.input_specs(shape)),
                meta={"family": model.cfg.family})


# ----------------------------------------------------------------- prefill

def _prefill_pipeline_cell(model: Model, shape: ShapeConfig, run: RunConfig,
                           num_stages: int, mode: str, tp: int) -> Cell:
    cfg = model.cfg
    run = replace(run, num_stages=num_stages,
                  tp_lowering="manual" if tp > 1 else run.tp_lowering)
    layout = None
    plan = pp.build_plan(cfg, num_stages, shape.seq_len, run, mode=mode)
    staged = init_staged(cfg, plan, None, device=META)
    if tp > 1:
        # the kv_split view (the reference's ("kv", "qg") axes) where the
        # kv heads divide, else the plain tp axis; q heads zero-padded per
        # kv group, MoE experts padded to the axis (expert parallelism)
        factors = (pp.kv_split_axes(cfg, tp)
                   if cfg.family in ("dense", "moe", "vlm") else None)
        layout = TPLayout(tp, kv=factors[0] if factors else 0)
        if factors and cfg.num_kv_heads * factors[2] != cfg.num_heads:
            cfg, staged = pp.pad_q_heads(cfg, staged, factors[2])
        if factors and cfg.moe is not None:
            cfg, staged = pp.pad_experts(cfg, staged, -(-cfg.moe.num_experts // tp) * tp)
        plan = pp.build_plan(cfg, num_stages, shape.seq_len, run, mode=mode)
        staged = shard_params(cfg, staged, manual_tp_plan(cfg, plan, layout))
    ins = model.input_specs(shape)

    def fn(st, tk, em=None):
        return pp.prefill_pipeline(cfg, st, tk, plan, device=META, embeds=em,
                                   layout=layout, return_ledger=mode != "gpipe")

    wire = (None if mode == "gpipe" or cfg.family == "ssm" else
            transport.analytic_wire_bytes(plan, cfg, shape.global_batch))
    meta = {"family": cfg.family, "plan": plan, "layout": layout, "wire_model": wire,
            "ledger": mode != "gpipe"}
    if wire is not None:
        meta["occupancy_model"] = occupancy_model(plan)
    args = (staged, ins["tokens"]) + ((ins["embeds"],) if "embeds" in ins else ())
    return Cell(cfg.arch, shape, "mocap_opt" if tp > 1 else mode, fn, args, meta)


def _prefill_baseline_cell(model: Model, shape: ShapeConfig) -> Cell:
    """Full-sequence prefill (no pipeline), the paper's 'conventional
    system': one next-token logit per row."""
    ins = model.input_specs(shape)

    def fn(params, batch):
        kw = {"embeds": batch["embeds"]} if "embeds" in batch else {}
        logits = model.forward(params, batch["tokens"], impl="xla_flash", **kw)
        return logits[:, -1]

    return Cell(model.cfg.arch, shape, "baseline_tp", fn,
                (model.abstract_params(), ins), meta={"family": model.cfg.family})


# ------------------------------------------------------------------ decode

def _decode_cell(model: Model, shape: ShapeConfig) -> Cell:
    ins = model.input_specs(shape)
    b, s = shape.global_batch, shape.seq_len

    def fn(params, cache, tokens):
        # every row at the cache's last position: made from host data, so
        # that K5's charge reads the rows' kv_len
        pos = torch.full((b,), s - 1, dtype=torch.int32, device=META)
        return model.decode_step(params, {**cache, "pos": pos}, tokens)

    return Cell(model.cfg.arch, shape, "decode", fn,
                (model.abstract_params(), ins["cache"], ins["tokens"]),
                meta={"family": model.cfg.family})
