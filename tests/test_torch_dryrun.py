"""The port's dry run (``repro_torch.launch.{cells,dryrun}``) on the CPU:

- ``Model.input_specs`` (meta tensors) against the reference's
  ``ShapeDtypeStruct``s for every arch x shape: the same keys, shapes and
  dtypes, the vlm / encdec ``embeds`` and the decode ``cache`` included;
  ``abstract_params`` allocates nothing and draws no random number;
- ``SkipCell`` fires on exactly the reference's (arch, shape) pairs (the
  reference's own ``build_cell``, its cell builders stubbed out);
- at full size on meta, the ``wire_model``, ``occupancy_model`` and
  ``calibration`` records of qwen3-8b and zamba2-7b ``prefill_32k``
  ``mocap`` equal the reference's jax-free functions
  (``transport.analytic_wire_bytes``, ``telemetry.occupancy_model``,
  ``calibrate.calibration_record``) on the reference's plan at N 16;
- the counted products of the mocap smoke cell (qwen3-8b, N 4, M 8, C 16,
  B 2, K1 / K2 charged) equal their closed form: ticks x N x lps x a
  chunk's layer products, plus the head;
- one CLI run (``--arch qwen3-8b --shape prefill_32k --mode mocap``)
  writes a record with the reference's keys, ``ok`` true, terms under
  ``HW_H100``, on a machine with no card.
"""
import json
import os
import pathlib
import subprocess
import sys
from dataclasses import replace as dc_replace

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.base import RunConfig as RefRunConfig
from repro.configs.base import get_config as ref_config
from repro.core import costmodel as ref_cm
from repro.core import mbkr as ref_mbkr
from repro.core import pipeline as ref_pp
from repro.core import transport as ref_tx
from repro.launch import cells as ref_cells
from repro.models.api import build_model as ref_build
from repro.obs import calibrate as ref_cal
from repro.obs import telemetry as ref_t
from repro_torch.configs import SHAPES, RunConfig, ShapeConfig, get_smoke_config, list_archs
from repro_torch.core import costmodel as cm
from repro_torch.launch import cells, dryrun
from repro_torch.models.api import build_model
from repro_torch.models.layers import pad_vocab
from repro_torch.obs import calibrate as cal
from repro_torch.roofline import HW_H100, op_graph
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _leaves(specs, prefix=""):
    """{path: (shape, dtype name)} of a reference (ShapeDtypeStruct) or a
    port (meta tensor) input tree."""
    out = {}
    for k, v in specs.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = (tuple(v.shape), str(v.dtype).replace("torch.", ""))
    return out


@pytest.mark.parametrize("arch", list_archs())
def test_input_specs_match_reference(arch):
    from repro_torch.configs import get_config
    model, rmodel = build_model(get_config(arch)), ref_build(ref_config(arch))
    for name, shape in SHAPES.items():
        got = model.input_specs(shape)
        want = rmodel.input_specs(REF_SHAPES[name])
        assert _leaves(got) == _leaves(want), (arch, name)
        assert all(t.device.type == "meta" for t in op_graph._tensors(got))
    # shape-only weights: the tree of the reference's eval_shape(init)
    params = model.abstract_params()
    assert all(t.device.type == "meta" for t in op_graph._tensors(params))
    assert _leaves(params) == _leaves(jax.eval_shape(rmodel.init, jax.random.key(0)))


def test_skip_cells_match_reference(monkeypatch):
    for name in ("_train_cell", "_prefill_baseline_cell", "_prefill_pipeline_cell",
                 "_decode_cell"):
        monkeypatch.setattr(ref_cells, name, lambda *a, **k: "built")
    topo = type("Topo", (), {"num_stages": 16})()
    skipped = []
    for arch in dryrun.ARCHS:
        for shape in dryrun.SHAPE_NAMES:
            try:
                ref_cells.build_cell(arch, shape, topo)
                ref_skip = False
            except ref_cells.SkipCell:
                ref_skip = True
            if ref_skip:
                with pytest.raises(cells.SkipCell):
                    cells.build_cell(arch, shape)
                skipped.append((arch, shape))
            elif SHAPES[shape].kind == "decode":
                assert cells.build_cell(arch, shape).mode == "decode"
    assert skipped and all(s == "long_500k" for _, s in skipped)
    assert len(skipped) == len(dryrun.ARCHS) - 2          # all but zamba2-7b, mamba2-130m


@pytest.mark.parametrize("arch", ["qwen3-8b", "zamba2-7b"])
def test_plan_records_match_reference_at_full_size(arch, tmp_path):
    """Full width and depth on meta, N 16, the pod's shape: the cell's
    records against the reference's functions on the reference's plan."""
    path = str(tmp_path / "cal.json")
    prof = dc_replace(cm.WSC_PAPER, name="fitted", flops=cm.WSC_PAPER.flops * 0.7,
                      hbm_bw=cm.WSC_PAPER.hbm_bw * 1.1)
    cal.save_profile(path, prof, meta={"num_stages": 16})
    cell = cells.build_cell(arch, "prefill_32k", mode="mocap")
    rec = dryrun.plan_records(cell, path)
    assert all(t.device.type == "meta" for t in op_graph._tensors(cell.args))

    rcfg = ref_config(arch)
    shape = REF_SHAPES["prefill_32k"]
    rplan = ref_pp.build_plan(rcfg, 16, shape.seq_len, RefRunConfig(num_stages=16),
                              mode="mocap")
    assert rec["wire_model"] == ref_tx.analytic_wire_bytes(rplan, rcfg, shape.global_batch)
    want_occ = ref_t.occupancy_model(rplan)
    assert rec["occupancy_model"].keys() == want_occ.keys()
    for k, v in want_occ.items():
        np.testing.assert_array_equal(np.asarray(rec["occupancy_model"][k]), np.asarray(v))
    sm = ref_cm.StageModel.build(rcfg, 16, 1)
    assert rec["calibration"] == ref_cal.calibration_record(
        sm, [rplan.chunk_len] * rplan.num_chunks, ref_cm.WSC_PAPER, path,
        mbkr_plan=ref_mbkr.plan(rplan.num_chunks, 16))


def test_mocap_smoke_cell_products_equal_closed_form():
    cfg = get_smoke_config("qwen3-8b")
    n, m, c, b = 4, 8, 16, 2
    cell = cells._prefill_pipeline_cell(
        build_model(cfg), ShapeConfig("smoke", "prefill", m * c, b),
        RunConfig(num_chunks=m, attn_backend="cuda"), n, "mocap", 1)
    with torch.no_grad():
        cost = op_graph.count(cell.fn, *cell.args)
    plan = cell.meta["plan"]
    d, h, kvh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    layer = 2 * b * c * d * (2 * h * hd + 2 * kvh * hd + 3 * cfg.d_ff)   # q, k, v, o, SwiGLU
    head = 2 * b * d * pad_vocab(cfg.vocab_size)                         # the last token
    assert plan.num_ticks == m + n - 1
    assert cost.product_flops == plan.num_ticks * n * plan.layers_per_stage * layer + head
    assert cost.launches == {"chunk_attention": plan.num_ticks,
                             "pool_attention": 2 * plan.num_ticks}
    logits, ledger = cost.result
    assert logits.shape == (b, pad_vocab(cfg.vocab_size)) and ledger["ring"] > 0


def test_dryrun_cli_writes_a_record_without_a_card(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen3-8b",
                        "--shape", "prefill_32k", "--mode", "mocap", "--out", str(tmp_path)],
                       env=env, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "[OK  ] card" in r.stdout
    rec = json.loads((tmp_path / "card" / "qwen3-8b__prefill_32k__mocap.json").read_text())
    assert rec["ok"] and not rec.get("error")
    ref_keys = {"arch", "shape", "mesh", "mode", "chips", "attn_backend", "pool_backend",
                "kv_dtype", "ok", "wire_model", "tp_lowering", "occupancy_model", "memory",
                "roofline", "summary"}
    assert ref_keys <= rec.keys()
    assert {"argument_bytes", "output_bytes", "temp_bytes",
            "peak_bytes_per_device"} <= rec["memory"].keys()
    terms = rec["roofline"]
    assert {"flops_dev", "bytes_dev", "coll_dev", "coll_by_kind", "chips", "model_flops",
            "bytes_dev_eager", "flop_counter_flops", "peak_bytes_per_dev", "compute_s",
            "memory_s", "collective_s", "dominant", "useful_ratio",
            "roofline_fraction"} <= terms.keys()
    assert terms["hw"] == HW_H100 and terms["chips"] == 1 and terms["coll_dev"] == 0.0
    assert terms["coll_by_kind"]["qship_q"] == rec["wire_model"]["qship_q"]
    assert rec["launches"]["chunk_attention"] > 0 and rec["launches"]["pool_attention"] > 0
    assert terms["compute_s"] == pytest.approx(terms["flops_dev"] / HW_H100["peak_flops"])
