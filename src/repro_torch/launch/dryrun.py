"""Dry run on meta tensors: count EVERY (arch x shape x mode) cell's step
and record its memory and its H100 roofline terms, the counterpart of
``repro.launch.dryrun``.

The reference lowers and compiles each cell on 512 placeholder host
devices and reads XLA's analyses. The port runs each cell's step once on
meta tensors under ``roofline.op_graph.count`` (by design: no card is
needed or touched, no memory is allocated, no kernel launches; each
hand-written kernel is charged its ``kernel_work``) and reads the terms of
``roofline.analysis`` under ``HW_H100``.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape prefill_32k
  python -m repro_torch.launch.dryrun --all [--jobs 4]   # subprocess per cell

Artifacts: <out>/card/<arch>__<shape>__<mode>.json, with the reference's
keys where they mean the same thing: ``memory``, ``roofline``
(``RooflineTerms.to_dict()``), ``summary``, ``wire_model``,
``occupancy_model`` and, given a profile, ``calibration``; ``by_op`` (the
ops and kernels with the most eager bytes) and ``launches`` (the kernels'
calls) beside them.
"""
import argparse
import json
import os
import subprocess
import sys
import time
import traceback
from typing import List, Optional, Tuple

ARCHS = (
    "whisper-small", "qwen3-8b", "stablelm-3b", "granite-3-2b", "qwen3-14b",
    "granite-moe-3b-a800m", "qwen2-moe-a2.7b", "llava-next-34b",
    "zamba2-7b", "mamba2-130m",
)
SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
MESHES = ("card",)       # one H100: the stage axis is a tensor dimension


def plan_records(cell, calibrated_profile: Optional[str] = None) -> dict:
    """A pipeline cell's records off its plan, with no count: the closed-form
    §3.4 wire bytes and the tick x stage occupancy (which the runtime ledger
    and the stage telemetry are held to in the tests) and, given a
    calibrated profile, the per-(chunk, stage) calibration residuals and the
    nominal-vs-calibrated predicted chunk costs. Empty for other cells."""
    if not cell.meta.get("wire_model"):
        return {}
    plan = cell.meta["plan"]
    rec = {"wire_model": cell.meta["wire_model"], "tp_lowering": plan.tp_lowering,
           "occupancy_model": cell.meta["occupancy_model"]}
    if calibrated_profile:
        from repro_torch.configs.base import get_config
        from repro_torch.core import costmodel as _cm
        from repro_torch.core import mbkr as _mb
        from repro_torch.obs import calibrate as _cal
        sm = _cm.StageModel.build(get_config(cell.arch), plan.num_stages, 1)
        mplan = (_mb.plan(plan.num_chunks, plan.num_stages)
                 if plan.mode == "mocap" else None)
        rec["calibration"] = _cal.calibration_record(
            sm, [plan.chunk_len] * plan.num_chunks, _cm.WSC_PAPER,
            calibrated_profile, mbkr_plan=mplan)
    return rec


def run_cell(arch: str, shape_name: str, mesh_kind: str, mode: str,
             kv_dtype: str = "auto", kv_page_tokens: int = 0,
             pool_backend: str = "cuda",
             calibrated_profile: Optional[str] = None) -> dict:
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs.base import SHAPES, RunConfig, get_config
    from repro_torch.launch.cells import SkipCell, build_cell
    from repro_torch.roofline import op_graph
    from repro_torch.roofline.analysis import analyze_counted, collective_bytes

    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "mode": mode,
           "chips": 1, "attn_backend": "cuda", "pool_backend": pool_backend,
           "kv_dtype": kv_dtype, "ok": False}
    t0 = time.time()
    run = RunConfig(attn_backend="cuda", pool_backend=pool_backend, ssm_backend="cuda",
                    kv_dtype=kv_dtype, kv_page_tokens=kv_page_tokens)
    try:
        cell = build_cell(arch, shape_name, mode=mode, run=run)
    except SkipCell as e:
        rec.update(ok=True, skipped=True, reason=str(e))
        return rec
    rec.update(plan_records(cell, calibrated_profile))
    try:
        grad = torch.enable_grad() if cell.mode == "train" else torch.no_grad()
        with grad, FlopCounterMode(display=False) as fc:
            cost = op_graph.count(cell.fn, *cell.args)
        rec["count_s"] = time.time() - t0
        ledger = cost.result[1] if cell.meta.get("ledger") else None
        terms = analyze_counted(cost, get_config(arch), SHAPES[shape_name],
                                coll_by_kind=collective_bytes(ledger),
                                flop_counter_flops=fc.get_total_flops())
        rec["memory"] = {
            "argument_bytes": int(cost.argument_bytes),
            "output_bytes": int(cost.output_bytes),
            "temp_bytes": int(cost.peak_live_bytes - cost.argument_bytes),
            "peak_bytes_per_device": int(cost.peak_live_bytes),
            "fits_hbm": cost.peak_live_bytes <= terms.hw["hbm_cap"],
        }
        rec["roofline"] = terms.to_dict()
        rec["launches"] = dict(cost.launches)
        rec["by_op"] = dict(cost.top(16))
        rec["ok"] = True
        rec["summary"] = terms.summary()
    except Exception as e:  # noqa: BLE001 — a failed cell is a data point
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def cell_modes(shape_name: str) -> Tuple[str, ...]:
    # prefill counts the paper technique (faithful + optimized) AND the
    # conventional baseline as first-class modes
    if shape_name == "prefill_32k":
        return ("mocap", "baseline_tp", "mocap_opt")
    return ("auto",)


def save(rec: dict, out_dir: str) -> str:
    os.makedirs(os.path.join(out_dir, rec["mesh"]), exist_ok=True)
    path = os.path.join(out_dir, rec["mesh"],
                        f"{rec['arch']}__{rec['shape']}__{rec['mode']}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=float)
    return path


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Count every cell's step on meta tensors (no card needed) and "
                    "record its memory and H100 roofline terms. The reference's "
                    "--tp-lowering has no counterpart: one card has no GSPMD, and "
                    "mocap_opt takes the manual lowering at an emulated tp 16.")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="card", choices=MESHES,
                    help="one H100 (the reference's pod / multipod meshes have no "
                         "counterpart: a stage is a tensor dimension)")
    ap.add_argument("--mode", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="run cells in parallel subprocesses")
    ap.add_argument("--pool-backend", default="cuda",
                    choices=("cuda", "paged", "torch"),
                    help="backend for pool-sourced partials: cuda = K2 over a "
                         "gathered slot stack, paged = K3 reading pages in place, "
                         "torch = the plain blocks (counted as eager ops)")
    ap.add_argument("--kv-dtype", default="auto",
                    choices=("auto", "bfloat16", "int8", "fp8"),
                    help="KV page-store codec for pipeline modes (kvstore)")
    ap.add_argument("--kv-page-tokens", type=int, default=0,
                    help="tokens per KV page (0 = one page per chunk)")
    ap.add_argument("--calibrated-profile", default=None,
                    help="calibrated-profile JSON (obs.calibrate / serve "
                         "--calibrate): records per-(chunk, stage) fit "
                         "residuals and the nominal-vs-calibrated predicted "
                         "chunk costs next to wire_model/occupancy_model")
    ap.add_argument("--out", default="artifacts/dryrun")
    args = ap.parse_args(argv)

    cells: List[Tuple[str, str, str, str]] = []
    archs = ARCHS if (args.all or not args.arch) else (args.arch,)
    shapes = SHAPE_NAMES if (args.all or not args.shape) else (args.shape,)
    for arch in archs:
        for shape in shapes:
            for mode in (cell_modes(shape) if args.mode is None else (args.mode,)):
                cells.append((arch, shape, args.mesh, mode))

    if args.jobs > 1:
        return _run_parallel(cells, args)

    failures = 0
    for arch, shape, mesh, mode in cells:
        rec = run_cell(arch, shape, mesh, mode, args.kv_dtype, args.kv_page_tokens,
                       args.pool_backend, args.calibrated_profile)
        save(rec, args.out)
        status = ("SKIP" if rec.get("skipped") else
                  "OK" if rec["ok"] else "FAIL")
        extra = rec.get("summary", rec.get("reason", rec.get("error", "")))
        print(f"[{status:4}] {mesh:8} {arch:22} {shape:12} {mode:12} "
              f"{extra}", flush=True)
        failures += 0 if rec["ok"] else 1
    return 1 if failures else 0


def _run_parallel(cells, args) -> int:
    procs: List[Tuple[subprocess.Popen, tuple]] = []
    pending = list(cells)
    failures = 0

    def launch(cell):
        arch, shape, mesh, mode = cell
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
               "--shape", shape, "--mesh", mesh, "--mode", mode,
               "--pool-backend", args.pool_backend, "--kv-dtype", args.kv_dtype,
               "--kv-page-tokens", str(args.kv_page_tokens), "--out", args.out]
        if args.calibrated_profile:
            cmd += ["--calibrated-profile", args.calibrated_profile]
        return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    while pending or procs:
        while pending and len(procs) < args.jobs:
            cell = pending.pop(0)
            procs.append((launch(cell), cell))
        done = [i for i, (p, _) in enumerate(procs) if p.poll() is not None]
        for i in sorted(done, reverse=True):
            p, cell = procs.pop(i)
            out = p.stdout.read() if p.stdout else ""
            print(out.strip(), flush=True)
            failures += 1 if p.returncode else 0
        time.sleep(0.3)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
