"""The readings a cell's check limits are set from (``tools/calibrate.py``
and the control's test): the program's numbers on one seed, and with
``control`` also the control's, on the same prompts.

The program: the weights made from the seed, the cell's own mix driven for
a short window (long enough to finish its longest requests), the check's
sample against the fp32 reference. The control: the reference computed in
fp8, the precision below the configuration's bf16
(``reference.<family>.control_readings``, its next-token logits held to
the same numbers as the program's), and beside it the program with
its own fp8 KV pools (``kv_dtype="fp8"`` on paged pools).
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import time
from typing import Any, Dict

import numpy as np
import torch

from portbench.harness import check as CK
from portbench.harness.cell import build_program
from portbench.harness.layout import Layout
from portbench.harness.serve import Server
from portbench.harness.weights import sub_seed


def _fp8_kv_program(engine, ex, cfg, prompts, device) -> np.ndarray:
    from repro_torch.runtime.engine import PrefillEngine, Request, TorchExecutor
    run8 = dataclasses.replace(ex.run_cfg, kv_dtype="fp8", pool_backend="paged")
    eng8 = PrefillEngine(dataclasses.replace(engine.ec, kv_dtype="fp8"),
                         TorchExecutor(cfg, ex.staged, run8, device=device))
    for rid, p in enumerate(prompts):
        eng8.submit(Request(rid=rid, arrival=0.0, seq_len=len(p), tokens=p))
    eng8.run_until_drained()
    return np.stack([r.result for r in sorted(eng8.poll(), key=lambda r: r.rid)])


def readings(layout: Layout, name: str, seed: int, seconds: float, device: torch.device,
             control: bool = False) -> Dict[str, Any]:
    """{seed, requests, tokens, program: numbers, [program_kv_fp8: numbers,
    reference_fp8: numbers], seconds}."""
    cell = layout.cell(name)
    kind = layout.module("traffic", cell.mix["kind"])
    ref = importlib.import_module(f"portbench.reference.{cell.conf['family']}")
    v = cell.conf["vocab_size"]
    t0 = time.perf_counter()
    engine, ex, cfg = build_program(cell, seed, device)
    server = Server(engine, cfg.vocab_size, sub_seed(seed, "tokens"))
    server.open_window()
    kind.drive(server, cell.mix, seconds)
    picked = CK.sample(server.completed(), cell.spec["check"]["sample"], seed)
    prompts = [server.prompts[s.rid] for s in picked]
    got = {"program": np.stack([s.result[:v] for s in picked])}
    if control:
        got["program_kv_fp8"] = _fp8_kv_program(engine, ex, cfg, prompts, device)[:, :v]
    del engine, ex, server
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    out: Dict[str, Any] = {"seed": seed, "requests": len(prompts),
                           "tokens": [len(p) for p in prompts]}
    if control:
        cr = ref.control_readings(cell.conf, seed, prompts, device)
        want = cr["logits"]
        out["reference_fp8"] = CK.numbers(cr["control"], want)
    else:
        want = ref.next_token_logits(cell.conf, seed, prompts, device)
    out.update({k: CK.numbers(g, want) for k, g in got.items()})
    out["seconds"] = {"program": t1 - t0, "reference": time.perf_counter() - t1}
    return out
