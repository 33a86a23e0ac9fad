"""Whole runs at a small size on the CPU: the harness's look for a card
skipped, the rest of a run driven. A sound run is correct and loads no
module of JAX or of the JAX package; a run whose timed path is broken
underneath comes out not correct; ``run.py`` prints no result where it may
not run."""
import json
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from conftest import ROOT
from portbench.harness import cell as C
from portbench.harness.layout import Layout

CPU = torch.device("cpu")
SEED = 2 ** 31 + 4242


def run(root, name, seconds=1.0, trace=False):
    return C.run_cell(Layout(root), name, SEED, seconds, trace, device=CPU, t_start=0.0)


@pytest.mark.parametrize("name,trace", [("qwen3-8b.long32k", False), ("qwen3-8b.open4k", False),
                                        ("qwen3-8b.batch4k", False), ("qwen3-8b.long32k", True)])
def test_a_sound_run_is_correct(smoke_root, name, trace):
    res = run(smoke_root, name, trace=trace)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[0] == "correct" and list(res)[-1] == "checks"
    want = {m["name"] for m in (Layout(smoke_root).cell(name).per_layer if trace
                                else Layout(smoke_root).cell(name).end_to_end)}
    got = set(res["metrics"])
    # on the CPU nothing is read from a device trace or the card's allocator
    assert got <= want and ("setup_s" in got or trace)
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]


def test_a_run_loads_no_jax(smoke_root):
    code = (
        "import json, sys, torch\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        "from portbench.harness.layout import Layout\n"
        "from portbench.harness.cell import run_cell\n"
        f"res = run_cell(Layout({str(smoke_root)!r}), 'qwen3-8b.long32k', 7, 1.0, False,\n"
        "               device=torch.device('cpu'), t_start=0.0)\n"
        "top = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(json.dumps({'result': res is not None, 'top': top}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["result"]
    assert not set(got["top"]) & {"jax", "jaxlib", "flax", "repro"}
    assert "repro_torch" in got["top"]          # compared whole: no prefix match


def test_a_loaded_jax_module_withholds_the_result(smoke_root, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert run(smoke_root, "qwen3-8b.long32k") is None


def _broken(monkeypatch, fault):
    """Breaks ``TorchExecutor.run`` underneath the harness, where the
    answers are produced: a wave that hands back the last wave's answers
    (its state unchanged), every answer altered at one logit, or the second
    half of each batch left out (given the first half's answers)."""
    from repro_torch.runtime import engine as E
    real = E.TorchExecutor.run
    last = []

    def run(self, requests, *a, **k):
        out = real(self, requests, *a, **k)
        if fault == "answers_of_the_last_wave":
            fresh = [r.result for r in requests]
            if last:
                for r in requests:
                    r.result = last[0]
            last[:] = fresh
        elif fault == "answer_altered":
            for r in requests:
                r.result = r.result.copy()
                r.result[int(np.argmin(r.result))] = r.result.max() + 1.0
        elif fault == "half_the_batch_left_out":
            half = len(requests) // 2
            for i, r in enumerate(requests[len(requests) - half:]):
                r.result = requests[i].result.copy()
        return out
    monkeypatch.setattr(E.TorchExecutor, "run", run)


FAULTS = [(cell, fault) for cell in ("qwen3-8b.open4k", "qwen3-8b.long32k", "qwen3-8b.batch4k")
          for fault in ("answers_of_the_last_wave", "answer_altered", "half_the_batch_left_out")]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(smoke_root, monkeypatch, name, fault):
    spec_file = smoke_root / "portbench" / "workloads" / f"{name}.json"
    spec = json.loads(spec_file.read_text())
    if "rate" in spec.get("traffic", {}):
        # arrivals 5x faster than a wave at this size: the queue forms batches
        # on any host, so there is a second half of a batch to leave out
        spec["traffic"]["rate"] = 40.0
        spec_file.write_text(json.dumps(spec))
    _broken(monkeypatch, fault)
    res = run(smoke_root, name, seconds=2.0)
    assert res is not None and res["correct"] is False
    assert res["failed"] == 0                   # each fault is caught by the comparison


def _load_run_py(root):
    import importlib.util
    spec = importlib.util.spec_from_file_location("portbench_run_copy", root / "portbench/run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_run_py_without_a_card_prints_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = _load_run_py(ROOT).main(["--workload", "qwen3-8b.long32k", "--seed", "1",
                                  "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_run_py_beside_nothing_but_the_benchmark_prints_no_result(tmp_path, monkeypatch, capsys):
    """A directory holding only BENCHMARK.json and portbench/: no program."""
    import shutil
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    mod = _load_run_py(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    rc = mod.main(["--workload", "qwen3-8b.long32k", "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""
