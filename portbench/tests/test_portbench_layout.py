"""A cell, a configuration, a traffic mix and a per-layer metric are found
from added files and BENCHMARK.json entries alone."""
import json

import pytest

from portbench.harness.layout import Layout


def test_added_files_are_found_by_name(smoke_root):
    bench = json.loads((smoke_root / "BENCHMARK.json").read_text())
    pb = smoke_root / "portbench"
    conf = json.loads((pb / "configs" / "qwen3-8b.json").read_text())
    conf["num_hidden_layers"] = 2
    (pb / "configs" / "tiny-dense.json").write_text(json.dumps(conf))
    (pb / "traffic" / "pair2k.json").write_text(
        json.dumps({"kind": "closed", "clients": 2, "prompt_tokens": 64}))
    spec = json.loads((pb / "workloads" / "qwen3-8b.long32k.json").read_text())
    spec["engine"].update(bucket=64, max_batch=2)
    (pb / "workloads" / "tiny-dense.pair2k.json").write_text(json.dumps(spec))
    (pb / "metrics" / "waves.count.py").write_text(
        'LAYER = "serving loop: runtime/engine.py PrefillEngine.step"\n'
        'UNIT = "waves"\nSOURCE = "program_span"\nMOVES = "prefill_tok_s"\n\n\n'
        'def read(run):\n    return len(run.waves) or None\n')
    bench["configs"].append({"name": "tiny-dense", "source": "https://example.org/tiny",
                             "file": "portbench/configs/tiny-dense.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "tiny-dense.pair2k", "config": "tiny-dense",
                               "traffic": "pair2k", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "waves.count", "unit": "waves", "better": "lower",
                               "source": "program_span",
                               "layer": "serving loop: runtime/engine.py PrefillEngine.step",
                               "moves": "prefill_tok_s", "workloads": ["tiny-dense.pair2k"]})
    for m in bench["end_to_end"]:
        if m["name"] in ("prefill_tok_s", "peak_gib"):
            m["workloads"].append("tiny-dense.pair2k")
    (smoke_root / "BENCHMARK.json").write_text(json.dumps(bench))

    layout = Layout(smoke_root)
    cell = layout.cell("tiny-dense.pair2k")
    assert cell.conf["num_hidden_layers"] == 2 and cell.conf["name"] == "tiny-dense"
    assert cell.mix == {"kind": "closed", "clients": 2, "prompt_tokens": 64}
    assert cell.spec["engine"]["bucket"] == 64
    assert [m["name"] for m in cell.per_layer] == ["waves.count"]
    assert {m["name"] for m in cell.end_to_end} == {"prefill_tok_s", "peak_gib", "setup_s"}
    reader = layout.metric(cell.per_layer[0])
    assert reader.read(type("R", (), {"waves": [1, 2]})()) == 2
    assert layout.module("traffic", "closed").drive


def test_a_reader_that_disagrees_with_its_entry_is_refused(smoke_root):
    layout = Layout(smoke_root)
    entry = dict(next(m for m in layout.manifest()["per_layer"]
                      if m["name"] == "mfu.tput"), unit="share")
    with pytest.raises(ValueError, match="unit"):
        layout.metric(entry)


def test_unknown_names_are_refused(smoke_root):
    layout = Layout(smoke_root)
    with pytest.raises(KeyError):
        layout.cell("no-such.cell")
    with pytest.raises(ValueError):
        layout.module("metrics", "../run")
