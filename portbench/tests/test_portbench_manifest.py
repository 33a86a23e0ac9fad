"""BENCHMARK.json against the benchmark's contract: names, units, bounds,
the files each entry points to, and which cell reports which metric."""
import json
import re

import pytest

from conftest import ROOT
from portbench.harness.layout import Layout, NAME, UNIT, reports

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
LINE = re.compile(r"^[^\n\t]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    assert 1 <= len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert LINE.match(word) and not word.startswith("/") and ".." not in word
    assert (ROOT / BENCH["command"][1]).resolve().is_relative_to(ROOT / BENCH["paths"][0])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_a_full_check_of_24_cells_fits():
    """2 + 14 x cells runs of run_seconds + 60 s, 2 x 90 s a cell to
    compile, 1200 s spare: within 43200 s at the most cells a later PR may
    add."""
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(group):
    names = [x["name"] for x in BENCH[group]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n


def test_metric_fields():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in SOURCES and LINE.match(m["layer"])
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25


def test_configs_and_cells_point_to_files():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(BENCH["paths"][0] + "/") and (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and LINE.match(c["why"]) and LINE.match(c["source"])
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"]
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and LINE.match(w["why"]) and NAME.match(w["traffic"])
        assert (ROOT / "portbench" / "workloads" / f"{w['name']}.json").is_file()
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").is_file()


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_reports_what_it_must(cell):
    c = Layout(ROOT).cell(cell)
    e2e = [m["name"] for m in c.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e, (m["name"], m["moves"])
    for m in BENCH["per_layer"]:
        for w in m.get("workloads", []):
            other = Layout(ROOT).cell(w)
            assert m["moves"] in [x["name"] for x in other.end_to_end]


@pytest.mark.parametrize("entry", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_every_metric_has_a_reader_that_matches_its_entry(entry):
    mod = Layout(ROOT).metric(entry)
    assert callable(mod.read)


def test_reports_rule():
    assert reports({"name": "x", "workloads": ["a"]}, "a", [])
    assert not reports({"name": "x", "workloads": ["a"]}, "b", [])
    assert reports({"name": "x", "moves": "m"}, "b", ["m"])
    assert not reports({"name": "x", "moves": "m"}, "b", ["n"])
