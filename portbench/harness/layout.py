"""Where the benchmark's parts live, found by the names in BENCHMARK.json.

    BENCHMARK.json                      the cells and metrics (repo root)
    portbench/configs/<config>.json     a configuration, as ``file`` names it
    portbench/traffic/<traffic>.json    a traffic mix: its ``kind`` and sizes
    portbench/traffic/<kind>.py         the loop that drives a kind of mix
    portbench/workloads/<cell>.json     a cell's engine sizes, run settings,
                                        overrides of its mix, and its check
    portbench/families/<family>.py      a family on the program's side
    portbench/reference/<family>.py     a family's plain reference
    portbench/metrics/<metric>.py       one metric's reader

A later change adds a cell, a configuration, a mix or a metric by adding
files and entries; nothing here names one of them.
"""
from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@dataclass
class Cell:
    name: str
    entry: Dict[str, Any]           # its BENCHMARK.json workload entry
    conf: Dict[str, Any]            # the configuration file, plus name / source
    mix: Dict[str, Any]             # the traffic mix, with the cell's overrides
    spec: Dict[str, Any]            # the cell's own file
    end_to_end: List[Dict[str, Any]] = field(default_factory=list)
    per_layer: List[Dict[str, Any]] = field(default_factory=list)


def _load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def reports(metric: Dict[str, Any], cell: str, e2e_names: List[str]) -> bool:
    """Whether a cell reports ``metric``: its ``workloads`` list it, or it
    has none and the cell reports the end-to-end metric it moves (for an
    end-to-end metric without the key: every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


class Layout:
    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.bench = self.root / "portbench"
        self._mods: Dict[Path, ModuleType] = {}

    def manifest(self) -> Dict[str, Any]:
        return _load_json(self.root / "BENCHMARK.json")

    def module(self, kind: str, name: str) -> ModuleType:
        """``portbench/<kind>/<name>.py``, loaded from its path (metric names
        hold dots, so these are files, not package modules)."""
        if not NAME.match(name):
            raise ValueError(f"{kind} name {name!r}")
        path = self.bench / kind / f"{name}.py"
        if path not in self._mods:
            if not path.is_file():
                raise FileNotFoundError(f"no {kind} file {path}")
            spec = importlib.util.spec_from_file_location(
                f"portbench_{kind}_{re.sub(r'[^A-Za-z0-9_]', '_', name)}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._mods[path] = mod
        return self._mods[path]

    def cell(self, name: str) -> Cell:
        m = self.manifest()
        entry = next((w for w in m["workloads"] if w["name"] == name), None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                           f"{[w['name'] for w in m['workloads']]}")
        centry = next(c for c in m["configs"] if c["name"] == entry["config"])
        conf = dict(_load_json(self.root / centry["file"]))
        conf.update(name=centry["name"], source=centry["source"])
        spec = _load_json(self.bench / "workloads" / f"{name}.json")
        mix = dict(_load_json(self.bench / "traffic" / f"{entry['traffic']}.json"))
        mix.update(spec.get("traffic", {}))
        e2e = [x for x in m["end_to_end"] if reports(x, name, [])]
        names = [x["name"] for x in e2e]
        per = [x for x in m["per_layer"] if reports(x, name, names)]
        return Cell(name, entry, conf, mix, spec, e2e, per)

    def metric(self, entry: Dict[str, Any]) -> ModuleType:
        """A metric's reader, held to its BENCHMARK.json entry: the unit,
        source and, for a per-layer metric, layer and ``moves`` it declares
        must be the entry's."""
        mod = self.module("metrics", entry["name"])
        for key in ("unit", "source", "layer", "moves"):
            if key in entry and getattr(mod, key.upper(), None) != entry[key]:
                raise ValueError(f"metric {entry['name']}: {key} "
                                 f"{getattr(mod, key.upper(), None)!r} in its file, "
                                 f"{entry[key]!r} in BENCHMARK.json")
        return mod
