"""Fixtures of the benchmark's tests. Run them from the repo root:

    PYTHONPATH=src python -m pytest -q portbench/tests

Tests marked ``card`` need a CUDA card; the ``card`` fixture decides that
when the test runs, and skips it here.
"""
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

# the configuration cut to a size the CPU runs in seconds (widths included:
# these layouts only rehearse the harness, they are never measured)
SMOKE_CONF = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                  intermediate_size=128, vocab_size=256, num_hidden_layers=3)
SMOKE_BUCKET = {"long32k": 256, "batch4k": 128, "open4k": 128}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skipped without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


def make_smoke_root(dst: Path) -> Path:
    """A copy of BENCHMARK.json and portbench/ with the configuration and
    the cells cut to CPU size (the open cell at 4 requests a second)."""
    dst.mkdir(parents=True, exist_ok=True)
    shutil.copytree(ROOT / "portbench", dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        f = dst / c["file"]
        conf = json.loads(f.read_text())
        conf.update(SMOKE_CONF)
        f.write_text(json.dumps(conf))
    for w in bench["workloads"]:
        cf = dst / "portbench" / "workloads" / f"{w['name']}.json"
        spec = json.loads(cf.read_text())
        bucket = SMOKE_BUCKET[w["traffic"]]
        spec["engine"]["bucket"] = bucket
        if "rate" in spec.get("traffic", {}):
            spec["traffic"]["rate"] = 4.0
        cf.write_text(json.dumps(spec))
        mf = dst / "portbench" / "traffic" / f"{w['traffic']}.json"
        mix = json.loads(mf.read_text())
        mix["prompt_tokens"] = bucket
        mf.write_text(json.dumps(mix))
    return dst


@pytest.fixture
def smoke_root(tmp_path):
    return make_smoke_root(tmp_path / "checkout")


@pytest.fixture(autouse=True)
def few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
