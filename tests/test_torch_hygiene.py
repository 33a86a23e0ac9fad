"""Package rules of the port: it imports neither jax nor the JAX package,
it runs on the card unless asked for the CPU, and nothing builds at import
time."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + sorted((ROOT / "tools").glob("*.py")))
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path}: imports {bad}"


def test_device_resolution_never_falls_back(monkeypatch):
    from repro_torch import device
    from repro_torch.configs import RunConfig, get_smoke_config
    from repro_torch.runtime.engine import TorchExecutor
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        device.resolve(None)
    with pytest.raises(RuntimeError):
        device.resolve("cuda")
    assert device.resolve("cpu").type == "cpu"
    with pytest.raises(RuntimeError):
        TorchExecutor(get_smoke_config("qwen3-8b"), {}, RunConfig())


def test_prefill_pipeline_defaults_to_the_card(monkeypatch):
    from repro_torch.configs import RunConfig, get_smoke_config
    from repro_torch.core import pipeline as pp
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("qwen3-8b")
    plan = pp.build_plan(cfg, 2, 32, RunConfig(num_chunks=2, num_stages=2))
    with pytest.raises(RuntimeError):
        pp.prefill_pipeline(cfg, {}, [[0] * 32], plan)


def test_kernel_modules_import_without_nvcc():
    """Importing the wrappers (and the whole package) needs no nvcc and
    builds nothing: the build happens at the first launch."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), PATH="/nonexistent")
    code = ("import repro_torch.kernels.ops as ops, repro_torch.core.pipeline, "
            "repro_torch.launch.serve, repro_torch.kernels.build as b, "
            "repro_torch.models.ssm, repro_torch.models.hybrid, "
            "repro_torch.models.api, repro_torch.bridge, repro_torch.core.gpipe, "
            "repro_torch.runtime.engine, repro_torch.sched, repro_torch.sim, "
            "repro_torch.kvstore.prefix, repro_torch.kvstore.tiers, "
            "repro_torch.obs.telemetry, repro_torch.roofline.op_graph, "
            "repro_torch.launch.cells, repro_torch.launch.dryrun; "
            "assert callable(ops.ssd) and 'ssd' in ops.LAUNCHES; "
            "assert callable(ops.decode_attention) and 'decode_attention' in ops.LAUNCHES; "
            "assert not b._LIBS and all(v == 0 for v in ops.LAUNCHES.values()); "
            "print('OK')")
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0 and "OK" in r.stdout, r.stdout + r.stderr


def test_serve_cli_refuses_without_card():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--smoke"],
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "RuntimeError" in r.stderr


def test_chip_smoke_refuses_without_card(tmp_path):
    """Without a card, and alone in a directory, chip_smoke.py exits
    non-zero and prints no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", lone):
        r = subprocess.run([sys.executable, str(script)], env=env, capture_output=True,
                           text=True, timeout=120, cwd=script.parent)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout


def test_ctypes_signatures_match_the_c_entry_points():
    """Each ``extern "C"`` entry point in ``csrc/*.cu`` takes as many
    arguments, of the same kinds, as the wrapper's ctypes signature
    declares (ctypes cannot check this; a wrong count fails only on the
    card)."""
    import ctypes
    import re
    from repro_torch.kernels import ops
    kinds = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
             "long long": ctypes.c_longlong, "float": ctypes.c_float}
    found = {}
    for src in (ROOT / "src" / "repro_torch" / "csrc").glob("*.cu"):
        text = src.read_text()
        c_part = text[text.index('extern "C" {'):]
        for name, params in re.findall(r"int (\w+_launch)\(([^)]*)\)", c_part):
            args = []
            for p in params.split(","):
                p = " ".join(p.replace("const", "").split())
                base = p.rsplit(" ", 1)[0].replace(" *", "*")
                args.append(kinds["void*" if "*" in p else base])
            found[name] = args
    assert set(found) == set(ops._SIGNATURES)
    for name, args in found.items():
        assert ops._SIGNATURES[name] == args, name
