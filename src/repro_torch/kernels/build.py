"""Build and load the CUDA kernels: ``nvcc`` by hand into shared libraries
with a plain C interface, loaded with ``ctypes``.

Each ``src/repro_torch/csrc/<name>.cu`` becomes ``lib<name>.so`` under
``build/repro_torch/<hash of the sources>/``; a source listed in ``SPLITS``
is compiled once per part ``k`` (``-DKV_COMBO=k``) into ``lib<name>.<k>.so``,
so that its template instantiations compile in parallel. Nothing builds at
import time: the first launch (or ``build_all()``) compiles, with one
``nvcc`` per library, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

# chunk_attn.cu: one part per (q dtype, kv dtype) combination
SPLITS = {"chunk_attn": 6}

_LIBS: Dict[str, ctypes.CDLL] = {}
LOGS: Dict[str, str] = {}   # per-source nvcc output (with ptxas -v when asked)
SECONDS: Dict[str, float] = {}   # per-library nvcc wall time of the last build


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _targets():
    """(library name, source, extra nvcc flags) for every library."""
    for src in sorted(CSRC.glob("*.cu")):
        parts = SPLITS.get(src.stem)
        if parts is None:
            yield src.stem, src, []
        else:
            for k in range(parts):
                yield f"{src.stem}.{k}", src, [f"-DKV_COMBO={k}"]


def build_all(verbose: bool = False) -> Dict[str, Path]:
    """Compile every library not built yet (parallel nvcc processes);
    returns {name: library path}. ``verbose`` adds ``-Xptxas -v`` (registers,
    shared memory, spills per kernel) to ``LOGS``."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs, procs = {}, []
    t0 = time.perf_counter()
    for name, src, extra in _targets():
        lib = out_dir / f"lib{name}.so"
        libs[name] = lib
        if lib.exists() and not verbose:
            continue
        tmp = out_dir / f".lib{name}.{os.getpid()}.so"
        cmd = [_nvcc(), *NVCC_FLAGS, *extra, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(src)]
        procs.append((name, tmp, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))

    def wait(entry):
        name, _, _, proc = entry
        LOGS[name] = proc.communicate()[0]
        SECONDS[name] = time.perf_counter() - t0

    if procs:
        with ThreadPoolExecutor(len(procs)) as pool:
            list(pool.map(wait, procs))
    failed: List[Tuple[str, str]] = []
    for name, tmp, lib, proc in procs:
        log = LOGS[name]
        if proc.returncode != 0:
            failed.append((name, log))
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"--- {n}\n{log}" for n, log in failed))
    return libs


def lib(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (``<source stem>`` or ``<stem>.<part>``),
    built on first use."""
    if name not in _LIBS:
        path = build_all()[name]
        _LIBS[name] = ctypes.CDLL(str(path))
    return _LIBS[name]
