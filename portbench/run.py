"""Runs one cell of the benchmark once, from the root of a checkout:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result (one JSON object); the
numbers the check compared, each beside its limit, are the last lines of
standard error. Exits non-zero, printing no result, without a CUDA card,
without the program (``src/repro_torch``), or when a module of JAX or of
the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the program's build and kernel caches stay inside the checkout, at fixed paths
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ.setdefault(var, str(ROOT / "build" / "portbench" / sub))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from portbench.harness.layout import Layout
    layout = Layout(ROOT)
    chips = next((w["chips"] for w in layout.manifest()["workloads"]
                  if w["name"] == args.workload), None)
    if chips is None:
        print(f"portbench: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("portbench: the program (src/repro_torch) is not in this checkout",
              file=sys.stderr)
        return 2
    from portbench.harness import trace as TR
    from portbench.harness.cell import run_cell
    print(f"card: {TR.card_line()}", file=sys.stderr, flush=True)
    result = run_cell(layout, args.workload, args.seed, args.seconds, bool(args.trace),
                      device=torch.device("cuda", 0), t_start=T_START)
    if result is None:
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
