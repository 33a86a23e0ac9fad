#!/usr/bin/env python3
"""Times the port's host-sensitive paths on several source trees in one
run on one CUDA card, so that a change in them can be told from the
host's noise: the long-context bf16 decode step of qwen3-8b and zamba2-7b
(``chip_smoke.decode_long``: median step with K5 and with its plain
version) and one profiled bf16 qship/cuda prefill wave of qwen3-8b,
mamba2-130m, granite-3-2b and qwen2-moe-a2.7b (``chip_smoke.wave_split``:
untraced wave time, busy time, the device's idle share).

    python3 tools/tree_compare.py DIR [DIR ...] [--out FILE]

Each DIR holds a ``src/repro_torch`` (a checkout, or a ``git archive`` of a
commit unpacked under the ignored ``build/``). The measuring code is this
checkout's ``chip_smoke.py`` in every pass; only ``repro_torch`` comes from
DIR. Every tree's kernels are built first (untimed). Then each tree runs in
a process of its own, in the order given and again in reverse (A B B A for
two trees), and the script prints the card's name and power limit, a table
of each tree's passes, and one JSON line of every pass's numbers (also
written to FILE).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DECODE_ARCHS = ("qwen3-8b", "zamba2-7b")
WAVE_ARCHS = ("qwen3-8b", "mamba2-130m", "granite-3-2b", "qwen2-moe-a2.7b")


def one_pass(tree: Path, build_only: bool) -> dict:
    """In this process: ``tree``'s port under this checkout's chip_smoke."""
    sys.path[:0] = [str(tree / "src"), str(ROOT)]
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    out: dict = {"tree": str(tree), "build_dir": str(build.build_dir())}
    if build_only:
        return out
    results: dict = {}
    for arch in DECODE_ARCHS:
        try:
            failures = cs.decode_long(arch, results)
            row = results["decode_attention"]["long_context"][arch]
            out[f"decode {arch}"] = dict(step_ms=row["step_ms"],
                                         plain_step_ms=row["plain_step_ms"],
                                         failures=failures)
        except Exception as e:            # an older tree may lack a surface
            out[f"decode {arch}"] = {"error": repr(e)}
        torch.cuda.empty_cache()
    for arch in WAVE_ARCHS:
        try:
            w = cs.wave_split(arch)
            out[f"wave {arch}"] = dict(wave_s=w["wave_s"], busy_s=w["busy_s"],
                                       idle_share=w["idle_share"], card=w["card"])
        except Exception as e:
            out[f"wave {arch}"] = {"error": repr(e)}
        torch.cuda.empty_cache()
    return out


def child(tree: Path, build_only: bool) -> dict:
    """One pass in a fresh process; its JSON is the last line it prints."""
    cmd = [sys.executable, __file__, "--pass", str(tree)] + (["--build"] if build_only else [])
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, text=True)
    print(proc.stdout, end="", flush=True)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        raise SystemExit(f"tree_compare: the pass on {tree} failed (rc {proc.returncode})")
    return json.loads(lines[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", type=Path)
    ap.add_argument("--pass", dest="one", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--build", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--out", type=Path, default=None, help="also write the JSON here")
    args = ap.parse_args()
    if args.one is not None:
        print(json.dumps(one_pass(args.one.resolve(), args.build)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available() or not args.trees:
        print("tree_compare: needs one CUDA card and at least one tree", file=sys.stderr)
        return 2
    trees = [t.resolve() for t in args.trees]
    for t in trees:
        if not (t / "src" / "repro_torch").is_dir():
            print(f"tree_compare: {t} holds no src/repro_torch", file=sys.stderr)
            return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    for t in trees:
        child(t, build_only=True)
    passes = [child(t, build_only=False) for t in trees + trees[::-1]]
    print(card)
    keys = [f"decode {a}" for a in DECODE_ARCHS] + [f"wave {a}" for a in WAVE_ARCHS]
    for t in trees:
        mine = [p for p in passes if p["tree"] == str(t)]
        print(f"== {t}")
        for k in keys:
            rows = [p[k] for p in mine]
            if any("error" in r for r in rows):
                print(f"  {k}: {[r.get('error') for r in rows]}")
            elif k.startswith("decode"):
                print(f"  {k}: step ms {[round(r['step_ms'], 3) for r in rows]} "
                      f"(median {statistics.median(r['step_ms'] for r in rows):.3f}), "
                      f"plain {[round(r['plain_step_ms'], 3) for r in rows]}")
            else:
                print(f"  {k}: wave s {[round(r['wave_s'], 4) for r in rows]}, idle share "
                      f"{[round(r['idle_share'], 4) for r in rows]}")
    doc = json.dumps({"card": card, "passes": passes})
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(doc + "\n")
    print(doc)
    return 0


if __name__ == "__main__":
    sys.exit(main())
