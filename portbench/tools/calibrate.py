"""The readings a cell's check limits are set from, on the card, in one
process (set-up is long):

    python3 portbench/tools/calibrate.py --workload <cell> --seeds 1 2 ... \
        --control-seeds 1 2 3 --seconds <short window>

For every seed the program's numbers, the lower end of each limit; for each
control seed also the control's, the upper end (``harness/calib.py``). One
JSON object a seed on standard output.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--device", default="cuda", help="cpu: a rehearsal at a small size")
    ap.add_argument("--root", default=str(ROOT), help="the checkout whose layout to read")
    args = ap.parse_args()
    import torch
    from portbench.harness.calib import readings
    from portbench.harness.cell import log
    from portbench.harness.layout import Layout
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    layout = Layout(Path(args.root))
    for seed in args.seeds:
        out = readings(layout, args.workload, seed, args.seconds, dev,
                       control=seed in args.control_seeds)
        print(json.dumps(out), flush=True)
        log(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
