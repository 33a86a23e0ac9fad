"""The knee of an open-loop cell, found once on the card: the highest
arrival rate whose backlog does not grow over the window.

    python3 portbench/tools/sweep.py --workload <open cell> --seed <n> \
        --seconds <window> --rates 1.5 2.0 2.5 ... [--schedule-seed <n>]

One program (weights from ``--seed``, the cell's warm-up), then for each
rate a window of the cell's own mix at that rate, on a fresh token stream.
One JSON object a rate on standard output: requests, TTFT median and 90th
percentile, the mean TTFT of the first and of the last third of the
requests (a backlog that grows makes the last third wait longer), the
drain (last logits after the last due time), the waves and their mean
batch.
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
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--schedule-seed", type=int, default=None,
                    help="arrival schedule in place of the mix's schedule_seed")
    ap.add_argument("--device", default="cuda", help="cpu: a rehearsal at a small size")
    ap.add_argument("--root", default=str(ROOT), help="the checkout whose layout to read")
    args = ap.parse_args()
    import numpy as np
    import torch
    from portbench.harness.cell import build_program, log
    from portbench.harness.layout import Layout
    from portbench.harness.serve import Server
    from portbench.harness.weights import sub_seed
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("sweep: no CUDA card", file=sys.stderr)
        return 2
    layout = Layout(Path(args.root))
    cell = layout.cell(args.workload)
    kind = layout.module("traffic", cell.mix["kind"])
    engine, ex, cfg = build_program(cell, args.seed, dev)
    kind.warm(Server(engine, cfg.vocab_size, sub_seed(args.seed, "warmup")), cell.mix,
              cell.spec["engine"]["max_batch"])
    for i, rate in enumerate(args.rates):
        server = Server(engine, cfg.vocab_size, sub_seed(args.seed, f"sweep{i}"))
        n0 = len(ex.waves)
        server.open_window()
        mix = dict(cell.mix, rate=rate)
        if args.schedule_seed is not None:
            mix["schedule_seed"] = args.schedule_seed
        sent = kind.drive(server, mix, args.seconds)
        done = sorted(server.completed(), key=lambda s: s.due)
        t = np.array([s.done - s.due for s in done])
        third = max(1, len(t) // 3)
        waves = ex.waves[n0:]
        out = {"rate": rate, "schedule_seed": mix["schedule_seed"], "sent": sent,
               "completed": len(done),
               "ttft_p50_s": float(np.percentile(t, 50)), "ttft_p90_s": float(np.percentile(t, 90)),
               "ttft_first_third_s": float(t[:third].mean()),
               "ttft_last_third_s": float(t[-third:].mean()),
               "drain_s": float(max(s.done for s in done) - max(s.due for s in done)),
               "waves": len(waves), "mean_batch": len(done) / max(len(waves), 1),
               "wave_s_by_batch": {str(b): float(np.mean([w["dur"] for w in waves
                                                         if len(w["rids"]) == b]))
                                   for b in sorted({len(w["rids"]) for w in waves})}}
        print(json.dumps(out), flush=True)
        log(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
