"""The FLOPs the completed prompts need (work/needed.py) over the bf16 peak
times the waves' own time (the sum of TorchExecutor's ``dur``): the
step's share of the peak while it runs, without the waits for arrivals."""
from portbench.work import needed as W

LAYER = "model step: one wave, whole"
UNIT = "%"
SOURCE = "program_span"
MOVES = "ttft_p90_s"


def read(run):
    busy = sum(w["dur"] for w in run.waves)
    if not run.served or busy <= 0:
        return None
    flops = sum(W.request_flops(run.conf, s.seq) for s in run.served)
    return 100.0 * flops / (W.HW_H100["peak_flops"] * busy)
