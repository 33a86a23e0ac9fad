"""The FLOPs the completed prompts need (work/needed.py: the maths, not
what the program computes) over the bf16 peak times the window's wall
time."""
from portbench.work import needed as W

LAYER = "model step: one wave, whole"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "prefill_tok_s"


def read(run):
    if not run.served:
        return None
    flops = sum(W.request_flops(run.conf, s.seq) for s in run.served)
    return 100.0 * flops / (W.HW_H100["peak_flops"] * run.window_s)
