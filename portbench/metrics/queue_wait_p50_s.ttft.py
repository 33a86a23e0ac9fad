"""Median queue wait: from a request's due time to the start of the
``step()`` that ran it (host clock)."""
import numpy as np

LAYER = "serving loop: runtime/engine.py PrefillEngine.step"
UNIT = "s"
SOURCE = "host_clock"
MOVES = "ttft_p90_s"


def read(run):
    t = [s.start - s.due for s in run.served]
    return float(np.percentile(t, 50)) if t else None
