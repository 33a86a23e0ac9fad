"""Median time to first token over every request due in the window: from
its due time to its logits on the host (host clock). The queue left when
the last request is due is drained and counted."""
import numpy as np

UNIT = "s"
SOURCE = "host_clock"


def read(run):
    t = [s.done - s.due for s in run.served]
    return float(np.percentile(t, 50)) if t else None
