"""90th percentile of the time to first token over every request due in the
window (``ttft_p50_s``'s set): the highest percentile with ten requests
beyond it at about a hundred requests a run."""
import numpy as np

UNIT = "s"
SOURCE = "host_clock"


def read(run):
    t = [s.done - s.due for s in run.served]
    return float(np.percentile(t, 90)) if t else None
