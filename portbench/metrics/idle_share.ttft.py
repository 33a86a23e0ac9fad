"""Share of the time inside the harness's ``step()`` ranges (the waves, as
the host drives them) in which no operation ran on the device: the idle
that the waits for arrivals do not explain."""
from portbench.harness.trace import busy_inside

LAYER = "device: one H100"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "ttft_p90_s"


def read(run):
    steps = [r for r in run.ranges or () if r[2] == "portbench.step"]
    if not run.spans or not steps:
        return None
    busy, total = busy_inside(run.spans, steps)
    return 100.0 * (1.0 - busy / total) if total > 0 else None
