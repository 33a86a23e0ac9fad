"""Share of the traced window in which no operation ran on the device:
1 - the union of the device activities (the frozen busy_window) over the
window's wall time."""
LAYER = "device: one H100"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "prefill_tok_s"


def read(run):
    if not run.spans or run.busy_s is None:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
