"""Prompt tokens of the requests the window completed, over the window's
wall time (host clock; the window ends with the last wave's synchronize)."""
UNIT = "tokens/s"
SOURCE = "host_clock"


def read(run):
    if not run.served:
        return None
    return sum(s.seq for s in run.served) / run.window_s
