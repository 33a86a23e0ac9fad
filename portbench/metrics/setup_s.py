"""Process start to the window's start (host clock): imports, loading the
kernels' libraries (building them in a fresh checkout), the weights made
from the seed and staged, the warm-up waves."""
UNIT = "s"
SOURCE = "host_clock"


def read(run):
    return run.setup_s
