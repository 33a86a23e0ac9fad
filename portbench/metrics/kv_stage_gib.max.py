"""The largest KV a stage holds at a tick, over the traced waves: the
program's per-(stage, tick) kv_bytes telemetry (obs/telemetry.py, stored
bytes of the pool's live chunks), in GiB."""
import numpy as np

LAYER = "KV placement: core/mbkr.py, core/remote.py, kvstore/pages.py"
UNIT = "GiB"
SOURCE = "program_counter"
MOVES = "peak_gib"


def read(run):
    kv = [np.asarray(w["telemetry"]["kv_bytes"]).max() for w in run.waves
          if w.get("telemetry") is not None]
    return float(max(kv)) / 2 ** 30 if kv else None
