"""Slowest tick over the mean tick of the traced waves: each tick's span
from the program's CUDA events at the end of every tick
(obs/profile.TickSpanCollector, armed by TorchExecutor.collect_measured).
The uniform partition's imbalance between ticks shows here."""
import numpy as np

LAYER = "pipeline tick loop: core/pipeline.py prefill_pipeline via TorchExecutor.run"
UNIT = "ratio"
SOURCE = "program_span"
MOVES = "prefill_tok_s"


def read(run):
    ticks = [np.asarray(w["measured"]).max(axis=0) for w in run.waves
             if w.get("measured") is not None]
    if not ticks:
        return None
    t = np.concatenate(ticks)
    return float(t.max() / t.mean()) if t.mean() > 0 else None
