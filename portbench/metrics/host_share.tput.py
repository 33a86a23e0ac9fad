"""Share of the window in which no wave ran: the window's wall time less
the waves' own spans (TorchExecutor's ``dur``, host clock around work
that ends in a synchronize), over the window. Engine bookkeeping, request
making, batching and the logits' copy count here."""
LAYER = "serving loop: runtime/engine.py PrefillEngine.step"
UNIT = "%"
SOURCE = "program_span"
MOVES = "prefill_tok_s"


def read(run):
    if not run.waves:
        return None
    return 100.0 * (1.0 - sum(w["dur"] for w in run.waves) / run.window_s)
