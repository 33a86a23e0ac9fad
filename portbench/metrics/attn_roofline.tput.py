"""The least time of the causal attention the completed prompts need
(work/needed.py: q, k, v read once, the output written once, the
published bf16 and HBM peaks) over the device time of the kernels K1-K3 in
the traced window, matched by name. Bubble rows, padding layers and the
kernels' own speed all lower it."""
from portbench.harness.trace import device_seconds
from portbench.work import needed as W

LAYER = "kernels K1-K3: csrc/chunk_attn.cu"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "prefill_tok_s"
# K1 (ChunkWalk / chunk_attn), K2 (StackWalk / pool_attn), K3 (paged_attn)
PATTERNS = ("chunkwalk", "chunk_attn", "stackwalk", "pool_attn", "paged_attn")


def read(run):
    dev = device_seconds(run.spans, PATTERNS) if run.spans else 0.0
    if dev <= 0 or not run.served:
        return None
    return 100.0 * sum(W.attention_least_seconds(run.conf, s.seq) for s in run.served) / dev
