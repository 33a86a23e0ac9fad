"""Peak device memory over the window: torch.cuda.max_memory_allocated(),
its count reset at the window's start (the caching allocator's count of the
device's memory, read by the benchmark). It bounds the longest prompt and
the batch one card holds: MBKR's claim."""
UNIT = "GiB"
SOURCE = "device_trace"


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
