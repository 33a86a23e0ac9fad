"""The scheduler's trace recorder; it lives in ``obs.trace`` (mirrors
``repro.sched.trace``)."""
from repro_torch.obs.trace import (  # noqa: F401
    CounterEvent,
    MarkEvent,
    SpanEvent,
    TaskEvent,
    TraceRecorder,
)

__all__ = ["CounterEvent", "MarkEvent", "SpanEvent", "TaskEvent",
           "TraceRecorder"]
