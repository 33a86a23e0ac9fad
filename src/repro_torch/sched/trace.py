"""The scheduler's trace recorder; it lives in ``obs.trace`` (mirrors
``repro.sched.trace``)."""
from repro_torch.obs.trace import MarkEvent, TaskEvent, TraceRecorder  # noqa: F401

__all__ = ["MarkEvent", "TaskEvent", "TraceRecorder"]
