"""Chrome/Perfetto trace recorder of the chunk-level scheduler (stdlib-only;
the port's own copy of the scheduler-facing part of ``repro.obs.trace``).

Two event families: chunk task intervals (``task`` — pid = stage, tid =
request) and request lifecycle marks (``mark``: arrival, admit, finish,
reject). The reference's engine spans and counter tracks come with the
device half of observability, which is not ported yet.

Timestamps are SECONDS on the caller's clock (the scheduler's virtual
clock); export converts to the trace-event microsecond unit. ``export``
writes atomically (``_io.atomic_write_text``) so an interrupted run never
leaves a truncated JSON artifact. ``sched.trace`` re-exports these names.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Dict, List

from repro_torch.obs._io import atomic_write_text


@dataclass(frozen=True)
class TaskEvent:
    rid: int
    chunk: int
    stage: int
    start: float          # seconds (scheduler clock)
    finish: float


@dataclass(frozen=True)
class MarkEvent:
    rid: int
    kind: str             # arrival | admit | finish | reject
    time: float


class TraceRecorder:
    """Accumulates scheduler events; no-op when disabled."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.tasks: List[TaskEvent] = []
        self.marks: List[MarkEvent] = []

    def task(self, rid: int, chunk: int, stage: int,
             start: float, finish: float) -> None:
        if self.enabled:
            self.tasks.append(TaskEvent(rid, chunk, stage, start, finish))

    def mark(self, rid: int, kind: str, time: float) -> None:
        if self.enabled:
            self.marks.append(MarkEvent(rid, kind, time))

    def chrome_trace(self) -> Dict[str, Any]:
        """Chrome trace-event JSON: pid = stage, tid = request, ts in us."""
        ev: List[Dict[str, Any]] = []
        for t in self.tasks:
            ev.append({
                "name": f"r{t.rid}/c{t.chunk}",
                "cat": "chunk",
                "ph": "X",
                "ts": t.start * 1e6,
                "dur": (t.finish - t.start) * 1e6,
                "pid": t.stage,
                "tid": t.rid,
                "args": {"rid": t.rid, "chunk": t.chunk, "stage": t.stage},
            })
        for m in self.marks:
            ev.append({
                "name": m.kind,
                "cat": "request",
                "ph": "i",
                "s": "g",
                "ts": m.time * 1e6,
                "pid": 0,
                "tid": m.rid,
            })
        for p in sorted({t.stage for t in self.tasks}, key=str):
            ev.append({"name": "process_name", "ph": "M", "pid": p,
                       "args": {"name": f"stage {p}"}})
        return {"traceEvents": ev, "displayTimeUnit": "ms"}

    def export(self, path: str) -> str:
        """Atomically write the Chrome trace JSON to ``path``."""
        return atomic_write_text(path, json.dumps(self.chrome_trace()))
