"""Merged Chrome/Perfetto trace recorder (stdlib only; the port's own copy
of ``repro.obs.trace``).

One recorder, one file, three event families:

- scheduler task intervals (``task``/``mark``: pid = stage, tid =
  request),
- engine wave / per-tick stage spans (``span``: any pid/tid),
- counter tracks (``counter``: ``"ph": "C"`` events Perfetto renders as
  stacked area charts: KV occupancy and wire bytes per stage).

``absorb`` folds another recorder in under a pid prefix (one file for
several cells). Timestamps are SECONDS on the caller's clock (the
scheduler's virtual clock or ``time.perf_counter`` deltas); export
converts to the trace-event microsecond unit. ``export`` writes atomically
(``_io.atomic_write_text``) so an interrupted run never leaves a truncated
JSON artifact. ``sched.trace`` re-exports this module's names.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Mapping, Optional

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


@dataclass(frozen=True)
class SpanEvent:
    name: str
    pid: Any              # process row (stage index or a string label)
    tid: Any              # thread row within the process
    start: float
    finish: float
    cat: str = "span"
    args: Optional[Dict[str, Any]] = None


@dataclass(frozen=True)
class CounterEvent:
    name: str             # counter track name (one track per (pid, name))
    pid: Any
    time: float
    values: Dict[str, float] = field(default_factory=dict)


class TraceRecorder:
    """Accumulates scheduler/engine/telemetry events; no-op when disabled."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.tasks: List[TaskEvent] = []
        self.marks: List[MarkEvent] = []
        self.spans: List[SpanEvent] = []
        self.counters: List[CounterEvent] = []
        self._pid_names: Dict[Any, str] = {}

    def task(self, rid: int, chunk: int, stage: int,
             start: float, finish: float) -> None:
        if self.enabled:
            self.tasks.append(TaskEvent(rid, chunk, stage, start, finish))

    def mark(self, rid: int, kind: str, time: float) -> None:
        if self.enabled:
            self.marks.append(MarkEvent(rid, kind, time))

    def span(self, name: str, *, pid: Any, tid: Any, start: float,
             finish: float, cat: str = "span",
             args: Optional[Dict[str, Any]] = None) -> None:
        """Record a complete-duration ("ph": "X") interval."""
        if self.enabled:
            self.spans.append(SpanEvent(name, pid, tid, start, finish,
                                        cat, args))

    def counter(self, name: str, *, pid: Any, time: float,
                values: Mapping[str, float]) -> None:
        """Record one sample on a counter track ("ph": "C")."""
        if self.enabled:
            self.counters.append(CounterEvent(name, pid, time,
                                              dict(values)))

    def process_name(self, pid: Any, name: str) -> None:
        """Label a process row (overrides the default ``stage {pid}``)."""
        if self.enabled:
            self._pid_names[pid] = name

    # -------------------------------------------------------------- merging
    def absorb(self, other: "TraceRecorder", *, pid_prefix: str = "") -> None:
        """Fold another recorder's events into this one under a per-source
        process namespace — a multi-cell timeline (the reference's ``repro.fleet``):
        ONE file where every cell keeps its own process rows
        (``cell0/stage 3``, ``cell1/engine``, ...). All of ``other``'s pids
        (task stages, span/counter pids, registered process names) are
        re-keyed to ``f"{pid_prefix}{pid}"``; task intervals become chunk
        spans (tid = request) and lifecycle marks become zero-duration
        request instants, so absorbed cells never collide with this
        recorder's own integer stage pids. With an empty prefix events copy
        through verbatim."""
        if not self.enabled:
            return

        def _pid(p: Any) -> Any:
            if not pid_prefix:
                return p
            base = f"stage {p}" if isinstance(p, int) else str(p)
            return f"{pid_prefix}{base}"

        if not pid_prefix:
            self.tasks.extend(other.tasks)
            self.marks.extend(other.marks)
        else:
            for t in other.tasks:
                self.span(f"r{t.rid}/c{t.chunk}", pid=_pid(t.stage),
                          tid=t.rid, start=t.start, finish=t.finish,
                          cat="chunk", args={"rid": t.rid, "chunk": t.chunk,
                                             "stage": t.stage})
            for m in other.marks:
                self.span(f"{m.kind} r{m.rid}", pid=f"{pid_prefix}requests",
                          tid=m.rid, start=m.time, finish=m.time,
                          cat="request")
        for s in other.spans:
            self.spans.append(SpanEvent(s.name, _pid(s.pid), s.tid, s.start,
                                        s.finish, s.cat, s.args))
        for c in other.counters:
            self.counters.append(CounterEvent(c.name, _pid(c.pid), c.time,
                                              dict(c.values)))
        for p, name in other._pid_names.items():
            self._pid_names[_pid(p)] = (f"{pid_prefix}{name}" if pid_prefix
                                        else name)

    # ------------------------------------------------------------- export
    def events(self) -> Dict[str, List[Dict[str, Any]]]:
        """Raw event dicts for offline analysis."""
        return {"tasks": [asdict(t) for t in self.tasks],
                "marks": [asdict(m) for m in self.marks],
                "spans": [asdict(s) for s in self.spans],
                "counters": [asdict(c) for c in self.counters]}

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
        for s in self.spans:
            rec = {
                "name": s.name,
                "cat": s.cat,
                "ph": "X",
                "ts": s.start * 1e6,
                "dur": (s.finish - s.start) * 1e6,
                "pid": s.pid,
                "tid": s.tid,
            }
            if s.args:
                rec["args"] = s.args
            ev.append(rec)
        for c in self.counters:
            ev.append({
                "name": c.name,
                "cat": "counter",
                "ph": "C",
                "ts": c.time * 1e6,
                "pid": c.pid,
                "tid": 0,
                "args": c.values,
            })
        pids = ({t.stage for t in self.tasks} | {s.pid for s in self.spans}
                | {c.pid for c in self.counters} | set(self._pid_names))
        for p in sorted(pids, key=str):
            name = self._pid_names.get(
                p, f"stage {p}" if isinstance(p, int) else str(p))
            ev.append({"name": "process_name", "ph": "M", "pid": p,
                       "args": {"name": name}})
        return {"traceEvents": ev, "displayTimeUnit": "ms"}

    def export(self, path: str) -> str:
        """Atomically write the Chrome trace JSON to ``path``."""
        return atomic_write_text(path, json.dumps(self.chrome_trace()))
