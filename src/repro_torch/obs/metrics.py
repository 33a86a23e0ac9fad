"""Serving metrics: counters/gauges/histograms + JSON-lines / Prometheus
textfile export (stdlib-only, atomic writes).

The registry is deliberately small — a name->metric dict with the three
Prometheus primitive kinds — because the serving loop is single-process and
single-threaded: no locks, no label cardinality explosions, just the values
an SLO dashboard needs. Two wire formats from one registry:

- ``export_jsonl``  one JSON object per line (``{"name", "kind", "value" |
  "buckets"/"sum"/"count", "help"}``) — trivially greppable/jq-able.
- ``export_prom``   the Prometheus textfile-collector format (``# HELP`` /
  ``# TYPE`` + samples, ``_bucket{le=...}``/``_sum``/``_count`` for
  histograms) — drop the file in a node-exporter textfile directory.

``export_engine_metrics`` maps a ``ContinuousEngine``/``PrefillEngine``
summary (``sched.metrics.SchedMetrics.summary``) onto the registry and picks
the format from the extension (``.prom`` -> Prometheus, else JSON-lines).
"""
from __future__ import annotations

import json
import math
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence

from repro_torch.obs._io import atomic_write_text

_PREFIX = "repro_"

# Default TTFT-style latency buckets (seconds), roughly log-spaced.
DEFAULT_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
                   120.0)


class Counter:
    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name, self.help, self.value = name, help, 0.0

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def sample(self) -> Dict[str, Any]:
        return {"name": self.name, "kind": self.kind, "value": self.value,
                "help": self.help}


class Gauge:
    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name, self.help, self.value = name, help, 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def sample(self) -> Dict[str, Any]:
        return {"name": self.name, "kind": self.kind, "value": self.value,
                "help": self.help}


class Histogram:
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.name, self.help = name, help
        self.buckets = tuple(sorted(buckets))
        self.counts = [0] * (len(self.buckets) + 1)   # +Inf tail
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.sum += value
        self.count += 1
        for i, b in enumerate(self.buckets):
            if value <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def cumulative(self) -> List[int]:
        out, acc = [], 0
        for c in self.counts:
            acc += c
            out.append(acc)
        return out

    def sample(self) -> Dict[str, Any]:
        return {"name": self.name, "kind": self.kind,
                "buckets": {("+Inf" if math.isinf(b) else repr(b)): c
                            for b, c in zip(self.buckets + (math.inf,),
                                            self.cumulative())},
                "sum": self.sum, "count": self.count, "help": self.help}


class MetricsRegistry:
    """Name-keyed metric store with idempotent getters and two exporters."""

    def __init__(self):
        self._metrics: Dict[str, Any] = {}

    def _get(self, cls, name: str, help: str, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, help, **kw)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as {m.kind}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def metrics(self) -> Iterable[Any]:
        return self._metrics.values()

    # ------------------------------------------------------------- export
    def to_jsonl(self) -> str:
        return "".join(json.dumps(m.sample()) + "\n" for m in self.metrics())

    def to_prom(self) -> str:
        lines: List[str] = []
        for m in self.metrics():
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            if isinstance(m, Histogram):
                for b, c in zip(m.buckets + (math.inf,), m.cumulative()):
                    le = "+Inf" if math.isinf(b) else repr(b)
                    lines.append(f'{m.name}_bucket{{le="{le}"}} {c}')
                lines.append(f"{m.name}_sum {m.sum}")
                lines.append(f"{m.name}_count {m.count}")
            else:
                lines.append(f"{m.name} {m.value}")
        return "\n".join(lines) + "\n"

    def export_jsonl(self, path: str) -> str:
        return atomic_write_text(path, self.to_jsonl())

    def export_prom(self, path: str) -> str:
        return atomic_write_text(path, self.to_prom())

    def export(self, path: str) -> str:
        """Format by extension: ``.prom`` -> textfile, else JSON-lines."""
        if path.endswith(".prom"):
            return self.export_prom(path)
        return self.export_jsonl(path)


# Engine-summary key -> (metric kind, help). Counters are monotone totals;
# everything else from the summary is a point-in-time gauge.
_SUMMARY_COUNTERS = {
    "completed": "requests completed",
    "rejected": "requests rejected at admission",
    "slo_total": "requests carrying an SLO",
    "slo_met": "requests that met their SLO",
    "lease_refusals": "distinct requests refused by the KV lease manager",
}


def export_engine_metrics(path: str, summary: Mapping[str, Any],
                          records: Optional[Sequence[Any]] = None,
                          extra: Optional[Mapping[str, float]] = None,
                          health=None) -> str:
    """Export an engine metrics summary (``engine.metrics()``) to ``path``.

    ``records`` (``sched.metrics.RequestRecord``) feed the TTFT/queue-wait
    histograms; ``extra`` adds ad-hoc gauges (e.g. wall-clock, wave count);
    ``health`` (an ``obs.health.HealthMonitor``) adds per-kind alert
    counters + the SLO burn-rate gauge.
    Format picked from the extension (``.prom`` vs JSON-lines).
    """
    reg = MetricsRegistry()
    for key, value in summary.items():
        if not isinstance(value, (int, float)) or isinstance(value, bool):
            continue
        if key in _SUMMARY_COUNTERS:
            reg.counter(_PREFIX + key, _SUMMARY_COUNTERS[key]).inc(value)
        else:
            reg.gauge(_PREFIX + key, f"engine summary {key}").set(value)
    if records:
        ttft = reg.histogram(_PREFIX + "ttft_seconds",
                             "time to first token (finish - arrival)")
        qwait = reg.histogram(_PREFIX + "queue_wait_seconds",
                              "admission queue wait (admit - arrival)")
        for r in records:
            # rejected requests carry finish/admit = inf — not a latency
            if math.isfinite(r.finish):
                ttft.observe(r.finish - r.arrival)
            if math.isfinite(r.admit):
                qwait.observe(r.admit - r.arrival)
    if extra:
        for key, value in extra.items():
            reg.gauge(_PREFIX + key, f"run stat {key}").set(float(value))
    if health is not None:
        health.to_metrics(reg)
    return reg.export(path)
