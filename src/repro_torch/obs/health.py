"""Runtime health sentinels: a structured alert stream over the obs surfaces
(the port's own copy of ``repro.obs.health``).

Three sentinel families feed one ``HealthMonitor``:

- ``nonfinite``   NaN/inf activations per (stage, tick): with a monitor
  attached, ``prefill_pipeline`` counts the non-finite values of every
  stage's output each tick on the device, masked to the active stages, into
  one ``[N, T]`` int32 tensor that it reads ONCE after the tick loop into
  ``note_nonfinite_profile`` (no per-tick synchronize). ``health=None``
  launches nothing extra and leaves the logits bit-identical.
- ``occupancy_drift`` / ``ledger_drift``   the stage telemetry / collective
  ledger measured against their analytic twins
  (``telemetry.analytic_occupancy``, ``transport.analytic_wire_bytes``)
  beyond a relative threshold — the invariants the tests assert once,
  watched continuously in serving.
- ``slo_burn``   SLO burn-rate from the TTFT histogram: the fraction of the
  error budget (``1 - target``) being consumed. Burn-rate 1.0 = exactly on
  budget; an alert fires above ``burn_threshold``.

Alerts land in BOTH export surfaces: ``to_metrics`` adds per-kind counters
(+ the burn-rate gauge) to a ``MetricsRegistry``; ``to_trace`` adds a
``health`` process row of instant spans to the merged Perfetto trace.

Import-light: stdlib + numpy.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional

import numpy as np

ALERT_KINDS = ("nonfinite", "occupancy_drift", "ledger_drift", "slo_burn")


@dataclass(frozen=True)
class Alert:
    kind: str                      # one of ALERT_KINDS
    severity: str                  # "warn" | "crit"
    message: str
    value: float                   # the measurement that tripped
    threshold: float
    stage: Optional[int] = None
    tick: Optional[int] = None
    time: float = 0.0              # perf_counter at detection

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "severity": self.severity,
                "message": self.message, "value": self.value,
                "threshold": self.threshold, "stage": self.stage,
                "tick": self.tick, "time": self.time}


def slo_burn_rate(hist, slo_s: float, target: float = 0.99) -> float:
    """Burn-rate from a ``metrics.Histogram``: ``(1 - frac_within_slo) /
    (1 - target)`` using the largest bucket boundary <= ``slo_s`` (a
    conservative read of the quantized histogram). 0.0 on no observations.
    """
    if hist.count == 0:
        return 0.0
    within = 0
    for b, c in zip(hist.buckets, hist.cumulative()):
        if b <= slo_s:
            within = c
        else:
            break
    frac_violating = 1.0 - within / hist.count
    budget = max(1.0 - target, 1e-12)
    return frac_violating / budget


class HealthMonitor:
    """Accumulates alerts; attach to the executor (``note_nonfinite`` is the
    device callback target) and run the ``check_*`` sentinels host-side."""

    def __init__(self, *, occupancy_threshold: float = 0.01,
                 ledger_threshold: float = 0.01,
                 burn_threshold: float = 1.0):
        self.occupancy_threshold = occupancy_threshold
        self.ledger_threshold = ledger_threshold
        self.burn_threshold = burn_threshold
        self.alerts: List[Alert] = []
        self.burn_rate: Optional[float] = None

    # ------------------------------------------------------ device callback
    def note_nonfinite_profile(self, counts,
                               where: str = "activations") -> None:
        """Receives the pipeline's ``[N, T]`` per-(stage, tick) non-finite
        count profile (read from the device once, after the tick loop).
        Emits one alert per offending cell; an all-zero profile (the
        healthy case) emits nothing."""
        arr = np.asarray(counts)
        for s, t in zip(*np.nonzero(arr)):
            self.note_nonfinite(arr[s, t], t, s, where=where)

    def note_nonfinite(self, count, tick, stage, where: str = "activations"
                       ) -> None:
        """Per-cell alert emitter (see ``note_nonfinite_profile``); zero
        count = healthy cell = no alert."""
        n = int(count)
        if n > 0:
            self.alerts.append(Alert(
                kind="nonfinite", severity="crit",
                message=f"{n} non-finite {where} at stage "
                        f"{int(stage)} tick {int(tick)}",
                value=float(n), threshold=0.0, stage=int(stage),
                tick=int(tick), time=time.perf_counter()))

    # ----------------------------------------------------- drift sentinels
    def check_occupancy(self, telem, plan) -> float:
        """Device occupancy vs the closed-form twin: relative drift
        ``max|measured - analytic| / analytic_peak``. ``telem`` is a
        ``TelemetryProfile`` or the raw dict a wave carries."""
        from repro_torch.obs import telemetry as obs_t
        prof = telem if hasattr(telem, "occupancy") \
            else obs_t.TelemetryProfile.from_run(telem)
        own, hosted = obs_t.analytic_occupancy(
            plan.num_chunks, plan.num_stages, plan.p2, mode=plan.mode,
            ticks=prof.ticks)
        model = own + hosted
        drift = obs_t.safe_ratio(
            float(np.abs(prof.occupancy() - model).max()),
            float(model.max()))
        if drift > self.occupancy_threshold:
            self.alerts.append(Alert(
                kind="occupancy_drift", severity="warn",
                message=f"telemetry occupancy drifts {drift:.3f} from the "
                        "analytic slot model",
                value=drift, threshold=self.occupancy_threshold,
                time=time.perf_counter()))
        return drift

    def check_ledger(self, ledger: Mapping[str, float],
                     model: Mapping[str, float]) -> float:
        """Measured collective-ledger bytes vs the §3.4 analytic wire model:
        worst per-category relative drift over the shared categories."""
        from repro_torch.obs.telemetry import safe_ratio
        worst = 0.0
        for k in set(ledger) & set(model):
            d = safe_ratio(abs(float(ledger[k]) - float(model[k])),
                           abs(float(model[k])))
            if d > worst:
                worst = d
            if d > self.ledger_threshold:
                self.alerts.append(Alert(
                    kind="ledger_drift", severity="warn",
                    message=f"ledger category {k!r} drifts {d:.3f} from the "
                            "analytic wire model",
                    value=d, threshold=self.ledger_threshold,
                    time=time.perf_counter()))
        return worst

    def check_slo(self, ttft_hist, slo_s: float,
                  target: float = 0.99) -> float:
        """SLO burn-rate sentinel over the TTFT histogram."""
        burn = slo_burn_rate(ttft_hist, slo_s, target)
        self.burn_rate = burn
        if burn > self.burn_threshold:
            self.alerts.append(Alert(
                kind="slo_burn", severity="crit",
                message=f"TTFT SLO burn-rate {burn:.2f}x the error budget "
                        f"(slo={slo_s}s, target={target})",
                value=burn, threshold=self.burn_threshold,
                time=time.perf_counter()))
        return burn

    # ------------------------------------------------------------- exports
    def counts(self) -> Dict[str, int]:
        out = {k: 0 for k in ALERT_KINDS}
        for a in self.alerts:
            out[a.kind] = out.get(a.kind, 0) + 1
        return out

    def summary(self) -> Dict[str, Any]:
        return {"alerts_total": len(self.alerts), "by_kind": self.counts(),
                "burn_rate": self.burn_rate}

    def to_metrics(self, reg) -> None:
        """Per-kind alert counters + the burn-rate gauge on a
        ``MetricsRegistry`` (same ``repro_`` prefix as the engine export)."""
        total = reg.counter("repro_health_alerts_total",
                            "health sentinel alerts fired")
        total.inc(len(self.alerts))
        for kind, n in self.counts().items():
            reg.counter(f"repro_health_{kind}_total",
                        f"{kind} sentinel alerts").inc(n)
        if self.burn_rate is not None:
            reg.gauge("repro_health_slo_burn_rate",
                      "TTFT SLO burn-rate (1.0 = on budget)"
                      ).set(self.burn_rate)

    def to_trace(self, rec, *, pid: str = "health",
                 width_s: float = 1e-4) -> None:
        """Instant spans on a dedicated ``health`` process row of the merged
        Perfetto trace (one thread row per alert kind)."""
        if not self.alerts:
            return
        rec.process_name(pid, "health sentinels")
        t0 = min(a.time for a in self.alerts)
        for a in self.alerts:
            rec.span(a.message, pid=pid, tid=a.kind, start=a.time - t0,
                     finish=a.time - t0 + width_s, cat="alert",
                     args=a.to_dict())
