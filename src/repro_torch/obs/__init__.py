"""Observability of the port (mirrors ``repro.obs``): stage telemetry,
merged traces, metrics export, and the closed profiling loop (measure ->
calibrate -> detect drift).

- ``obs.telemetry``   the per-(stage, tick) counters ``prefill_pipeline(
                      return_telemetry=True)`` returns as ``[N, T]``
                      profiles: pool occupancy, resident KV bytes,
                      spill / fetch / qship events, attention work, the
                      reference's logical launches, prefix hits (host
                      arithmetic on the host-side stage predicates).
- ``obs.trace``       the Chrome/Perfetto trace recorder: scheduler tasks,
                      engine wave / tick spans, per-stage counter tracks,
                      one merged file (atomic export).
- ``obs.metrics``     counters / gauges / histograms with JSON-lines and
                      Prometheus-textfile export for serving runs.
- ``obs.profile``     MEASURED per-(stage, tick) spans (CUDA events on the
                      card) aligned with the telemetry profiles, plus
                      per-kernel-tag attribution riding
                      ``kernels.ops.timed_launches``.
- ``obs.calibrate``   least-squares fit of the ``HardwareProfile``
                      effective rates against measured spans; the profile
                      JSON ``lbcp.plan_partition`` / ``chunk_cost_arrays``
                      / the scheduler's admission accept. On one card a
                      span is N stages' work: the fit is an effective
                      "N stages on one card" profile.
- ``obs.health``      runtime sentinels: non-finite activations, telemetry
                      vs analytic drift, SLO burn-rate — one alert stream
                      into metrics and trace.

``obs.trace``, ``obs.metrics``, ``obs.health``, ``obs.calibrate`` and
``obs.telemetry`` need only the stdlib and numpy; ``obs.profile`` also
imports torch (CUDA events).
"""
from repro_torch.obs.health import Alert, HealthMonitor, slo_burn_rate
from repro_torch.obs.metrics import MetricsRegistry, export_engine_metrics
from repro_torch.obs.profile import MeasuredProfile, TickSpanCollector
from repro_torch.obs.trace import TraceRecorder

__all__ = ["Alert", "HealthMonitor", "MeasuredProfile", "MetricsRegistry",
           "TickSpanCollector", "TraceRecorder", "export_engine_metrics",
           "slo_burn_rate"]
