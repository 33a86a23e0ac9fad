"""Measured span attribution: per-(stage, tick) spans of the pipeline tick
loop, aligned index-for-index with the ``TelemetryProfile`` (mirrors
``repro.obs.profile``).

``prefill_pipeline`` accepts a ``tick_hook``: a zero-arg callable it calls
at the end of every tick, after the tick's work is enqueued.
``TickSpanCollector.note`` is that hook. On the card it records one
``torch.cuda.Event(enable_timing=True)`` on the current stream (``reset``
records one more before the first tick's work); ``finalize`` synchronizes
once and takes ``elapsed_time`` between consecutive events: device-stream
time, seconds. On the CPU it reads ``time.perf_counter``. A collector made
for the card never falls back on the host clock.

This departs from the reference on purpose. The reference's beacon is a
zero-operand ``jax.debug.callback`` whose host ARRIVAL times it timestamps,
and since a tick may fire it once per participating dispatch, ``finalize``
order-groups the sorted arrivals into ``num_ticks`` groups and keeps each
group's last. Here one event a tick marks the end of that tick's work on
the device's stream, so the groups are of one; ``finalize`` keeps the
reference's grouping and layout all the same, so both give the same
profile of the same stream of times.

The layout is the reference's: ``tick_s [N, T]`` stage-major, ``T = M + N
- 1``; each tick's span is broadcast into its VALID cells (``0 <= tick -
stage < M``), bubble cells stay zero. Ticks run every stage in lockstep
(here: batched on one card), so the span is shared by the stages active
that tick; ``finalize`` does not partition it between them. Tick 0 also
carries what ran on the stream between ``reset`` and the first tick's
work.

Per-kernel-tag attribution rides ``kernels.ops.timed_launches``: the
ordered ``(tag, stamp)`` stream of the wrappers, and ``kernel_tag_times``
charges each inter-stamp delta to the tag of the LATER stamp (the kernel
whose completion it marks) — so a tag's total also holds the other device
work between it and the launch before it.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch


@dataclass
class MeasuredProfile:
    """The measured twin of ``TelemetryProfile``: ``tick_s [N, T]`` seconds
    per (stage, tick), plus optional per-kernel-tag totals."""
    tick_s: np.ndarray
    kernel_s: Dict[str, float] = field(default_factory=dict)

    @property
    def stages(self) -> int:
        return self.tick_s.shape[0]

    @property
    def ticks(self) -> int:
        return self.tick_s.shape[1]

    def valid(self, num_chunks: int) -> np.ndarray:
        """Boolean [N, T]: True where ``0 <= tick - stage < M`` — the spans
        that carry a real chunk (the telemetry validity convention); the
        rest is fill/drain bubble."""
        n, t_all = self.tick_s.shape
        ph = np.arange(t_all)[None, :] - np.arange(n)[:, None]
        return (ph >= 0) & (ph < num_chunks)

    def total(self) -> float:
        """End-to-end measured loop seconds (ticks are lockstep: the
        per-tick maximum over stages, summed)."""
        return float(self.tick_s.max(axis=0).sum())

    def to_dict(self) -> Dict:
        return {"tick_s": [[float(v) for v in row] for row in self.tick_s],
                "kernel_s": {k: float(v) for k, v in self.kernel_s.items()}}


class TickSpanCollector:
    """The pipeline's ``tick_hook``: pass ``col.note``; ``reset`` right
    before the timed call; ``finalize`` after it. ``device``: where the
    pipeline runs (default the card)."""

    def __init__(self, device=None) -> None:
        from repro_torch import device as devices
        self.cuda = devices.resolve(device).type == "cuda"
        self.reset()

    def _stamp(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def reset(self) -> None:
        self.epoch = self._stamp()
        self.events: List = []

    def note(self) -> None:
        self.events.append(self._stamp())

    def arrivals(self) -> List[float]:
        """The stamps as seconds since ``epoch``. Card: one synchronize on
        the last event, then ``elapsed_time`` between consecutive events,
        accumulated."""
        if not self.cuda:
            return [t - self.epoch for t in self.events]
        if not self.events:
            return []
        self.events[-1].synchronize()
        out, prev, acc = [], self.epoch, 0.0
        for ev in self.events:
            acc += prev.elapsed_time(ev) / 1e3
            out.append(acc)
            prev = ev
        return out

    def finalize(self, num_stages: int, num_ticks: int, *,
                 kernel_s: Optional[Dict[str, float]] = None
                 ) -> MeasuredProfile:
        """Collapse the stamp stream into ``tick_s [N, T]``: order-group the
        sorted arrivals into ``num_ticks`` groups, keep each group's LAST
        arrival, difference consecutive group arrivals (tick 0 against the
        epoch), and broadcast each tick's span into its VALID (stage, tick)
        cells (``0 <= tick - stage < M``). A tick that never fired gets a
        zero span; bubble cells stay zero."""
        ts = sorted(self.arrivals())
        arrive = np.full(num_ticks, np.nan)
        if ts:
            k = max(1, int(round(len(ts) / num_ticks)))
            for t in range(num_ticks):
                lo = t * k
                if lo >= len(ts):
                    break
                hi = len(ts) if t == num_ticks - 1 else min((t + 1) * k,
                                                            len(ts))
                arrive[t] = ts[hi - 1]
        m = num_ticks - num_stages + 1  # num_chunks under T = M + N - 1
        tick_s = np.zeros((num_stages, num_ticks))
        prev = 0.0
        for t in range(num_ticks):
            cur = arrive[t]
            if np.isnan(cur):
                cur = prev
            span = max(cur - prev, 0.0)
            prev = cur
            s_lo = max(0, t - m + 1)
            s_hi = min(num_stages - 1, t)
            tick_s[s_lo:s_hi + 1, t] = span
        return MeasuredProfile(tick_s=tick_s, kernel_s=dict(kernel_s or {}))


def kernel_tag_times(frame: Dict) -> Dict[str, float]:
    """Per-kernel-tag totals from a timed frame in seconds
    (``ops.frame_seconds``): each inter-event delta is charged to the tag
    of the LATER event (the kernel whose completion it marks); the first
    event's delta runs from ``frame["t0"]``."""
    events = frame.get("events") or []
    out: Dict[str, float] = {}
    prev = float(frame.get("t0", events[0][1] if events else 0.0))
    for tag, ts in events:
        out[tag] = out.get(tag, 0.0) + max(ts - prev, 0.0)
        prev = ts
    return out


def measure_prefill(cfg, staged, tokens, plan, *, device=None, embeds=None,
                    warmup: int = 1, timed_kernels: bool = False):
    """Timed run of the tick loop: ``prefill_pipeline`` with a
    ``tick_hook`` (and ``embeds``, the vlm's or encdec's stub frontend,
    passed on); returns ``(logits, MeasuredProfile)``.

    ``warmup`` untimed runs first (allocator, library handles, the
    kernels' first build); ``timed_kernels=True`` runs the timed call
    inside ``ops.timed_launches`` and attaches the per-tag totals."""
    from repro_torch.core import pipeline as pl
    from repro_torch.kernels import ops

    col = TickSpanCollector(device)

    def run():
        return pl.prefill_pipeline(cfg, staged, tokens, plan, device=device,
                                   embeds=embeds, tick_hook=col.note)

    for _ in range(max(int(warmup), 0)):
        run()
    kernel_s: Dict[str, float] = {}
    if timed_kernels:
        with ops.timed_launches(device) as frame:
            col.reset()
            logits = run()
        kernel_s = kernel_tag_times(ops.frame_seconds(frame))
    else:
        col.reset()
        logits = run()
    return logits, col.finalize(plan.num_stages, plan.num_ticks,
                                kernel_s=kernel_s)
