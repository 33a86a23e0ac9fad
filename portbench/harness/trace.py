"""Reading a torch.profiler session of the measured window, and the card's
name and clocks.

Frozen copies, from ``chip_smoke.py`` at commit f0f447b: ``WAVE_CATEGORIES``,
``device_spans``, ``busy_window``, ``categorize``, ``card_clocks`` and
``card_line``. Added here: the host ranges of the session
(``record_function``), the device's busy time inside them, and the idle
gaps by the host range they fell in.
"""
from __future__ import annotations

import subprocess
from typing import Dict, List, Sequence, Tuple

WAVE_CATEGORIES = (
    ("K1 chunk_attention", ("chunkwalk", "chunk_attn")),
    ("K2 pool_attention", ("stackwalk", "pool_attn")),
    ("K3 pool_attention_paged", ("paged_attn",)),
    ("K4 ssd", ("ssd",)),
    ("matmuls", ("gemm", "nvjet", "cutlass", "xmma", "cublas")),
    # the MoE dispatch: its sorts, its counts' scan, its gathers and scatters
    ("MoE dispatch (sort, scan, gather / scatter)", ("sort", "scan", "scatter_gather")),
    ("page gathers / scatters", ("index", "gather", "scatter")),
    ("copies / casts", ("copy", "memcpy", "memset")),
)

Span = Tuple[float, float, str, str]          # (start us, end us, name, category)
Range = Tuple[float, float, str]              # (start us, end us, name)


def device_spans(prof) -> List[Span]:
    """The device activities (kernels, copies, sets) of a torch.profiler
    session, sorted: [(start us, end us, name, category)], read from its raw
    kineto events (an export to a Chrome trace and its parse took ~10 s for
    a wave's 37k events). The category is the trace's: ``gpu_memcpy`` /
    ``gpu_memset`` by the activity's name, else ``kernel`` (torch 2.11's
    events carry no ``activity_type``); user annotations are left out."""
    from torch.autograd import DeviceType
    spans = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        name = e.name()
        cat = ("gpu_memcpy" if name.startswith("Memcpy") else
               "gpu_memset" if name.startswith("Memset") else "kernel")
        spans.append((e.start_ns() / 1e3, e.end_ns() / 1e3, name, cat))
    return sorted(spans)


def host_ranges(prof, prefixes: Sequence[str]) -> List[Range]:
    """The host-side ``record_function`` ranges of the session whose names
    start with one of ``prefixes``, sorted by start: [(start us, end us,
    name)], on the clock of ``device_spans``."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CPU:
            continue
        name = e.name()
        if name.startswith(tuple(prefixes)):
            out.append((e.start_ns() / 1e3, e.end_ns() / 1e3, name))
    return sorted(out)


def busy_window(spans: list) -> tuple:
    """(busy s, window s) of ``device_spans``: the union of the activities'
    intervals, and the first start to the last end."""
    busy, (lo, hi) = 0.0, spans[0][:2]
    for t0, t1, *_ in spans[1:]:
        if t0 > hi:
            busy, lo, hi = busy + hi - lo, t0, t1
        else:
            hi = max(hi, t1)
    busy = (busy + hi - lo) / 1e6
    return busy, (max(span[1] for span in spans) - spans[0][0]) / 1e6


def categorize(spans: list) -> tuple:
    """(device seconds by WAVE_CATEGORIES label, device seconds by kernel
    name) of ``device_spans``."""
    split: dict = {}
    by_name: dict = {}
    for t0, t1, name, _ in spans:
        low = name.lower()
        label = next((lab for lab, keys in WAVE_CATEGORIES if any(k in low for k in keys)),
                     "other")
        split[label] = split.get(label, 0.0) + (t1 - t0) / 1e6
        by_name[name] = by_name.get(name, 0.0) + (t1 - t0) / 1e6
    return split, by_name


def device_seconds(spans: Sequence, patterns: Sequence[str]) -> float:
    """Device seconds of the spans whose lowered name holds one of
    ``patterns``."""
    return sum(t1 - t0 for t0, t1, name, _ in spans
               if any(p in name.lower() for p in patterns)) / 1e6


def union(spans: Sequence, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The union of the spans' intervals, clipped to [lo, hi] (us)."""
    out: List[List[float]] = []
    for s in spans:
        t0, t1 = max(s[0], lo), min(s[1], hi)
        if t1 <= t0:
            continue
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return [(a, b) for a, b in out]


def busy_inside(spans: Sequence, ranges: Sequence[Range]) -> Tuple[float, float]:
    """(device busy s, range s) summed over ``ranges``: the share of each
    range's time in which some device activity ran."""
    busy = total = 0.0
    for r0, r1, _ in ranges:
        total += (r1 - r0) / 1e6
        busy += sum(b - a for a, b in union(spans, r0, r1)) / 1e6
    return busy, total


def idle_gaps(spans: Sequence, ranges: Sequence[Range], lo: float, hi: float,
              outside: str = "outside the harness's ranges") -> Dict[str, float]:
    """Seconds of [lo, hi] in which no device activity ran, by the innermost
    host range open at each gap's middle (the latest-starting range that
    holds it): what the host was doing while the device waited."""
    busy = union(spans, lo, hi)
    gaps, prev = [], lo
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = b
    if hi > prev:
        gaps.append((prev, hi))
    out: Dict[str, float] = {}
    for g0, g1 in gaps:
        mid = (g0 + g1) / 2
        name = outside
        for r0, r1, rname in ranges:
            if r0 > mid:
                break
            if r1 >= mid:
                name = rname
        out[name] = out.get(name, 0.0) + (g1 - g0) / 1e6
    return out


def card_clocks() -> str:
    """The card's SM clock, its maximum, power draw and temperature as
    nvidia-smi prints them (beside a timing: a card set below its power
    limit or running hot runs slower under load); what nvidia-smi says
    if it cannot."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
                          "temperature.gpu", "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return ((out.stdout or out.stderr).strip() or "not read").splitlines()[0]


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]
