"""Closed forms of the reference's stage telemetry that the prefix ledger
check needs (mirrors ``repro.obs.telemetry.chunk_stored_bytes`` and
``prefix_saved_model``, copied exactly).

The rest of ``repro.obs.telemetry`` (the per-(stage, tick) profile that
``prefill_pipeline(return_telemetry=True)`` returns, its charges and its
host-side view) is not ported yet: it comes with the device half of
observability (ROADMAP queue 1, item 4).
"""
from __future__ import annotations

from typing import Dict


def chunk_stored_bytes(plan, lps: int, b: int, c: int, kvh: int,
                       hd: int) -> float:
    """STORED bytes of one chunk in the stage's paged pool (k + v payload at
    the codec's storage width + the per-page fp32 scale rows when
    quantized) — equals ``nbytes(encode(k)) + nbytes(encode(v))`` for the
    given geometry."""
    codec = plan.codec
    payload = 2.0 * lps * b * c * kvh * hd * codec.bytes_per_el
    scales = 2.0 * plan.pages_per_chunk * codec.scale_bytes_per_page(
        lps, b, kvh)
    return payload + scales


def prefix_saved_model(plan, lps: int, b: int, c: int, kvh: int, hd: int,
                       prefix_chunks: int) -> Dict[str, float]:
    """Closed-form twin of the ``prefix_hit`` ledger category for one armed
    ``prefill_pipeline(..., prefix_chunks=k)`` call: every stage redirects
    exactly its ``k`` hit-phase chunk stores to scratch, so

        ledger_bytes = N_stages x k x chunk_stored_bytes   (saved KV stores)
        events       = N_stages x k                        (telemetry count)

    with the SAME clamp the pipeline applies (``k <= min(p2, M-1)``)."""
    k = min(max(int(prefix_chunks), 0),
            min(plan.p2, plan.num_chunks - 1))
    cb = chunk_stored_bytes(plan, lps, b, c, kvh, hd)
    return {"ledger_bytes": plan.num_stages * k * cb,
            "events": float(plan.num_stages * k)}
