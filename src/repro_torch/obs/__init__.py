"""Observability of the port: the Chrome/Perfetto trace recorder
(``obs.trace``) the scheduler records into, its atomic writer
(``obs._io``), and the two closed forms of ``repro.obs.telemetry`` that the
prefix ledger check needs (``obs.telemetry``); mirrors the stdlib-only part
of ``repro.obs``."""
