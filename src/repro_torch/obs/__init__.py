"""Observability of the port: so far the Chrome/Perfetto trace recorder
(``obs.trace``) the scheduler records into, and its atomic writer
(``obs._io``); mirrors the stdlib-only part of ``repro.obs``."""
