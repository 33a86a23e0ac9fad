"""Atomic artifact writes shared by the trace/metrics exporters.

A crashed or interrupted run must never leave a truncated/corrupt JSON (or
Prometheus textfile) artifact behind: write to a temp file in the SAME
directory (so the rename never crosses a filesystem) and ``os.replace`` it
into place — readers see either the old complete file or the new one.
"""
from __future__ import annotations

import os
import tempfile


def atomic_write_text(path: str, text: str) -> str:
    """Atomically write ``text`` to ``path`` (parent dirs created)."""
    path = os.path.abspath(path)
    d = os.path.dirname(path)
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path
