"""Serving engine on the port (mirrors ``repro.runtime``)."""
