"""Entry points of the port (mirrors ``repro.launch``)."""
