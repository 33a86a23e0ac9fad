"""Training data for the port (mirrors ``repro.data``)."""
from repro_torch.data.pipeline import DataState, SyntheticLM

__all__ = ["DataState", "SyntheticLM"]
