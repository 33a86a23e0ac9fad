"""Serving engine and checkpoints on the port (mirrors ``repro.runtime``)."""
from repro_torch.runtime.checkpoint import latest_step, restore_checkpoint, save_checkpoint

__all__ = ["latest_step", "restore_checkpoint", "save_checkpoint"]
