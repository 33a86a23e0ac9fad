"""Device resolution: every entry point runs on the card unless the caller
asks for the CPU."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` or ``"cuda"`` means the card; raises ``RuntimeError`` when
    no card is present. Nothing silently falls back to the CPU. ``"meta"``
    (shapes only, no memory: the dry run) is taken only when asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (CLI: --device cpu) to run on the CPU")
    return dev
