"""Device selection for the port's entry points.

Every entry point runs on the GPU unless its caller names another
device. Without a CUDA device and without an explicit request, it
raises: the port never falls back to the CPU on its own.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the current CUDA device; raises when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def check_on(tensor: torch.Tensor, device: torch.device, what: str) -> None:
    """Raise unless ``tensor`` lies on ``device``."""
    if tensor.device != device:
        raise ValueError(f"{what} lies on {tensor.device}, expected {device}")
