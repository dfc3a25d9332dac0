"""Activation functions for transformer MLP blocks."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximated GeLU (the JAX package's ``approximate=True``)."""
    return F.gelu(x, approximate="tanh")


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """SwiGLU gating: silu(gate) * up (Llama/Mixtral MLPs)."""
    return F.silu(gate) * up
