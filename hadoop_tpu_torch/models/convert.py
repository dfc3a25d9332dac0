"""Carry a JAX-package parameter tree, as numpy arrays, into the port.

The tree keeps its leaf names and its stacked ``[L, ...]`` layout. numpy
has no native bfloat16 (JAX hands out ``ml_dtypes.bfloat16`` arrays), so
bf16 leaves cross as their raw 16-bit patterns and are reinterpreted as
``torch.bfloat16``: bit-exact, no rounding.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from hadoop_tpu_torch.device import resolve_device
from hadoop_tpu_torch.models.config import ModelConfig


def _leaf(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    arr = np.array(arr, order="C")     # a writable copy for torch
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                      device=None) -> Dict[str, Any]:
    """The port's parameter tree from ``tree`` (nested dicts of numpy
    arrays, e.g. ``jax.tree_util.tree_map(np.asarray, params)``) on
    ``device`` (default: the GPU). Raises if a leaf's dtype is not the
    config's."""
    dev = resolve_device(device)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        t = _leaf(np.asarray(node), dev)
        if t.dtype != cfg.torch_dtype:
            raise ValueError(f"leaf dtype {t.dtype} is not the config's "
                             f"{cfg.torch_dtype}")
        return t

    return convert(tree)
