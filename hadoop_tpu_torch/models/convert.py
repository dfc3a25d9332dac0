"""Carry a JAX-package parameter tree, as numpy arrays, into the port.

The tree keeps its leaf names and its stacked ``[L, ...]`` layout. numpy
has no native bfloat16 (JAX hands out ``ml_dtypes.bfloat16`` arrays), so
bf16 leaves cross as their raw 16-bit patterns and are reinterpreted as
``torch.bfloat16``: bit-exact, no rounding. A weight-plane tree crosses
too: each quantized weight ``{"q": int8, "s": float32}`` keeps its two
dtypes (``serving/weightplane.py``).
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
    config's, or, in a quantized weight, not int8 (``q``) and float32
    (``s``)."""
    dev = resolve_device(device)

    def leaf(node, want: torch.dtype):
        t = _leaf(np.asarray(node), dev)
        if t.dtype != want:
            raise ValueError(f"leaf dtype {t.dtype} is not {want}")
        return t

    def convert(node):
        if isinstance(node, dict) and set(node) == {"q", "s"}:
            return {"q": leaf(node["q"], torch.int8),
                    "s": leaf(node["s"], torch.float32)}
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        return leaf(node, cfg.torch_dtype)

    return convert(tree)
