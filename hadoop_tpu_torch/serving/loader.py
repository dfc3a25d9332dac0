"""Serving-side checkpoint load: a checkpoint directory → decoder params.

The counterpart of ``hadoop_tpu/serving/loader.py``. It reads the
trainer's checkpoints (``parallel/checkpoint.py``, the reference's
format, so a checkpoint of either package loads) off any filesystem the
caller passes (``hadoop_tpu_torch.fs``). Shards are fetched concurrently
through a bounded pool of ``io_workers``. The trainer persists
``{"params": ..., "opt": ..., "data_pos": ...}`` and serving wants the
parameters only: the manifest's leaf names tell the wrapped layout from
a bare parameter tree, and optimizer shards are never read.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional, Tuple

import torch

from hadoop_tpu_torch.fs import FileSystemLike
from hadoop_tpu_torch.models.config import ModelConfig
from hadoop_tpu_torch.models.decoder import init_params
from hadoop_tpu_torch.parallel.checkpoint import (latest_step,
                                                  load_checkpoint,
                                                  local_shape,
                                                  map_with_path,
                                                  mismatched_leaves,
                                                  read_manifest,
                                                  spec_paths)
from hadoop_tpu_torch.parallel.optimizer import tree_leaves

log = logging.getLogger(__name__)

HEDGED_POOL_KEY = "dfs.client.hedged.read.threadpool.size"
HEDGED_THRESHOLD_KEY = "dfs.client.hedged.read.threshold"
IO_WORKERS_KEY = "serving.loader.io.workers"


def serving_read_defaults(conf) -> None:
    """Arm hedged reads for checkpoint pulls unless the deployment already
    chose (``conf``: any object with ``set_if_unset``, such as a
    ``hadoop_tpu`` ``Configuration``)."""
    conf.set_if_unset(HEDGED_POOL_KEY, "4")
    conf.set_if_unset(HEDGED_THRESHOLD_KEY, "0.5")


def load_serving_params(fs: FileSystemLike, base_dir: str, cfg: ModelConfig,
                        *, step: Optional[int] = None, mesh=None, specs=None,
                        io_workers: int = 4, leaf_transform=None,
                        device=None) -> Tuple[Dict, int]:
    """Load decoder params for ``cfg`` from ``base_dir`` on ``fs`` onto
    ``device`` (default: the GPU). Returns ``(params, step)``; ``step``
    None takes the newest complete checkpoint.

    Every leaf's shape and dtype is checked against ``cfg`` before a
    shard is read, from a parameter tree on the meta device (no model is
    allocated); a mismatch raises ``ValueError``. Raises
    ``FileNotFoundError`` when no complete checkpoint exists.
    ``leaf_transform`` switches ``load_checkpoint`` to its streaming
    per-leaf mode, the weight plane's quantize-at-load seam
    (``serving/weightplane.py``): each assembled leaf is consumed as its
    shards arrive, so the float model never lies whole on the host.
    With ``mesh`` (``make_mesh(plan)``) and ``specs``
    (``param_specs(cfg, plan)``) it returns this rank's shards,
    ``shard_params`` of the full load, reading only the shard files that
    overlap them. The streaming mode does not take a mesh, as the
    reference's does not (``load_checkpoint`` raises).
    """
    t0 = time.monotonic()
    if step is None:
        step = latest_step(fs, base_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {base_dir}")
    manifest = read_manifest(fs, base_dir, step)
    shapes = init_params(cfg, torch.Generator(), device="meta")
    wrapped = any(name.startswith("['params']")
                  for name in manifest["leaves"])
    like = {"params": shapes} if wrapped else shapes
    bad = mismatched_leaves(manifest, like)
    if bad:
        raise ValueError(f"checkpoint {base_dir} step {step} does not hold "
                         f"the parameters of this config: {bad[:3]}")
    if mesh is not None:            # this rank's shard shapes
        spec_of = spec_paths(specs)
        local = map_with_path(lambda name, t: torch.empty(
            local_shape(t.shape, spec_of.get(name), mesh.plan.sizes),
            dtype=t.dtype, device="meta"), shapes)
        like = {"params": local} if wrapped else local
        specs = {"params": specs} if wrapped else specs
    tree, step = load_checkpoint(fs, base_dir, like, step=step,
                                 io_workers=max(1, io_workers),
                                 device=device, mesh=mesh, specs=specs,
                                 leaf_transform=leaf_transform)
    params = tree["params"] if wrapped else tree
    n = sum(p.numel() for p in tree_leaves(shapes))
    log.info("loaded %d-param checkpoint step %d from %s in %.2fs "
             "(%d io workers)", n, step, base_dir,
             time.monotonic() - t0, max(1, io_workers))
    return params, step
