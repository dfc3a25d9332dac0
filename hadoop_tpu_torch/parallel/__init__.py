"""Training: the mesh plan and its process groups, the collectives, AdamW
and ZeRO-1, the pipeline schedules, the train step, the token stream,
checkpoints, their reshard between plans, the trainer that drives them
and the parity tiers (counterparts of ``hadoop_tpu/parallel/{mesh,
optimizer,overlap,pipeline,train,data,checkpoint,trainer}.py``,
``parallel/elastic/reshard.py`` and ``parallel/lowp``). Names resolve
on first use, so the model modules can import ``parallel.spmd`` without
pulling in the train step that imports them."""

import importlib

_EXPORTS = {
    "MeshPlan": "mesh", "make_mesh": "mesh",
    "AdamWState": "optimizer", "adamw_init": "optimizer",
    "adamw_update": "optimizer",
    "init_train_state": "train", "make_train_step": "train",
    "TokenDataset": "data", "Trainer": "trainer",
    "ParityConfig": "lowp", "parity_from_conf": "lowp",
    "BITWISE_PARITY": "lowp", "RELAXED_PARITY": "lowp",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"),
                   name)
