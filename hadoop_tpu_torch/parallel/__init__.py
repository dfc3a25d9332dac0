"""Training on one device: the mesh plan's names, AdamW and the train
step (counterparts of ``hadoop_tpu/parallel/{mesh,optimizer,train}.py``).
Multi-GPU parallelism comes in a later slice."""

from hadoop_tpu_torch.parallel.mesh import MeshPlan
from hadoop_tpu_torch.parallel.optimizer import (AdamWState, adamw_init,
                                                 adamw_update)
from hadoop_tpu_torch.parallel.train import init_train_state, make_train_step

__all__ = ["MeshPlan", "AdamWState", "adamw_init", "adamw_update",
           "init_train_state", "make_train_step"]
