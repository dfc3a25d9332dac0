"""Training on one device: the mesh plan's names, AdamW, the train step,
the token stream, checkpoints and the trainer that drives them
(counterparts of ``hadoop_tpu/parallel/{mesh,optimizer,train,data,
checkpoint,trainer}.py``). Multi-GPU parallelism comes in a later
slice."""

from hadoop_tpu_torch.parallel.mesh import MeshPlan
from hadoop_tpu_torch.parallel.optimizer import (AdamWState, adamw_init,
                                                 adamw_update)
from hadoop_tpu_torch.parallel.train import init_train_state, make_train_step
from hadoop_tpu_torch.parallel.data import TokenDataset
from hadoop_tpu_torch.parallel.trainer import Trainer

__all__ = ["MeshPlan", "AdamWState", "adamw_init", "adamw_update",
           "init_train_state", "make_train_step", "TokenDataset", "Trainer"]
