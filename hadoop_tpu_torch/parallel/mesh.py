"""Mesh plans: the names of the five parallel axes.

A copy of the ``MeshPlan`` dataclass of ``hadoop_tpu/parallel/mesh.py``
(its fields, their checks and ``n_devices``), so that callers of the port
name a plan as they do in the reference. The port runs on one device:
there is no mesh and no collective here, and the train step refuses any
plan of more than one device until the multi-GPU slice.

Axis roles: ``dp`` data, ``pp`` pipeline, ``tp`` tensor (Megatron
sequence parallelism rides it), ``ep`` expert, ``sp`` context (ring or
Ulysses attention).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    dp: int = 1
    pp: int = 1
    tp: int = 1
    ep: int = 1
    sp: int = 1
    megatron_sp: bool = False   # sequence parallelism on the tp axis
    sp_mode: str = "ring"       # context-parallel attention: ring | ulysses
    vpp: int = 1                # virtual stages per pp rank (interleaved
    #                             1F1B model chunks, Megatron-style)

    def __post_init__(self):
        if self.megatron_sp and self.tp == 1:
            raise ValueError("megatron_sp requires tp > 1")
        if self.vpp > 1 and self.pp == 1:
            raise ValueError("vpp (interleaved virtual stages) requires "
                             "pp > 1")
        if self.sp > 1 and self.megatron_sp:
            raise ValueError("sp composes with plain tp, not megatron_sp "
                             "(two different sequence shardings would "
                             "fight over the same dimension)")
        if self.sp > 1 and self.ep > 1:
            raise ValueError("sp x ep (MoE) is not supported yet")

    @property
    def n_devices(self) -> int:
        return self.dp * self.pp * self.tp * self.ep * self.sp
