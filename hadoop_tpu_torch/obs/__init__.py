"""Observability of the port: the HBM ledger, the trainer's step anatomy,
the serving door's tenant classes and the fleet SLO scoreboard, the comm
ledger, and the fleet doctor with its slow-node detection and trace
assembly (counterparts of ``hadoop_tpu/obs/{hbm,trainer,slo,comm,top,
detect,assemble,doctor}.py``)."""
