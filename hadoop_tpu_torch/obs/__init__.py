"""Observability of the port: the HBM ledger, the trainer's step anatomy
and the serving door's tenant classes (counterparts of
``hadoop_tpu/obs/{hbm,trainer,slo}.py``)."""
