"""Observability of the port: the HBM ledger and the trainer's step
anatomy (counterparts of ``hadoop_tpu/obs/{hbm,trainer}.py``)."""
