"""Static analysis of the port's source: the conf-key scanner
(``confscan.py``) that generates ``conf/registry.py``.

    python -m hadoop_tpu_torch.analysis --write-conf-registry
    python -m hadoop_tpu_torch.analysis --check-conf-registry
"""
