"""The port's command line (``python -m hadoop_tpu_torch.cli.main``)."""
