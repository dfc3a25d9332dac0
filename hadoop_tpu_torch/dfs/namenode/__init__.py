"""The port's NameNode (``hadoop_tpu/dfs/namenode``)."""

from hadoop_tpu_torch.dfs.namenode.namenode import NameNode

__all__ = ["NameNode"]
