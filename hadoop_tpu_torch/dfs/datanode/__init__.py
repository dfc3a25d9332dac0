"""The port's DataNode (``hadoop_tpu/dfs/datanode``)."""

from hadoop_tpu_torch.dfs.datanode.datanode import DataNode

__all__ = ["DataNode"]
