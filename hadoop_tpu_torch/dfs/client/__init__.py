"""The port's DFS client: ``DFSClient`` (the NameNode proxy, leases,
stream factories) and ``DistributedFileSystem`` (the ``htpu://``
filesystem on it)."""

from hadoop_tpu_torch.dfs.client.dfsclient import DFSClient
from hadoop_tpu_torch.dfs.client.filesystem import DistributedFileSystem

__all__ = ["DFSClient", "DistributedFileSystem"]
