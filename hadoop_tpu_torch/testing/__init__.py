"""The port's in-process DFS minicluster (``minicluster``)."""

from hadoop_tpu_torch.testing.minicluster import MiniDFSCluster, fast_conf

__all__ = ["MiniDFSCluster", "fast_conf"]
