"""Network topology and locality (``hadoop_tpu/net``)."""

from hadoop_tpu_torch.net.topology import (NetworkTopology,
                                           TopologyResolver, distance)

__all__ = ["NetworkTopology", "TopologyResolver", "distance"]
