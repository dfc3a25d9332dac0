"""The port's copy of what it needs from the JAX package's ``io/``:
erasure coding on the host (GF(256) tables and matrices, the RS and XOR
coders, the EC policies and striped block ids) and the wire format of
the RPC and data-transfer frames (``wire``, re-exported here as the
reference's package does)."""

from hadoop_tpu_torch.io.wire import (Decoder, Encoder, WireError, pack,
                                      unpack)

__all__ = ["pack", "unpack", "WireError", "Encoder", "Decoder"]
