"""The port's copy of what it needs from the JAX package's ``io/``:
erasure coding on the host (GF(256) tables and matrices, the RS and XOR
coders, the EC policies and striped block ids) and the RPC client's
wire format (``wire``)."""
