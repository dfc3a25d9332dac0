"""The port's copy of what it needs from the JAX package's ``io/``:
GF(256) tables and matrices for erasure coding, and the RPC client's
wire format (``wire``)."""
