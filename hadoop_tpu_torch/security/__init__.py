"""HTTP authentication for the serving door (the hadoop-auth filter),
the RPC caller's identity and tokens (``ugi``), and the client side of
SASL (``sasl``)."""
