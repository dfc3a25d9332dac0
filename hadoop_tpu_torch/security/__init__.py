"""HTTP authentication for the serving door (the hadoop-auth filter),
and the RPC caller's identity (``ugi``)."""
