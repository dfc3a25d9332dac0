"""The port's DFS client (``client``) and the client half of the DFS
protocols (``protocol``). The NameNode and the DataNodes stay the
reference's (ROADMAP Queue A 10)."""
