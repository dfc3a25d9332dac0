"""Serving plane of the PyTorch port: the continuous-batching decode
engine, its KV store, the checkpoint loader, the HTTP door in front of
them (``server``, ``service``, ``qos``, ``metrics``), and the SLO
autoscaler of a fleet of replicas (``autoscale``)."""
