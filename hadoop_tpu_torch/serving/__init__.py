"""Serving plane of the PyTorch port: the continuous-batching decode
engine, its KV store, the checkpoint loader, and the HTTP door in front
of them (``server``, ``service``, ``qos``, ``metrics``)."""
