"""Serving plane of the PyTorch port: the continuous-batching decode
engine, its KV store and the checkpoint loader."""
