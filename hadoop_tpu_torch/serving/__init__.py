"""Serving plane of the PyTorch port: the continuous-batching decode
engine and its KV store."""
