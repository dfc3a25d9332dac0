"""Measurement tools of the PyTorch port (run on a CUDA device)."""
