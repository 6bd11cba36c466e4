"""Subpackage of the PyTorch port (mirrors the JAX package layout)."""
