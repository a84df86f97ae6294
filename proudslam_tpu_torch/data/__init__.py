"""Synthetic RGB-D data (numpy-only copy of the JAX package's generator)."""
