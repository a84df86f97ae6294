"""Numpy-only utilities (trajectory metrics)."""
