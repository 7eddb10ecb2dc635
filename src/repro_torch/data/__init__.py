"""Synthetic data of the port (a numpy copy of the reference's)."""
