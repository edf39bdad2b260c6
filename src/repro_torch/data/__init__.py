"""Deterministic synthetic data of the port (NumPy)."""
