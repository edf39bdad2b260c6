"""Decoder models of the port (dense attention blocks)."""
