"""Checkpoints of the port's parameters and optimizer states."""
