"""Experiment entry points of the port."""
