"""Learned split-decision modules of the port."""
