"""Datasets of the port (numpy, shared bit for bit with the reference)."""
