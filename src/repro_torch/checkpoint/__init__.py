"""Checkpoints of the port: the reference's ``.npz`` + manifest format."""
