"""Observability of the port: timed spans inside a round."""
