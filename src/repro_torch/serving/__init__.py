"""Serving engine of the port (counterparts of ``repro.serving``)."""
