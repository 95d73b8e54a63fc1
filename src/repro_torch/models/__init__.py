"""Model definitions of the port (counterparts of ``repro.models``)."""
