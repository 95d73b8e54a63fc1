from repro_torch.simcore.engine import (
    AnyOf,
    Environment,
    Event,
    Interrupt,
    Process,
    Resource,
    RngStream,
    Store,
    Timeout,
    grid_ceil,
    stable_hash,
)
from repro_torch.simcore.sanitize import SanitizeError, Sanitizer

__all__ = [
    "AnyOf",
    "Environment",
    "Event",
    "Interrupt",
    "Process",
    "Resource",
    "RngStream",
    "SanitizeError",
    "Sanitizer",
    "Store",
    "Timeout",
    "grid_ceil",
    "stable_hash",
]
