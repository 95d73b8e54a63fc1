"""The metric `orchestrator_ms_per_inv` (its arithmetic: ``harness/readers.py``)."""
from harness.readers import orchestrator_ms_per_inv as read  # noqa: F401
