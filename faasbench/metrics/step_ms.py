"""The metric `step_ms` (its arithmetic: ``harness/readers.py``)."""
from harness.readers import step_ms as read  # noqa: F401
