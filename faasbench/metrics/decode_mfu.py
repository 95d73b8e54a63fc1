"""The metric `decode_mfu` (its arithmetic: ``harness/readers.py``)."""
from harness.readers import decode_mfu as read  # noqa: F401
