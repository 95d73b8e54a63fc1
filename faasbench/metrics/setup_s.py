"""The metric `setup_s` (its arithmetic: ``harness/readers.py``)."""
from harness.readers import setup_s as read  # noqa: F401
