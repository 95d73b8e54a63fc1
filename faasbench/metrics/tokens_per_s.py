"""The metric `tokens_per_s` (its arithmetic: ``harness/readers.py``)."""
from harness.readers import tokens_per_s as read  # noqa: F401
