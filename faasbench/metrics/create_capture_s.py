"""The metric `create_capture_s` (its arithmetic: ``harness/program_spans.py``)."""
from harness.program_spans import create_capture_s as read  # noqa: F401
