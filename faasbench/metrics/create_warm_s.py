"""The metric `create_warm_s` (its arithmetic: ``harness/program_spans.py``)."""
from harness.program_spans import create_warm_s as read  # noqa: F401
