"""The metric `device_idle_share` (its arithmetic: ``harness/readers.py``)."""
from harness.readers import device_idle_share as read  # noqa: F401
