"""The metric `decode_attention_roofline` (its arithmetic: ``harness/readers.py``)."""
from harness.readers import decode_attention_roofline as read  # noqa: F401
