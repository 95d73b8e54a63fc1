"""Live execution mode: real PyTorch payloads behind the Dirigent orchestrator.

The DES stays the source of truth for orchestration latency; this package
supplies the *payload* side — per-sandbox replicas executing real inference
on the DP invoke path.
"""
from repro_torch.live.backend import LiveBackend, LiveFunctionSpec, LiveTicket

__all__ = ["LiveBackend", "LiveFunctionSpec", "LiveTicket"]
