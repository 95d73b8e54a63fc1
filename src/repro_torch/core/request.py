"""Invocation records and latency bookkeeping."""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Callable, Optional


class InvocationMode(enum.Enum):
    SYNC = "sync"
    ASYNC = "async"


@dataclass
class LiveRequest:
    """A real inference request riding an invocation in live mode.

    Plain data (prompt in, tokens out) so the core never imports the live
    backend: the DP threads it to ``WorkerDaemon.execute``, which hands it
    to the worker's ``live_backend`` for slot admission + shared decode
    (repro_torch/live/backend.py). ``wall_s`` is the payload wall time billed to
    the sim clock; ``batched_with`` counts how many other requests shared
    at least one decode step in the same replica's batcher slots."""

    prompt: list = field(default_factory=list)     # token ids
    max_new_tokens: int = 16
    # -- filled by the live backend -----------------------------------------
    tokens: Optional[list] = None                  # generated ids
    wall_s: float = 0.0
    batched_with: int = 0
    failed: bool = False
    failure_reason: str = ""


@dataclass
class Invocation:
    inv_id: int
    function_name: str
    arrival: float                 # submit time (client -> front-end LB)
    exec_time: float               # modeled service time on a dedicated node
    mode: InvocationMode = InvocationMode.SYNC
    # live-mode payload: a real callable executed on the worker (examples/)
    payload: Optional[Callable[[], object]] = None
    # live-mode request: real inference dispatched into the target sandbox's
    # replica/batcher by the worker's live backend (preferred over payload —
    # a payload can't know which sandbox the DP picked; a request rides it)
    request: Optional[LiveRequest] = None

    # -- timestamps (filled as the request traverses the system) -----------
    t_dp_arrival: float = -1.0
    t_queued: float = -1.0
    t_dispatch: float = -1.0       # DP picked a sandbox & sent to worker
    t_exec_start: float = -1.0
    t_done: float = -1.0
    cold: bool = False             # waited for a sandbox creation
    failed: bool = False
    failure_reason: str = ""
    retries: int = 0
    result: object = None

    @property
    def e2e_latency(self) -> float:
        return self.t_done - self.arrival

    @property
    def scheduling_latency(self) -> float:
        """End-to-end latency minus pure execution time (paper §5.3)."""
        return self.e2e_latency - self.exec_time

    @property
    def slowdown(self) -> float:
        return self.e2e_latency / max(self.exec_time, 1e-9)
