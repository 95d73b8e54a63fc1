"""Dirigent's four cluster-management abstractions (paper §3.2, Table 3).

The control plane orchestrates exactly four object kinds:

  * ``Function``   — user-registered recipe for sandboxes (persisted, except
                     scheduling *metrics* which are reconstructible from DP
                     traffic);
  * ``Sandbox``    — a running instance on a worker node (NOT persisted;
                     reconstructible from worker nodes). Serialized state is
                     16 bytes (vs ≈17 KB for a K8s Pod object);
  * ``DataPlane``  — a data-plane replica endpoint (persisted);
  * ``WorkerNode`` — a worker daemon endpoint (persisted).

The binary codec below is the literal "16 bytes per sandbox" artifact: the
tests assert ``len(sandbox.to_bytes()) == 16`` and round-tripping.
"""
from __future__ import annotations

import enum
import struct
from dataclasses import dataclass, field
from typing import Optional


class SandboxState(enum.IntEnum):
    CREATING = 0
    READY = 1
    DRAINING = 2
    TERMINATING = 3


# -- Function ---------------------------------------------------------------


@dataclass
class ScalingConfig:
    """Per-function autoscaling knobs (Knative-default policy, paper §4)."""

    target_concurrency: float = 1.0   # sandboxes process 1 request at a time
    stable_window: float = 60.0       # seconds
    panic_window: float = 6.0         # seconds
    panic_threshold: float = 2.0      # panic if desired >= 2x ready
    scale_to_zero_grace: float = 30.0  # seconds of zero concurrency
    max_scale: int = 10_000
    cpu_req_millis: int = 250          # placement resource request
    mem_req_mb: int = 256


@dataclass
class FunctionMetrics:
    """Scheduling metrics — in-memory only, never persisted (Table 3)."""

    inflight: int = 0                 # executing + queued, cluster-wide
    total_invocations: int = 0
    cold_starts: int = 0

    def snapshot(self) -> dict:
        return {
            "inflight": self.inflight,
            "total_invocations": self.total_invocations,
            "cold_starts": self.cold_starts,
        }


@dataclass
class Function:
    name: str
    image_url: str
    port: int
    scaling: ScalingConfig = field(default_factory=ScalingConfig)
    # in-memory only:
    metrics: FunctionMetrics = field(default_factory=FunctionMetrics)

    def persisted_record(self) -> bytes:
        """Binary record persisted on registration (excludes metrics)."""
        name_b = self.name.encode()
        url_b = self.image_url.encode()
        s = self.scaling
        return struct.pack(
            f"<H{len(name_b)}sH{len(url_b)}sHfffffIHH",
            len(name_b), name_b, len(url_b), url_b, self.port,
            s.target_concurrency, s.stable_window, s.panic_window,
            s.panic_threshold, s.scale_to_zero_grace, s.max_scale,
            s.cpu_req_millis, s.mem_req_mb,
        )

    @staticmethod
    def from_record(buf: bytes) -> "Function":
        off = 0
        (nlen,) = struct.unpack_from("<H", buf, off); off += 2
        name = buf[off:off + nlen].decode(); off += nlen
        (ulen,) = struct.unpack_from("<H", buf, off); off += 2
        url = buf[off:off + ulen].decode(); off += ulen
        (port, tc, sw, pw, pt, g, ms, cpu, mem) = struct.unpack_from(
            "<HfffffIHH", buf, off)
        return Function(
            name=name, image_url=url, port=port,
            scaling=ScalingConfig(
                target_concurrency=tc, stable_window=sw, panic_window=pw,
                panic_threshold=pt, scale_to_zero_grace=g, max_scale=ms,
                cpu_req_millis=cpu, mem_req_mb=mem,
            ),
        )


# -- Sandbox ------------------------------------------------------------------

_SANDBOX_FMT = "<I4sHIBx"  # id, ipv4, port, worker_id, state, pad  == 16 bytes
assert struct.calcsize(_SANDBOX_FMT) == 16


@dataclass
class Sandbox:
    """A sandbox instance. 16-byte binary state (paper §3.2)."""

    sandbox_id: int
    function_name: str        # implied by the per-function table it lives in
    ip: tuple[int, int, int, int]
    port: int
    worker_id: int
    state: SandboxState = SandboxState.CREATING

    def to_bytes(self) -> bytes:
        return struct.pack(
            _SANDBOX_FMT, self.sandbox_id, bytes(self.ip), self.port,
            self.worker_id, int(self.state),
        )

    @staticmethod
    def from_bytes(buf: bytes, function_name: str = "") -> "Sandbox":
        sid, ip, port, wid, state = struct.unpack(_SANDBOX_FMT, buf)
        return Sandbox(
            sandbox_id=sid, function_name=function_name,
            ip=tuple(ip), port=port, worker_id=wid,
            state=SandboxState(state),
        )

    @property
    def key(self) -> str:
        return f"{self.function_name}/{self.sandbox_id}"


# -- DataPlane / WorkerNode ----------------------------------------------------


@dataclass
class DataPlaneInfo:
    dp_id: int
    ip: tuple[int, int, int, int]
    port: int

    def persisted_record(self) -> bytes:
        return struct.pack("<I4sH", self.dp_id, bytes(self.ip), self.port)

    @staticmethod
    def from_record(buf: bytes) -> "DataPlaneInfo":
        dp_id, ip, port = struct.unpack("<I4sH", buf)
        return DataPlaneInfo(dp_id=dp_id, ip=tuple(ip), port=port)


@dataclass
class WorkerNodeInfo:
    worker_id: int
    name: str
    ip: tuple[int, int, int, int]
    port: int
    cpu_capacity_millis: int = 10_000
    mem_capacity_mb: int = 64_000

    def persisted_record(self) -> bytes:
        name_b = self.name.encode()
        return struct.pack(
            f"<IH{len(name_b)}s4sHII", self.worker_id, len(name_b), name_b,
            bytes(self.ip), self.port, self.cpu_capacity_millis,
            self.mem_capacity_mb,
        )

    @staticmethod
    def from_record(buf: bytes) -> "WorkerNodeInfo":
        off = 0
        (wid, nlen) = struct.unpack_from("<IH", buf, off); off += 6
        name = buf[off:off + nlen].decode(); off += nlen
        ip, port, cpu, mem = struct.unpack_from("<4sHII", buf, off)
        return WorkerNodeInfo(
            worker_id=wid, name=name, ip=tuple(ip), port=port,
            cpu_capacity_millis=cpu, mem_capacity_mb=mem,
        )
