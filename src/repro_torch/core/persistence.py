"""Persistent state store (the "Redis in AOF mode" of the paper, §4).

Two implementations behind one interface:

  * ``SimStore`` — used inside the discrete-event simulation. Writes pay a
    serialized fsync latency plus synchronous replication to standbys; this is
    exactly the cost Dirigent keeps OFF the invocation critical path and the
    C3 ablation puts back on it. Two scale features, both default-off and
    bit-identical off:

      - **group commit** (``group_commit=True``): writers that queue behind an
        in-flight fsync are absorbed into one batch and committed by a single
        fsync + one replication round. Every member still consumes its own
        latency draws from the ``persist`` stream, in arrival order, so the
        RNG stays aligned with the serialized path; the batch settles at the
        slowest member's draw, which means a compaction stall on any one
        member holds the whole batch. ``write_many`` is the bulk-append face
        of the same machinery: a 100k-record boot costs O(batches), not
        O(records), of serialized fsync sim-time.
      - **checkpoints** (``checkpoint_enabled=True``): ``write_checkpoint``
        persists a compacted snapshot of the durable prefixes as one
        ``checkpoint/<epoch>`` record and resets the delta; ``read_checkpoint``
        hands recovery the snapshot plus only the post-checkpoint delta, so a
        new leader no longer replays the full ``worker/`` prefix. Snapshot
        bulk-load is costed per record (``snapshot_load_per_record``) and so
        is a full prefix scan (``read_per_record``) — both default 0.0, which
        keeps the legacy flat-latency reads exactly.

  * ``FileStore`` — a real append-only file store (length-prefixed records,
    replay-on-open, torn-tail truncation, log compaction) used by unit tests
    to validate the recovery semantics on an actual medium. ``SimStore``
    checkpoints and the ``FileStore`` log share one record framing
    (``encode_records``/``iter_records``), so the recovery tests validate
    both on the same format.

Keys are namespaced: ``function/<name>``, ``dataplane/<id>``, ``worker/<id>``.
A write with ``value=None`` is a tombstone (delete).
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, Generator, Iterator, List, Optional, Tuple

from repro_torch.simcore import Environment, Resource


_REC_HDR = struct.Struct("<IHI")  # crc32, keylen, vallen (0xFFFFFFFF = tombstone)
_TOMBSTONE = 0xFFFFFFFF

# prefixes a leader checkpoint covers (everything recover_as_leader replays)
CHECKPOINT_PREFIXES = ("function/", "shardmap/", "worker/")


def _encode_record(key: str, value: Optional[bytes]) -> bytes:
    kb = key.encode()
    vb = b"" if value is None else value
    vlen = _TOMBSTONE if value is None else len(vb)
    body = kb + vb
    return _REC_HDR.pack(zlib.crc32(body), len(kb), vlen) + body


def iter_records(buf: bytes) -> Iterator[Tuple[str, Optional[bytes], int]]:
    """Yield ``(key, value_or_None, end_offset)`` per valid record, stopping
    at the first torn (short) or corrupt (bad crc) record — everything past
    that point is crash garbage."""
    off = 0
    while off + _REC_HDR.size <= len(buf):
        crc, klen, vlen = _REC_HDR.unpack_from(buf, off)
        body_off = off + _REC_HDR.size
        real_vlen = 0 if vlen == _TOMBSTONE else vlen
        if body_off + klen + real_vlen > len(buf):
            return  # torn tail write
        body = buf[body_off:body_off + klen + real_vlen]
        if zlib.crc32(body) != crc:
            return  # corrupt tail
        key = body[:klen].decode()
        val = None if vlen == _TOMBSTONE else body[klen:]
        off = body_off + klen + real_vlen
        yield key, val, off


def encode_records(records: Dict[str, bytes]) -> bytes:
    """Compacted snapshot payload: live records only, in the shared record
    framing. Used for ``SimStore`` ``checkpoint/<epoch>`` values and for
    ``FileStore`` log compaction."""
    return b"".join(_encode_record(k, v) for k, v in records.items())


def decode_records(buf: bytes) -> Dict[str, bytes]:
    out: Dict[str, bytes] = {}
    for key, val, _ in iter_records(buf):
        if val is None:
            out.pop(key, None)
        else:
            out[key] = val
    return out


class SimStore:
    """Replicated, strongly-consistent KV store with modeled write latency."""

    def __init__(self, env: Environment, fsync_latency: float,
                 replication_latency: float, read_latency: float,
                 n_replicas: int = 3, fsync_sigma: float = 0.4,
                 stall_prob: float = 0.002, stall: float = 0.120,
                 group_commit: bool = False, max_batch: int = 512,
                 read_per_record: float = 0.0,
                 snapshot_load_per_record: float = 0.0,
                 checkpoint_enabled: bool = False):
        self.env = env
        self.fsync_latency = fsync_latency
        self.replication_latency = replication_latency
        self.read_latency = read_latency
        self.fsync_sigma = fsync_sigma
        self.stall_prob = stall_prob
        self.stall = stall
        self.n_replicas = n_replicas
        self.group_commit = group_commit
        self.max_batch = max_batch
        self.read_per_record = read_per_record
        self.snapshot_load_per_record = snapshot_load_per_record
        self.checkpoint_enabled = checkpoint_enabled
        self.data: Dict[str, bytes] = {}
        # The WAL is serialized: one fsync at a time (the contended resource).
        self._wal = env.resource(capacity=1, name="store-wal")
        self._rng = env.rng("persist")
        # checkpoints draw from their own stream: a background snapshot must
        # not shift the per-write draws, or a checkpoint-on run's entire
        # write history diverges from its checkpoint-off twin and the
        # failover pairs stop being creation-for-creation comparable
        self._ckpt_rng = env.rng("persist-ckpt")
        self.write_count = 0
        self.read_count = 0
        # group-commit machinery + counters (idle unless group_commit)
        self._pending: List[Tuple[str, Optional[bytes], Optional[object]]] = []
        self._committing = False
        self.group_commits = 0
        self.group_commit_writes = 0
        self.last_batch_size = 0
        # checkpoint state: epoch of the latest snapshot and the keys written
        # since (the post-checkpoint delta recovery replays per-record);
        # _ckpt_prev_delta holds the superseded slice while a snapshot fsync
        # is in flight, _ckpt_io serializes checkpoints off the WAL path
        self.checkpoint_epoch = 0
        self.checkpoint_at: Optional[float] = None
        self._ckpt_delta: Dict[str, Optional[bytes]] = {}
        self._ckpt_prev_delta: Optional[Dict[str, Optional[bytes]]] = None
        self._ckpt_io = env.resource(capacity=1, name="store-ckpt-io")

    # -- write paths ----------------------------------------------------------------

    def write(self, key: str, value: Optional[bytes]) -> Generator:
        """Process-style write: ``yield from store.write(k, v)``."""
        if self.group_commit:
            yield from self._write_grouped(key, value)
            return
        yield self._wal.acquire()
        try:
            # real AOF fsync: lognormal latency + rare rewrite/compaction
            # stalls that hold the WAL (the p99-surge mechanism, C3)
            dt = self._rng.lognormal(self.fsync_latency, self.fsync_sigma)
            if self._rng.random() < self.stall_prob:
                dt += self.stall * (0.5 + self._rng.random())
            yield self.env.timeout(dt)
            if self.n_replicas > 1:
                yield self.env.timeout(self.replication_latency)
            self._apply(key, value)
        finally:
            self._wal.release()

    def write_many(self, items: List[Tuple[str, Optional[bytes]]]) -> Generator:
        """Bulk append. With group commit on, commits in ``max_batch`` chunks
        — one fsync + one replication round each — so bulk registration is
        O(batches) of serialized fsync time. With group commit off it
        degrades to the per-record serialized path, bit-identically."""
        if not self.group_commit:
            for key, value in items:
                yield from self.write(key, value)
            return
        if not items:
            return
        # FIFO commit order: the last record's completion implies the whole
        # bulk landed, so one completion event covers the call
        done = self.env.event()
        last = len(items) - 1
        for i, (key, value) in enumerate(items):
            self._pending.append((key, value, done if i == last else None))
        self._kick_committer()
        yield done

    def _write_grouped(self, key: str, value: Optional[bytes]) -> Generator:
        done = self.env.event()
        self._pending.append((key, value, done))
        self._kick_committer()
        yield done

    def _kick_committer(self) -> None:
        if not self._committing:
            self._committing = True
            self.env.process(self._commit_pending(), name="store-group-commit")

    def _commit_pending(self) -> Generator:
        """Batch committer: whoever is queued when the in-flight fsync
        finishes forms the next batch (classic group commit)."""
        yield self._wal.acquire()
        try:
            while self._pending:
                take = min(len(self._pending), self.max_batch)
                batch = self._pending[:take]
                del self._pending[:take]
                yield from self._commit_batch(batch)
        finally:
            # no yield between the emptiness check above and here, so no
            # writer can slip in unobserved before the committer retires
            self._committing = False
            self._wal.release()

    def _commit_batch(self, batch) -> Generator:
        # one fsync covers the whole batch, but every member still consumes
        # its per-write latency draws (same stream, same arrival order as the
        # serialized path); the batch settles at the slowest member's draw,
        # so a stall draw on ANY member holds every write in the batch
        dt = 0.0
        for _ in batch:
            d = self._rng.lognormal(self.fsync_latency, self.fsync_sigma)
            if self._rng.random() < self.stall_prob:
                d += self.stall * (0.5 + self._rng.random())
            if d > dt:
                dt = d
        yield self.env.timeout(dt)
        if self.n_replicas > 1:
            yield self.env.timeout(self.replication_latency)
        for key, value, _done in batch:
            self._apply(key, value)
        self.group_commits += 1
        self.group_commit_writes += len(batch)
        self.last_batch_size = len(batch)
        for _key, _value, done in batch:
            if done is not None:
                done.succeed(None)

    def _apply(self, key: str, value: Optional[bytes]) -> None:
        if value is None:
            self.data.pop(key, None)
        else:
            self.data[key] = value
        if self.checkpoint_enabled and key.startswith(CHECKPOINT_PREFIXES):
            self._ckpt_delta[key] = value
        self.write_count += 1

    # -- checkpoints ----------------------------------------------------------------

    def write_checkpoint(self) -> Generator:
        """Persist a compacted snapshot of the durable prefixes as one
        ``checkpoint/<epoch>`` record. Like a Redis BGSAVE next to the AOF,
        the snapshot runs on its own I/O path (own serialization resource,
        own RNG stream) and never holds the WAL: the single-threaded event
        loop makes the capture atomically consistent at one instant, and
        blocking writers — or even shifting their latency draws — would make
        a checkpoint-on run's entire write history diverge from its
        checkpoint-off twin. While the snapshot fsync is in flight the
        superseded delta is kept (``_ckpt_prev_delta``): a leader recovering
        mid-checkpoint still sees epoch N plus every write since snapshot N
        was captured."""
        yield self._ckpt_io.acquire()
        try:
            # atomic capture: snapshot + delta handoff at one sim instant
            snap = {k: v for k, v in self.data.items()
                    if k.startswith(CHECKPOINT_PREFIXES)}
            payload = encode_records(snap)
            self._ckpt_prev_delta = self._ckpt_delta
            self._ckpt_delta = {}
            dt = self._ckpt_rng.lognormal(self.fsync_latency,
                                          self.fsync_sigma)
            if self._ckpt_rng.random() < self.stall_prob:
                dt += self.stall * (0.5 + self._ckpt_rng.random())
            dt += self.snapshot_load_per_record * len(snap)
            yield self.env.timeout(dt)
            if self.n_replicas > 1:
                yield self.env.timeout(self.replication_latency)
            self.data.pop(f"checkpoint/{self.checkpoint_epoch}", None)
            self.checkpoint_epoch += 1
            self.data[f"checkpoint/{self.checkpoint_epoch}"] = payload
            self.checkpoint_at = self.env.now
            self._ckpt_prev_delta = None
            self.write_count += 1
        finally:
            self._ckpt_io.release()

    def read_checkpoint(self) -> Generator:
        """Recovery entry: ``(snapshot_records, delta)`` or ``None`` when no
        checkpoint exists yet. The snapshot costs ``snapshot_load_per_record``
        per record (bulk deserialization); the delta costs ``read_per_record``
        per record (per-record WAL-suffix scan)."""
        payload = self.data.get(f"checkpoint/{self.checkpoint_epoch}")
        if payload is None:
            yield self.env.timeout(self.read_latency)
            self.read_count += 1
            return None
        snap = decode_records(payload)
        # a checkpoint fsync may be in flight: the live epoch's delta is the
        # superseded slice plus everything written since the new capture
        delta = dict(self._ckpt_prev_delta or {})
        delta.update(self._ckpt_delta)
        yield self.env.timeout(self.read_latency
                               + self.snapshot_load_per_record * len(snap)
                               + self.read_per_record * len(delta))
        self.read_count += 1
        return snap, delta

    # -- reads ----------------------------------------------------------------------

    def read(self, key: str) -> Generator:
        yield self.env.timeout(self.read_latency)
        self.read_count += 1
        return self.data.get(key)

    def read_prefix(self, prefix: str) -> Generator:
        if self.read_per_record:
            # record-count-proportional scan (the honest model a 100k-record
            # ``worker/`` prefix needs); snapshot taken up front so the cost
            # can depend on the result size
            out = {k: v for k, v in self.data.items() if k.startswith(prefix)}
            yield self.env.timeout(self.read_latency
                                   + self.read_per_record * len(out))
            self.read_count += 1
            return out
        yield self.env.timeout(self.read_latency)
        self.read_count += 1
        return {k: v for k, v in self.data.items() if k.startswith(prefix)}

    # Synchronous views for assertions/tests (no cost):
    def peek(self, key: str) -> Optional[bytes]:
        return self.data.get(key)

    def peek_prefix(self, prefix: str) -> Dict[str, bytes]:
        return {k: v for k, v in self.data.items() if k.startswith(prefix)}


class FileStore:
    """Append-only file-backed store with replay-on-open recovery, torn-tail
    truncation, and snapshot compaction (the on-disk mirror of ``SimStore``
    checkpoints, same record framing)."""

    def __init__(self, path: str, fsync: bool = True,
                 compact_on_open: bool = False,
                 compact_threshold: Optional[int] = None):
        self.path = path
        self.fsync = fsync
        self.compact_threshold = compact_threshold
        self.data: Dict[str, bytes] = {}
        self._fh = None
        self._log_bytes = 0
        self.compactions = 0
        if os.path.exists(path):
            self._replay()
        self._live_bytes = sum(self._rec_size(k, v)
                               for k, v in self.data.items())
        if compact_on_open and self._log_bytes > self._live_bytes:
            self.compact()
        else:
            self._fh = open(path, "ab")

    @staticmethod
    def _rec_size(key: str, value: bytes) -> int:
        return _REC_HDR.size + len(key.encode()) + len(value)

    def _replay(self) -> None:
        with open(self.path, "rb") as fh:
            buf = fh.read()
        valid = 0
        for key, val, end in iter_records(buf):
            if val is None:
                self.data.pop(key, None)
            else:
                self.data[key] = val
            valid = end
        if valid < len(buf):
            # torn/corrupt tail: discarding it logically is not enough — the
            # file must shrink to the last valid record, or post-crash
            # appends land *behind* the garbage and silently vanish on the
            # next replay
            with open(self.path, "r+b") as fh:
                fh.truncate(valid)
        self._log_bytes = valid

    def write(self, key: str, value: Optional[bytes]) -> None:
        rec = _encode_record(key, value)
        self._fh.write(rec)
        self._fh.flush()
        if self.fsync:
            os.fsync(self._fh.fileno())
        self._log_bytes += len(rec)
        old = self.data.get(key)
        if old is not None:
            self._live_bytes -= self._rec_size(key, old)
        if value is None:
            self.data.pop(key, None)
        else:
            self.data[key] = value
            self._live_bytes += len(rec)
        if (self.compact_threshold is not None
                and self._log_bytes >= self.compact_threshold
                and self._log_bytes >= 2 * self._live_bytes):
            self.compact()

    def compact(self) -> None:
        """Rewrite the log as a compacted snapshot of the live records
        (tombstones and superseded versions dropped): write-to-temp, fsync,
        atomic rename — a crash leaves either the old or the new log."""
        if self._fh:
            self._fh.close()
            self._fh = None
        payload = encode_records(self.data)
        tmp = self.path + ".compact"
        with open(tmp, "wb") as fh:
            fh.write(payload)
            fh.flush()
            if self.fsync:
                os.fsync(fh.fileno())
        os.replace(tmp, self.path)
        self._fh = open(self.path, "ab")
        self._log_bytes = len(payload)
        self._live_bytes = len(payload)
        self.compactions += 1

    def read(self, key: str) -> Optional[bytes]:
        return self.data.get(key)

    def read_prefix(self, prefix: str) -> Dict[str, bytes]:
        return {k: v for k, v in self.data.items() if k.startswith(prefix)}

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
