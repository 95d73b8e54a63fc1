"""Runtime determinism sanitizer for the DES engine (Layer 2 of simlint).

Enabled with ``Environment(sanitize=True)`` (or ``REPRO_SANITIZE=1``), the
sanitizer piggybacks on the engine's existing hooks — it schedules no
events, draws no randomness, and touches no simulation state, so event
counts and goldens are identical with sanitize on or off. Three checks:

* **Lock-order cycle detection.** Every ``Resource.acquire`` requested
  while the current process already holds other resources adds edges
  ``held → requested`` to a global acquisition-order graph; ``reserve``
  holds contribute edges the same way. A cycle means two code paths take
  the same locks in opposite orders — the deadlock/inversion class the
  id-sorted quiesce discipline in ``control_plane.py`` exists to prevent —
  and raises :class:`SanitizeError` at the acquire that closed the cycle.

* **Same-instant tie auditing.** Two different processes touching the same
  ``Resource``/``Store`` at the same sim time are ordered only by heap
  insertion seq — exactly the schedule-sensitive races that break replay
  when unrelated code motion reorders event creation. Ties are *recorded*
  (they are common and often benign: FIFO queueing absorbs most), keyed by
  resource and digit-normalized process names, and surfaced via
  :meth:`Sanitizer.report` so a churn cell can assert on unexpected pairs.

* **RNG discipline.** The global ``random`` / ``np.random`` states are
  snapshotted when ``env.run()`` starts and compared when it returns: any
  in-run draw that bypassed the named ``env.rng(<stream>)`` streams is a
  determinism leak (seeded replay would not reproduce it) and raises
  :class:`SanitizeError`.
"""
from __future__ import annotations

import random as _pyrandom
import re
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np

_DIGITS = re.compile(r"\d+")


class SanitizeError(RuntimeError):
    """A determinism hazard detected by ``Environment(sanitize=True)``."""


class Sanitizer:
    """Attached as ``env.sanitizer``; every hook is a no-op unless the
    environment was built with ``sanitize=True`` (``env.sanitizer`` is
    ``None`` otherwise, and the engine guards each call site)."""

    TIE_EXAMPLE_CAP = 50

    def __init__(self, env: Any):
        self.env = env
        self.current: Any = None          # process being stepped, set by engine
        # lock-acquisition graph: id(resource) -> set of id(resource)
        self._edges: Dict[int, Set[int]] = {}
        self._labels: Dict[int, str] = {}
        self._label_seq = 0
        # per-process held resources (keyed by id(process); entries are
        # dropped when the list empties or the process ends)
        self._held: Dict[int, List[Any]] = {}
        # tie auditor: id(obj) -> (time, ctx identity, ctx name)
        self._last_touch: Dict[int, Tuple[float, Any, str]] = {}
        self.tie_hazards: Dict[Tuple[str, str, str], int] = {}
        self.tie_examples: List[Tuple[float, str, str, str]] = []
        self.lock_cycles: List[str] = []
        self.rng_violations: List[str] = []
        self._rng_snapshot: Optional[tuple] = None

    # -- labels / contexts --------------------------------------------------

    def _label(self, obj: Any) -> str:
        key = id(obj)
        name = self._labels.get(key)
        if name is None:
            explicit = getattr(obj, "name", None)
            if explicit:
                name = str(explicit)
            else:
                self._label_seq += 1
                name = f"{type(obj).__name__}#{self._label_seq}"
            self._labels[key] = name
        return name

    def _ctx(self) -> Tuple[Any, str]:
        """(identity, display name) of the running context. Plain
        ``schedule_at`` callbacks all collapse into one '<callback>'
        context: callback-vs-process ties are caught, callback-vs-callback
        ties are not (they carry no process identity to distinguish)."""
        p = self.current
        if p is None:
            return None, "<callback>"
        return id(p), p.name

    # -- lock-order graph ---------------------------------------------------

    def _find_path(self, src: int, dst: int) -> Optional[List[int]]:
        """DFS path src → dst in the acquisition graph, or None."""
        stack = [(src, [src])]
        seen = {src}
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            for nxt in self._edges.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    def _add_edge(self, a: Any, b: Any) -> None:
        ia, ib = id(a), id(b)
        if ia == ib:
            return
        adj = self._edges.setdefault(ia, set())
        if ib in adj:
            return
        back = self._find_path(ib, ia)
        if back is not None:
            # ``back`` is the established order b -> ... -> a; the requested
            # edge a -> b closes the cycle
            chain = " -> ".join(self._labels.get(n, "?") for n in back)
            _, ctx_name = self._ctx()
            msg = (f"lock-order cycle at t={self.env.now:.6f}: {ctx_name} "
                   f"acquires {self._label(b)} while holding "
                   f"{self._label(a)}, but the order "
                   f"{chain} -> {self._label(b)} was already established — "
                   f"acquire in one global (id-sorted) order")
            self.lock_cycles.append(msg)
            raise SanitizeError(msg)
        adj.add(ib)

    # -- engine hooks -------------------------------------------------------

    def on_acquire(self, res: Any) -> None:
        self._label(res)
        self._touch(res)
        ident, _ = self._ctx()
        if ident is None:
            return
        held = self._held.get(ident)
        if held:
            for h in held:
                self._add_edge(h, res)
            held.append(res)
        else:
            self._held[ident] = [res]

    def on_release(self, res: Any) -> None:
        self._touch(res)
        ident, _ = self._ctx()
        held = self._held.get(ident)
        if held is not None:
            try:
                held.remove(res)
            except ValueError:
                pass
            if not held:
                del self._held[ident]

    def on_reserve(self, res: Any) -> None:
        """A granted lazy hold: orders after whatever the caller holds, but
        is not itself tracked as held (it has no owning process)."""
        self._label(res)
        self._touch(res)
        ident, _ = self._ctx()
        if ident is not None:
            for h in self._held.get(ident, ()):
                self._add_edge(h, res)

    def on_store(self, store: Any) -> None:
        self._touch(store)

    def on_process_end(self, proc: Any) -> None:
        self._held.pop(id(proc), None)

    # -- tie auditor --------------------------------------------------------

    def _touch(self, obj: Any) -> None:
        t = self.env.now
        ident, name = self._ctx()
        key = id(obj)
        last = self._last_touch.get(key)
        self._last_touch[key] = (t, ident, name)
        if last is not None and last[0] == t and last[1] != ident:
            label = self._label(obj)
            pair = tuple(sorted((_DIGITS.sub("#", last[2]),
                                 _DIGITS.sub("#", name))))
            k = (label, pair[0], pair[1])
            self.tie_hazards[k] = self.tie_hazards.get(k, 0) + 1
            if len(self.tie_examples) < self.TIE_EXAMPLE_CAP:
                self.tie_examples.append((t, label, last[2], name))

    # -- RNG discipline -----------------------------------------------------

    @staticmethod
    def _rng_state() -> tuple:
        py = _pyrandom.getstate()
        kind, keys, pos, has_gauss, cached = np.random.get_state()
        return (py, kind, keys.tobytes(), pos, has_gauss, cached)

    def begin_run(self) -> None:
        self._rng_snapshot = self._rng_state()

    def end_run(self) -> None:
        snap, self._rng_snapshot = self._rng_snapshot, None
        if snap is None:
            return
        if self._rng_state() != snap:
            msg = (f"global RNG state changed during run (observed at "
                   f"t={self.env.now:.6f}): some code drew from the global "
                   f"random/np.random state instead of a named "
                   f"env.rng(<stream>) — seeded replay will not reproduce it")
            self.rng_violations.append(msg)
            raise SanitizeError(msg)

    # -- reporting ----------------------------------------------------------

    def report(self) -> Dict[str, Any]:
        """Summary for tests/CI: counts, not objects, so it prints cleanly."""
        return {
            "lock_edges": sum(len(v) for v in self._edges.values()),
            "lock_cycles": list(self.lock_cycles),
            "tie_hazards": {f"{r} :: {a} <> {b}": n
                            for (r, a, b), n in sorted(self.tie_hazards.items())},
            "tie_example_count": len(self.tie_examples),
            "rng_violations": list(self.rng_violations),
        }
