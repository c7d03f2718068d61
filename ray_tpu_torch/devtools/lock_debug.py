"""Runtime lock-order witness (``RTPU_DEBUG_LOCKS=1``).

The cluster core creates its locks through :func:`make_lock` /
:func:`make_rlock`. Normally these return plain ``threading`` locks —
zero overhead. With ``RTPU_DEBUG_LOCKS=1`` in the environment (workers
inherit it from the driver) every named lock is wrapped in a witness
that:

- records the per-thread acquisition graph: an edge ``A -> B`` means
  some thread acquired ``B`` while holding ``A``. Edges are keyed by
  lock NAME, not instance, so the graph stays O(lock classes) and an
  ordering decision made on one connection's ``send_lock`` generalizes
  to all of them. Cross-instance edges between two locks of the SAME
  name are ignored (two actor connections' locks nesting is not an
  ordering fact).
- detects ordering cycles ONLINE: the first edge that closes a cycle
  (``A -> ... -> A``) is reported to stderr once and recorded for
  :func:`get_report` — the witness sees the deadlock *potential* from
  the two halves of an inversion even when the schedule never actually
  deadlocks.
- reports a same-thread re-acquire of a non-reentrant lock (guaranteed
  self-deadlock) before blocking on it.
- measures hold times: a lock held longer than
  ``RTPU_DEBUG_LOCKS_HOLD_S`` (default 1.0s) is recorded and counted on
  the ``rtpu_debug_lock_hold_exceeded`` metric (util/metrics), labelled
  by lock name.

The wrapper implements the private ``Condition`` integration surface
(``_release_save`` / ``_acquire_restore`` / ``_is_owned``) so
``threading.Condition(make_rlock(...))`` works unchanged; a
``Condition.wait`` fully releases the witness's hold bookkeeping and
restarts the hold timer on wakeup (time parked in ``wait`` is not
"holding" time).
"""

from __future__ import annotations

import os
import threading
import time
import traceback
from typing import Dict, List, Optional, Set, Tuple


def enabled() -> bool:
    return os.environ.get("RTPU_DEBUG_LOCKS", "") == "1"


def hold_threshold_s() -> float:
    try:
        return float(os.environ.get("RTPU_DEBUG_LOCKS_HOLD_S", "1.0"))
    except ValueError:
        return 1.0


def _site() -> str:
    """file:line of the nearest frame outside this module."""
    try:
        for f in reversed(traceback.extract_stack()):
            if os.path.basename(f.filename) != "lock_debug.py":
                return f"{os.path.basename(f.filename)}:{f.lineno}"
    except Exception:  # noqa: BLE001 — diagnostics only
        pass
    return "?"


class _Witness:
    """Process-global acquisition graph + per-thread held stacks."""

    def __init__(self):
        self._mu = threading.Lock()  # guards the graph, NOT a DebugLock
        self._edges: Dict[str, Set[str]] = {}
        self._edge_sites: Dict[Tuple[str, str], str] = {}
        self._cycles: List[dict] = []
        self._cycle_keys: Set[tuple] = set()
        self._long_holds: List[dict] = []
        self._tls = threading.local()

    # ------------------------------------------------------- per thread

    def _held(self) -> list:
        h = getattr(self._tls, "held", None)
        if h is None:
            h = self._tls.held = []  # [lock, name, count, t_acquired]
        return h

    # ----------------------------------------------------------- events

    def on_attempt(self, lock, name: str, reentrant: bool,
                   will_block: bool) -> None:
        """Dependency edges are recorded on the ATTEMPT (lockdep
        semantics): a thread holding A that merely TRIES to acquire B
        establishes A->B — which is how an actual in-progress deadlock
        (where neither second acquire ever succeeds) still closes the
        cycle online."""
        held = self._held()
        for entry in held:
            if entry[0] is lock:
                if not reentrant and will_block:
                    self._record_cycle(
                        [name, name],
                        f"self-deadlock: thread "
                        f"{threading.current_thread().name} re-acquires "
                        f"non-reentrant '{name}' at {_site()}")
                return  # re-entry adds no new dependency
        for entry in held:
            if entry[1] != name:
                self._add_edge(entry[1], name)

    def on_acquired(self, lock, name: str) -> None:
        held = self._held()
        for entry in held:
            if entry[0] is lock:
                entry[2] += 1
                return
        held.append([lock, name, 1, time.monotonic()])

    def on_released(self, lock, name: str) -> None:
        held = self._held()
        for i, entry in enumerate(held):
            if entry[0] is lock:
                entry[2] -= 1
                if entry[2] <= 0:
                    del held[i]
                    self._note_hold(name, time.monotonic() - entry[3])
                return

    def drop_for_wait(self, lock) -> Optional[list]:
        """Condition.wait released the lock out from under us: clear the
        bookkeeping and hand back the entry for restore."""
        held = self._held()
        for i, entry in enumerate(held):
            if entry[0] is lock:
                del held[i]
                return entry
        return None

    def restore_after_wait(self, entry: Optional[list]) -> None:
        if entry is not None:
            entry[3] = time.monotonic()  # waiting is not holding
            self._held().append(entry)

    # ------------------------------------------------------------ graph

    def _add_edge(self, a: str, b: str) -> None:
        with self._mu:
            peers = self._edges.setdefault(a, set())
            if b in peers:
                return
            peers.add(b)
            self._edge_sites[(a, b)] = _site()
            path = self._find_path(b, a)
        if path is not None:
            chain = [a] + path
            self._record_cycle(
                chain,
                f"lock-order cycle {' -> '.join(chain)} (edge {a}->{b} "
                f"at {self._edge_sites.get((a, b), '?')}, thread "
                f"{threading.current_thread().name})")

    def _find_path(self, src: str, dst: str) -> Optional[List[str]]:
        """DFS path src..dst through the edge graph (caller holds _mu)."""
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

    def _record_cycle(self, chain: List[str], message: str) -> None:
        key = tuple(sorted(set(chain)))
        with self._mu:
            if key in self._cycle_keys:
                return
            self._cycle_keys.add(key)
            self._cycles.append({"chain": list(chain),
                                 "message": message})
        print(f"RTPU_DEBUG_LOCKS: {message}", flush=True)

    # ------------------------------------------------------- hold times

    def _note_hold(self, name: str, seconds: float) -> None:
        if seconds <= hold_threshold_s():
            return
        with self._mu:
            self._long_holds.append({
                "lock": name, "seconds": seconds,
                "thread": threading.current_thread().name})
            if len(self._long_holds) > 256:
                del self._long_holds[0]
        try:
            from ray_tpu_torch.util import metrics as _metrics

            m = _metrics.get_metric("rtpu_debug_lock_hold_exceeded")
            if m is None:
                m = _metrics.Counter(
                    "rtpu_debug_lock_hold_exceeded",
                    "lock holds exceeding RTPU_DEBUG_LOCKS_HOLD_S")
            m.inc(labels={"lock": name})
        except Exception:  # noqa: BLE001 — diagnostics must never kill
            pass

    # ---------------------------------------------------------- reports

    def report(self) -> dict:
        with self._mu:
            return {
                "cycles": [dict(c) for c in self._cycles],
                "edges": {a: sorted(bs)
                          for a, bs in sorted(self._edges.items())},
                "long_holds": [dict(h) for h in self._long_holds],
            }

    def reset(self) -> None:
        with self._mu:
            self._edges.clear()
            self._edge_sites.clear()
            self._cycles.clear()
            self._cycle_keys.clear()
            self._long_holds.clear()


_WITNESS = _Witness()


class DebugLock:
    """Witness-wrapped lock. Supports the full Lock/RLock surface plus
    the private Condition integration hooks."""

    __slots__ = ("_name", "_inner", "_reentrant")

    def __init__(self, name: str, inner, reentrant: bool):
        self._name = name
        self._inner = inner
        self._reentrant = reentrant

    # -------------------------------------------------- Lock protocol

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        _WITNESS.on_attempt(self, self._name, self._reentrant,
                            will_block=blocking and timeout < 0)
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            _WITNESS.on_acquired(self, self._name)
        return ok

    def release(self) -> None:
        self._inner.release()
        _WITNESS.on_released(self, self._name)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> "DebugLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<DebugLock {self._name} {self._inner!r}>"

    # --------------------------------------- Condition integration

    def _release_save(self):
        entry = _WITNESS.drop_for_wait(self)
        if hasattr(self._inner, "_release_save"):
            state = self._inner._release_save()
        else:
            self._inner.release()
            state = None
        return (state, entry)

    def _acquire_restore(self, saved) -> None:
        state, entry = saved
        if hasattr(self._inner, "_acquire_restore"):
            self._inner._acquire_restore(state)
        else:
            self._inner.acquire()
        _WITNESS.restore_after_wait(entry)

    def _is_owned(self) -> bool:
        if hasattr(self._inner, "_is_owned"):
            return self._inner._is_owned()
        # Plain Lock: mirror Condition's probe, against the INNER lock
        # so the witness doesn't see the probe as an acquisition.
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True


def make_lock(name: str):
    """A ``threading.Lock()`` — witness-wrapped under RTPU_DEBUG_LOCKS=1.
    ``name`` identifies the lock CLASS (module.attr), shared by every
    instance created at this site."""
    if enabled():
        return DebugLock(name, threading.Lock(), reentrant=False)
    return threading.Lock()


def make_rlock(name: str):
    """A ``threading.RLock()`` — witness-wrapped under
    RTPU_DEBUG_LOCKS=1."""
    if enabled():
        return DebugLock(name, threading.RLock(), reentrant=True)
    return threading.RLock()


def get_report() -> dict:
    """{"cycles": [...], "edges": {name: [names]}, "long_holds": [...]}
    accumulated since process start / the last reset()."""
    return _WITNESS.report()


def reset() -> None:
    """Clear the witness (tests isolate scenarios with this)."""
    _WITNESS.reset()
