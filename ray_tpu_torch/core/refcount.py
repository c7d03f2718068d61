"""Distributed reference counting for object lifetimes.

Equivalent of the reference's ReferenceCounter (reference:
src/ray/core_worker/reference_count.h): every object has exactly one owner
(the worker whose task created it or that called put); the owner tracks
  - local refs      (ObjectRef instances alive in the owner process),
  - submitted refs  (pending tasks that take the object as an argument),
  - borrower refs   (other workers holding deserialized copies of the ref),
and releases the value from the store when all three reach zero.  Borrowers
report their local count reaching zero back to the owner asynchronously
(mirrors the reference's WaitForRefRemoved long-poll protocol, simplified to a
single release message over the control plane).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Set

from ray_tpu_torch.core.ids import ObjectID


class _Ref:
    __slots__ = ("local", "submitted", "borrowers", "owned", "lineage_pinned")

    def __init__(self, owned: bool):
        self.local = 0
        self.submitted = 0
        self.borrowers: Set[str] = set()
        self.owned = owned
        self.lineage_pinned = False

    def out_of_scope(self) -> bool:
        return self.local <= 0 and self.submitted <= 0 and not self.borrowers


class ReferenceCounter:
    def __init__(self, on_release: Optional[Callable[[ObjectID], None]] = None,
                 on_borrow_release: Optional[Callable[[ObjectID],
                                                      None]] = None):
        import collections

        self._lock = threading.Lock()
        self._refs: Dict[ObjectID, _Ref] = {}
        self._on_release = on_release
        # Fires when a BORROWED (non-owned) ref goes out of scope in this
        # process: the borrower's half of the WaitForRefRemoved protocol —
        # without it the owner pins every borrowed object forever.
        self._on_borrow_release = on_borrow_release
        self.enabled = True
        # ObjectRef.__del__ may run INSIDE a locked section of this very
        # counter (any allocation under the lock can trigger GC, which
        # collects refs whose __del__ re-enters here — a guaranteed
        # self-deadlock on a plain Lock). Finalizers therefore never take
        # the lock: they append to this queue (deque.append is atomic) and
        # decrements are applied by the next normal-context operation.
        self._deferred: "collections.deque" = collections.deque()

    def _apply_deferred_locked(self) -> list:
        """Caller holds the lock. Returns release callbacks to run after
        the lock is dropped."""
        releases = []
        while self._deferred:
            try:
                oid = self._deferred.popleft()
            except IndexError:
                break
            ref = self._refs.get(oid)
            if ref is None:
                continue
            ref.local -= 1
            cb = self._maybe_release_locked(oid, ref)
            if cb:
                releases.append(cb)
        return releases

    def flush_deferred(self) -> None:
        """Apply queued finalizer decrements (called from normal contexts:
        periodic sweeps and every counter operation)."""
        if not self._deferred:
            return
        with self._lock:
            releases = self._apply_deferred_locked()
        for cb in releases:
            cb()

    # --- owner-side ---

    def add_owned_object(self, oid: ObjectID) -> None:
        self.flush_deferred()
        with self._lock:
            ref = self._refs.setdefault(oid, _Ref(owned=True))
            ref.owned = True

    def drop_owned_object(self, oid: ObjectID) -> None:
        """Owner-side FORCED release (e.g. abandoned-stream items that no
        ObjectRef was ever minted for): removes the record and fires the
        release hook so stored bytes free immediately."""
        self.flush_deferred()
        with self._lock:
            ref = self._refs.pop(oid, None)
        if ref is not None and self._on_release is not None:
            try:
                self._on_release(oid)
            except Exception:
                pass

    def add_local_ref(self, oid: ObjectID) -> None:
        if not self.enabled:
            return
        self.flush_deferred()
        with self._lock:
            self._refs.setdefault(oid, _Ref(owned=False)).local += 1

    def remove_local_ref(self, oid: ObjectID) -> None:
        """Finalizer-safe: runs from ObjectRef.__del__ (possibly mid-GC
        inside our own locked section, or inside ANY other subsystem's
        lock), so it must not take locks or do IO — enqueue only; the next
        normal-context counter operation or periodic sweep applies it."""
        if not self.enabled:
            return
        self._deferred.append(oid)

    def add_submitted_task_ref(self, oid: ObjectID) -> None:
        if not self.enabled:
            return
        self.flush_deferred()
        with self._lock:
            self._refs.setdefault(oid, _Ref(owned=False)).submitted += 1

    def remove_submitted_task_ref(self, oid: ObjectID) -> None:
        if not self.enabled:
            return
        self.flush_deferred()
        self._dec(oid, "submitted")

    def add_borrower(self, oid: ObjectID, borrower_addr: str) -> None:
        with self._lock:
            self._refs.setdefault(oid, _Ref(owned=True)).borrowers.add(borrower_addr)

    def remove_borrower(self, oid: ObjectID, borrower_addr: str) -> None:
        release = None
        with self._lock:
            ref = self._refs.get(oid)
            if ref is None:
                return
            ref.borrowers.discard(borrower_addr)
            release = self._maybe_release_locked(oid, ref)
        if release:
            release()

    def pin_lineage(self, oid: ObjectID) -> None:
        with self._lock:
            ref = self._refs.get(oid)
            if ref:
                ref.lineage_pinned = True

    def local_count(self, oid: ObjectID) -> int:
        with self._lock:
            ref = self._refs.get(oid)
            return ref.local if ref else 0

    def num_tracked(self) -> int:
        with self._lock:
            return len(self._refs)

    def tracked_ids(self) -> Set[ObjectID]:
        with self._lock:
            return set(self._refs)

    def is_in_scope(self, oid: ObjectID) -> bool:
        with self._lock:
            ref = self._refs.get(oid)
            return ref is not None and not ref.out_of_scope()

    # --- internals ---

    def _dec(self, oid: ObjectID, kind: str) -> None:
        release = None
        with self._lock:
            ref = self._refs.get(oid)
            if ref is None:
                return
            if kind == "local":
                ref.local -= 1
            else:
                ref.submitted -= 1
            release = self._maybe_release_locked(oid, ref)
        if release:
            release()

    def _maybe_release_locked(self, oid: ObjectID, ref: _Ref):
        if not ref.out_of_scope():
            return None
        del self._refs[oid]
        if ref.owned and self._on_release:
            cb = self._on_release
            return lambda: cb(oid)
        if not ref.owned and self._on_borrow_release is not None:
            cb = self._on_borrow_release
            return lambda: cb(oid)
        return None
