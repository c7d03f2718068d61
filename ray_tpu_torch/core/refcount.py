"""Reference counting for object lifetimes (``ray_tpu/core/refcount.py``,
the owner's side only: one process owns every object, so the borrower
protocol and lineage pins of the cluster runtime are left out).

Equivalent of the reference's ReferenceCounter (reference:
src/ray/core_worker/reference_count.h): the owner tracks
  - local refs      (ObjectRef instances alive in the process),
  - submitted refs  (pending tasks that take the object as an argument),
and releases the value from the store when both reach zero.
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, Dict, Optional

from ray_tpu_torch.core.ids import ObjectID


class _Ref:
    __slots__ = ("local", "submitted", "owned")

    def __init__(self, owned: bool):
        self.local = 0
        self.submitted = 0
        self.owned = owned

    def out_of_scope(self) -> bool:
        return self.local <= 0 and self.submitted <= 0


class ReferenceCounter:
    def __init__(self, on_release: Optional[Callable[[ObjectID], None]] = None):
        self._lock = threading.Lock()
        self._refs: Dict[ObjectID, _Ref] = {}
        self._on_release = on_release
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

    def add_owned_object(self, oid: ObjectID) -> None:
        self.flush_deferred()
        with self._lock:
            ref = self._refs.setdefault(oid, _Ref(owned=True))
            ref.owned = True

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
        release = None
        with self._lock:
            ref = self._refs.get(oid)
            if ref is None:
                return
            ref.submitted -= 1
            release = self._maybe_release_locked(oid, ref)
        if release:
            release()

    def is_in_scope(self, oid: ObjectID) -> bool:
        with self._lock:
            ref = self._refs.get(oid)
            return ref is not None and not ref.out_of_scope()

    def _maybe_release_locked(self, oid: ObjectID, ref: _Ref):
        if not ref.out_of_scope():
            return None
        del self._refs[oid]
        if ref.owned and self._on_release:
            cb = self._on_release
            return lambda: cb(oid)
        return None
