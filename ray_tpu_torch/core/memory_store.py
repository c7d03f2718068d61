"""In-process object store for small / inlined results.

Equivalent of the reference's CoreWorkerMemoryStore
(reference: src/ray/core_worker/store_provider/memory_store/memory_store.h):
holds deserialized values keyed by ObjectID, wakes blocked getters, and fires
async callbacks registered before the value arrived.  Values larger than the
inline threshold never land here — they go to the node's shared-memory store
(ray_tpu_torch/core/object_store.py) and this store holds only a location stub.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Set

from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.devtools.lock_debug import make_lock
from ray_tpu_torch.exceptions import GetTimeoutError


class _Record:
    __slots__ = ("value", "is_exception", "in_plasma")

    def __init__(self, value: Any, is_exception: bool = False, in_plasma: bool = False):
        self.value = value
        self.is_exception = is_exception
        self.in_plasma = in_plasma


class PlasmaStub:
    """Marker stored here when the real bytes live in the shm store."""

    __slots__ = ("object_id",)

    def __init__(self, object_id: ObjectID):
        self.object_id = object_id


class MemoryStore:
    def __init__(self):

        self._lock = make_lock("memory_store._lock")
        self._cv = threading.Condition(self._lock)
        self._objects: Dict[ObjectID, _Record] = {}
        self._callbacks: Dict[ObjectID, List[Callable[[_Record], None]]] = {}

    def put(self, object_id: ObjectID, value: Any, is_exception: bool = False) -> None:
        with self._cv:
            if object_id in self._objects:
                return  # idempotent: retries may double-store
            rec = _Record(value, is_exception, isinstance(value, PlasmaStub))
            self._objects[object_id] = rec
            callbacks = self._callbacks.pop(object_id, [])
            self._cv.notify_all()
        for cb in callbacks:
            try:
                cb(rec)
            except Exception:
                # One broken callback (e.g. a cancelled future) must not
                # crash the delivery thread or strand later callbacks.
                pass

    def put_batch(self, items) -> None:
        """items: [(object_id, value, is_exception)]. One lock acquisition
        and one notify_all for a whole completion batch — per-put wakeups
        were a measurable tax at high completion rates."""
        fire: List[tuple] = []
        with self._cv:
            for object_id, value, is_exception in items:
                if object_id in self._objects:
                    continue  # idempotent: retries may double-store
                rec = _Record(value, is_exception,
                              isinstance(value, PlasmaStub))
                self._objects[object_id] = rec
                cbs = self._callbacks.pop(object_id, None)
                if cbs:
                    fire.append((cbs, rec))
            self._cv.notify_all()
        for cbs, rec in fire:
            for cb in cbs:
                try:
                    cb(rec)
                except Exception:
                    # A failing callback must not abort the rest of the
                    # batch — unrelated waiters would hang forever.
                    pass

    def contains(self, object_id: ObjectID) -> bool:
        with self._lock:
            return object_id in self._objects

    def get_async(self, object_id: ObjectID, callback: Callable[[_Record], None]) -> None:
        with self._lock:
            rec = self._objects.get(object_id)
            if rec is None:
                self._callbacks.setdefault(object_id, []).append(callback)
                return
        callback(rec)

    def remove_callback(self, object_id: ObjectID,
                        callback: Callable[[_Record], None]) -> None:
        """Deregister a pending get_async callback (e.g. wait() timed out):
        without this, poll-style wait loops would accumulate one closure per
        call until the object finally arrives."""
        with self._lock:
            cbs = self._callbacks.get(object_id)
            if cbs is not None:
                try:
                    cbs.remove(callback)
                except ValueError:
                    pass
                if not cbs:
                    del self._callbacks[object_id]

    def get(
        self,
        object_ids: List[ObjectID],
        timeout: Optional[float] = None,
    ) -> List[_Record]:
        deadline = None if timeout is None else time.monotonic() + timeout
        records: List[_Record] = []
        with self._cv:
            for oid in object_ids:
                while oid not in self._objects:
                    remaining = None if deadline is None else deadline - time.monotonic()
                    if remaining is not None and remaining <= 0:
                        raise GetTimeoutError(f"timed out waiting for {oid}")
                    self._cv.wait(timeout=remaining)
                records.append(self._objects[oid])
        return records

    def wait(
        self,
        object_ids: List[ObjectID],
        num_returns: int,
        timeout: Optional[float],
        return_all: bool = False,
    ) -> Set[ObjectID]:
        """Returns the set of ready ids (>= num_returns unless timeout).
        With ``return_all``, once the threshold is met the whole list is
        scored (batch long-poll servers want every ready id per wake)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while True:
                # Early-exit scan: a wake only needs to find num_returns
                # ready ids, not score the whole list (pop-1-of-1k wait
                # loops re-scan on every put_batch wake otherwise).
                ready = set()
                objs = self._objects
                for oid in object_ids:
                    if oid in objs:
                        ready.add(oid)
                        if len(ready) >= num_returns and not return_all:
                            return ready
                if len(ready) >= num_returns:
                    return ready
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return ready
                self._cv.wait(timeout=remaining)

    def objects_view(self):
        """The live id->record dict for GIL-atomic membership probes (the
        wait() hot path fuses readiness into its validation pass; callers
        must only do `in` checks, never read values or iterate)."""
        return self._objects

    def delete(self, object_ids: List[ObjectID]) -> List[ObjectID]:
        """Returns the subset whose record was MEMORY-RESIDENT (present
        and not a plasma stub): a released small result needs no shm-store
        delete / unlink syscalls — the caller can skip them (hot on the
        task-release path: every small task return pays this)."""
        memory_only: List[ObjectID] = []
        with self._lock:
            for oid in object_ids:
                rec = self._objects.pop(oid, None)
                self._callbacks.pop(oid, None)
                if rec is not None and not rec.in_plasma:
                    memory_only.append(oid)
        return memory_only

    def size(self) -> int:
        with self._lock:
            return len(self._objects)
