"""In-process object store (``ray_tpu/core/memory_store.py``, without the
cluster runtime's shm-store stubs and batch puts).

Equivalent of the reference's CoreWorkerMemoryStore
(reference: src/ray/core_worker/store_provider/memory_store/memory_store.h):
holds values keyed by ObjectID, wakes blocked getters, and fires async
callbacks registered before the value arrived. In the local runtime every
value lives here.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Set

from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.exceptions import GetTimeoutError


class _Record:
    __slots__ = ("value", "is_exception")

    def __init__(self, value: Any, is_exception: bool = False):
        self.value = value
        self.is_exception = is_exception


class MemoryStore:
    def __init__(self):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._objects: Dict[ObjectID, _Record] = {}
        self._callbacks: Dict[ObjectID, List[Callable[[_Record], None]]] = {}

    def put(self, object_id: ObjectID, value: Any, is_exception: bool = False) -> None:
        with self._cv:
            if object_id in self._objects:
                return  # idempotent: retries may double-store
            rec = _Record(value, is_exception)
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

    def get_async(self, object_id: ObjectID, callback: Callable[[_Record], None]) -> None:
        with self._lock:
            rec = self._objects.get(object_id)
            if rec is None:
                self._callbacks.setdefault(object_id, []).append(callback)
                return
        callback(rec)

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
    ) -> Set[ObjectID]:
        """Returns the set of ready ids (>= num_returns unless timeout)."""
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
                        if len(ready) >= num_returns:
                            return ready
                if len(ready) >= num_returns:
                    return ready
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return ready
                self._cv.wait(timeout=remaining)

    def delete(self, object_ids: List[ObjectID]) -> None:
        with self._lock:
            for oid in object_ids:
                self._objects.pop(oid, None)
                self._callbacks.pop(oid, None)

    def size(self) -> int:
        with self._lock:
            return len(self._objects)
