"""Lineage store: the recipe for re-creating lost objects.

Parity target: the reference's lineage-based object recovery
(reference: src/ray/core_worker/task_manager.h:212,265 ResubmitTask +
object_recovery_manager.h): the owner keeps each finished task's spec as
long as its outputs might need re-creating; when a node holding a task's
(plasma) output dies, the owner resubmits the creating task — transitively,
since the resubmitted task's own arguments may be lost too.

Records are kept in bytes-bounded FIFO (``max_lineage_bytes``); records
OUTLIVE the value (a freed value costs nothing, but its recipe still lets
descendants recover), which is the whole point of storing specs instead of
pinning data.
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch.core.ids import ObjectID


class LineageRecord:
    __slots__ = ("spec_blob", "sched_key", "resources", "strategy", "name",
                 "return_ids", "arg_ids", "nbytes", "runtime_env")

    def __init__(self, spec_blob: bytes, sched_key: tuple, resources,
                 strategy, name: str, return_ids: List[ObjectID],
                 arg_ids: List[ObjectID], runtime_env=None):
        self.runtime_env = runtime_env
        self.spec_blob = spec_blob
        self.sched_key = sched_key
        self.resources = resources
        self.strategy = strategy
        self.name = name
        self.return_ids = return_ids
        self.arg_ids = arg_ids
        self.nbytes = len(spec_blob) + 64 * (len(return_ids) + len(arg_ids))


class LineageStore:
    def __init__(self, max_bytes: int):
        self._max_bytes = max_bytes
        self._lock = threading.Lock()
        self._by_task: "collections.OrderedDict[bytes, LineageRecord]" = (
            collections.OrderedDict())
        self._by_oid: Dict[ObjectID, bytes] = {}
        self._bytes = 0
        self.evictions = 0

    def record(self, task_id_bytes: bytes, rec: LineageRecord) -> None:
        if self._max_bytes <= 0:
            return
        with self._lock:
            old = self._by_task.pop(task_id_bytes, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._by_task[task_id_bytes] = rec
            self._bytes += rec.nbytes
            for oid in rec.return_ids:
                self._by_oid[oid] = task_id_bytes
            while self._bytes > self._max_bytes and len(self._by_task) > 1:
                victim_key, victim = self._by_task.popitem(last=False)
                self._bytes -= victim.nbytes
                self.evictions += 1
                for oid in victim.return_ids:
                    if self._by_oid.get(oid) == victim_key:
                        del self._by_oid[oid]

    def for_object(self, oid: ObjectID) -> Optional[Tuple[bytes, LineageRecord]]:
        with self._lock:
            key = self._by_oid.get(oid)
            if key is None:
                return None
            rec = self._by_task.get(key)
            return (key, rec) if rec is not None else None

    def size_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def num_records(self) -> int:
        with self._lock:
            return len(self._by_task)
