"""Binary identifiers with embedded lineage.

Design parity with the reference's ID scheme (reference: src/ray/common/id.h),
re-designed rather than ported: IDs are flat ``bytes`` wrappers with lineage
*embedded by prefix* so that containment tests and owner extraction are O(1)
slices instead of table lookups:

    JobID   (4B)                         -- per job
    ActorID (12B) = unique(8)  + job(4)  -- actor identity
    TaskID  (20B) = unique(8)  + actor(12)
    ObjectID(28B) = index(4)   + task(20) + flags(4)

(8 random bytes of task uniqueness: collision probability stays negligible at
billions of tasks; 4 bytes would hit birthday-bound collisions at ~10^4.)

So ``ObjectID.task_id()`` and ``TaskID.actor_id()`` are pure slicing, which the
ownership layer (refcount.py) relies on in its hot paths.  NodeID / WorkerID / PlacementGroupID are 16B random.
"""

from __future__ import annotations

import os
import threading
import struct

_rng_lock = threading.Lock()
_counter = 0

# Batched entropy: os.urandom is a syscall (~10us) and sits on the
# per-task hot path (one TaskID per submit). Refill 8KB at a time and
# slice; fork safety comes from re-keying on pid change (a forked child
# must not replay the parent's buffered entropy).
_rand_buf = b""
_rand_pos = 0
_rand_pid = -1


def _rand_bytes(n: int) -> bytes:
    global _rand_buf, _rand_pos, _rand_pid
    if n > 8192:
        return os.urandom(n)
    with _rng_lock:
        if _rand_pos + n > len(_rand_buf) or _rand_pid != os.getpid():
            _rand_buf = os.urandom(8192)
            _rand_pos = 0
            _rand_pid = os.getpid()
        out = _rand_buf[_rand_pos:_rand_pos + n]
        _rand_pos += n
        return out


def _next_counter() -> int:
    global _counter
    with _rng_lock:
        _counter += 1
        return _counter


class BaseID:
    """Immutable binary ID. Subclasses fix SIZE."""

    SIZE = 16
    __slots__ = ("_bytes", "_hash")

    def __init__(self, binary: bytes):
        if len(binary) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self.SIZE} bytes, got {len(binary)}"
            )
        self._bytes = bytes(binary)
        self._hash = hash(self._bytes)

    @classmethod
    def from_random(cls) -> "BaseID":
        return cls(_rand_bytes(cls.SIZE))

    @classmethod
    def from_hex(cls, hex_str: str) -> "BaseID":
        return cls(bytes.fromhex(hex_str))

    @classmethod
    def nil(cls) -> "BaseID":
        return cls(b"\xff" * cls.SIZE)

    def is_nil(self) -> bool:
        return self._bytes == b"\xff" * self.SIZE

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __ne__(self, other):
        return not self.__eq__(other)

    def __lt__(self, other):
        return self._bytes < other._bytes

    def __repr__(self):
        return f"{type(self).__name__}({self.hex()[:16]})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class JobID(BaseID):
    SIZE = 4

    @classmethod
    def from_int(cls, i: int) -> "JobID":
        return cls(struct.pack("<I", i))

    def int_value(self) -> int:
        return struct.unpack("<I", self._bytes)[0]


class NodeID(BaseID):
    SIZE = 16


class WorkerID(BaseID):
    SIZE = 16


class PlacementGroupID(BaseID):
    SIZE = 16


class ClusterID(BaseID):
    SIZE = 16


class ActorID(BaseID):
    SIZE = 12
    UNIQUE = 8

    @classmethod
    def of(cls, job_id: JobID) -> "ActorID":
        return cls(_rand_bytes(cls.UNIQUE) + job_id.binary())

    @classmethod
    def nil_for_job(cls, job_id: JobID) -> "ActorID":
        return cls(b"\xff" * cls.UNIQUE + job_id.binary())

    def job_id(self) -> JobID:
        return JobID(self._bytes[self.UNIQUE :])


class TaskID(BaseID):
    SIZE = 20
    UNIQUE = 8

    @classmethod
    def for_task(cls, actor_id: ActorID) -> "TaskID":
        return cls(_rand_bytes(cls.UNIQUE) + actor_id.binary())

    @classmethod
    def for_driver(cls, job_id: JobID) -> "TaskID":
        return cls.for_task(ActorID.nil_for_job(job_id))

    def actor_id(self) -> ActorID:
        return ActorID(self._bytes[self.UNIQUE :])

    def job_id(self) -> JobID:
        return self.actor_id().job_id()


# ObjectID flag bits (last 4 bytes, little-endian u32).
_FLAG_PUT = 0x1  # created by put() rather than a task return
_FLAG_STREAM = 0x2  # streaming-generator return


class ObjectID(BaseID):
    SIZE = 28
    _IDX = 4

    @classmethod
    def for_task_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        return cls(struct.pack("<I", index) + task_id.binary() + struct.pack("<I", 0))

    @classmethod
    def for_put(cls, task_id: TaskID, put_index: int) -> "ObjectID":
        return cls(
            struct.pack("<I", put_index) + task_id.binary() + struct.pack("<I", _FLAG_PUT)
        )

    @classmethod
    def for_stream_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        """The index-th yield of a streaming-generator task (reference:
        streaming-generator return refs, task_manager.h:212)."""
        return cls(struct.pack("<I", index) + task_id.binary()
                   + struct.pack("<I", _FLAG_STREAM))

    def is_stream(self) -> bool:
        return bool(self.flags() & _FLAG_STREAM)

    def task_id(self) -> TaskID:
        return TaskID(self._bytes[self._IDX : self._IDX + TaskID.SIZE])

    def index(self) -> int:
        return struct.unpack("<I", self._bytes[: self._IDX])[0]

    def flags(self) -> int:
        return struct.unpack("<I", self._bytes[self._IDX + TaskID.SIZE :])[0]

    def is_put(self) -> bool:
        return bool(self.flags() & _FLAG_PUT)

    def created_by_task(self) -> bool:
        return not self.is_put()
