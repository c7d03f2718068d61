"""ObjectRef: a first-class future handle to a (possibly remote) value.

Parity target: the reference's ObjectRef semantics
(reference: python/ray/includes/object_ref.pxi) — hashable, picklable
(pickling registers a borrow with the owner), awaitable, and releasing the
last in-scope reference lets the store reclaim the value.
"""

from __future__ import annotations

from concurrent.futures import Future
from typing import Optional

from ray_tpu_torch.core.ids import ObjectID


def _current_runtime():
    from ray_tpu_torch.core.runtime_context import get_runtime

    return get_runtime()


class ObjectRef:
    __slots__ = ("_id", "_owner_addr", "_skip_release", "__weakref__")

    def __init__(self, object_id: ObjectID, owner_addr: Optional[str] = None,
                 _add_local_ref: bool = True):
        self._id = object_id
        self._owner_addr = owner_addr
        self._skip_release = not _add_local_ref
        if _add_local_ref:
            rt = _current_runtime()
            if rt is not None:
                rt.refcount.add_local_ref(object_id)

    def id(self) -> ObjectID:
        return self._id

    def hex(self) -> str:
        return self._id.hex()

    def binary(self) -> bytes:
        return self._id.binary()

    @property
    def owner_address(self) -> Optional[str]:
        return self._owner_addr

    def task_id(self):
        return self._id.task_id()

    def future(self) -> Future:
        """A concurrent.futures.Future resolved with the value (or exception)."""
        rt = _current_runtime()
        fut: Future = Future()

        def _on_ready(rec):
            # The future may have been CANCELLED (asyncio.wait_for timeout
            # or a disconnected client cancelling its await): set_* would
            # raise InvalidStateError out of the store's delivery thread.
            try:
                value = rt.resolve_record(rec)
            except BaseException as e:  # noqa: BLE001 - propagate task errors
                if not fut.cancelled():
                    try:
                        fut.set_exception(e)
                    except Exception:
                        pass
                return
            if not fut.cancelled():
                try:
                    fut.set_result(value)
                except Exception:
                    pass

        rt.register_ready_callback(self._id, _on_ready)
        return fut

    def __await__(self):
        import asyncio

        return asyncio.wrap_future(self.future()).__await__()

    def __hash__(self):
        return hash(self._id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._id == self._id

    def __repr__(self):
        return f"ObjectRef({self._id.hex()})"

    def __reduce__(self):
        # Serializing a ref transfers a borrow: the deserializer re-registers
        # a local reference on its side (ownership stays with the creator).
        # The OWNER side must bridge the gap between "my last local ref
        # died" and "the receiver's add_borrower arrived" — without a pin,
        # returning a ref from an actor method frees the object before the
        # caller can fetch it.
        rt = _current_runtime()
        if rt is not None and hasattr(rt, "pin_for_transfer"):
            rt.pin_for_transfer(self._id, self._owner_addr)
        return (_deserialize_ref, (self._id.binary(), self._owner_addr))

    def __del__(self):
        if self._skip_release:
            return
        try:
            rt = _current_runtime()
            if rt is not None:
                rt.refcount.remove_local_ref(self._id)
        except Exception:
            pass  # interpreter shutdown


def _deserialize_ref(binary: bytes, owner_addr: Optional[str]) -> ObjectRef:
    oid = ObjectID(binary)
    rt = _current_runtime()
    if rt is not None:
        rt.on_ref_deserialized(oid, owner_addr)
    return ObjectRef(oid, owner_addr)
