"""Distributed FIFO queue backed by an asyncio actor
(``ray_tpu/util/queue.py``).

Parity target: reference python/ray/util/queue.py (Queue over an
``_QueueActor`` asyncio actor — put/get with block/timeout semantics
shared by every process holding the handle).
"""

from __future__ import annotations

from typing import Any, List, Optional

import ray_tpu_torch


class Empty(Exception):
    pass


class Full(Exception):
    pass


class _QueueActor:
    """Asyncio actor: awaited put/get interleave without blocking peers."""

    def __init__(self, maxsize: int = 0):
        import asyncio

        self._q: "asyncio.Queue" = asyncio.Queue(maxsize)

    async def put(self, item: Any, timeout: Optional[float] = None) -> bool:
        import asyncio

        try:
            await asyncio.wait_for(self._q.put(item), timeout)
            return True
        except asyncio.TimeoutError:
            return False

    async def get(self, timeout: Optional[float] = None):
        import asyncio

        try:
            return True, await asyncio.wait_for(self._q.get(), timeout)
        except asyncio.TimeoutError:
            return False, None

    async def put_nowait(self, item: Any) -> bool:
        try:
            self._q.put_nowait(item)
            return True
        except Exception:
            return False

    async def get_nowait(self):
        try:
            return True, self._q.get_nowait()
        except Exception:
            return False, None

    async def qsize(self) -> int:
        return self._q.qsize()

    async def empty(self) -> bool:
        return self._q.empty()

    async def full(self) -> bool:
        return self._q.full()


class Queue:
    """Cluster-wide FIFO queue; the handle pickles into tasks/actors."""

    def __init__(self, maxsize: int = 0, *, _actor=None):
        if _actor is not None:
            self._actor = _actor
            return
        actor_cls = ray_tpu_torch.remote(_QueueActor)
        self._actor = actor_cls.options(num_cpus=0,
                                        max_concurrency=8).remote(maxsize)

    def put(self, item: Any, block: bool = True,
            timeout: Optional[float] = None) -> None:
        if not block:
            if not ray_tpu_torch.get(self._actor.put_nowait.remote(item),
                                     timeout=30):
                raise Full("queue full")
            return
        ok = ray_tpu_torch.get(self._actor.put.remote(item, timeout),
                               timeout=(timeout or 3600) + 30)
        if not ok:
            raise Full("queue full (timeout)")

    def get(self, block: bool = True,
            timeout: Optional[float] = None) -> Any:
        if not block:
            ok, item = ray_tpu_torch.get(self._actor.get_nowait.remote(),
                                         timeout=30)
            if not ok:
                raise Empty("queue empty")
            return item
        ok, item = ray_tpu_torch.get(self._actor.get.remote(timeout),
                                     timeout=(timeout or 3600) + 30)
        if not ok:
            raise Empty("queue empty (timeout)")
        return item

    def put_nowait(self, item: Any) -> None:
        self.put(item, block=False)

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def qsize(self) -> int:
        return ray_tpu_torch.get(self._actor.qsize.remote(), timeout=30)

    def empty(self) -> bool:
        return ray_tpu_torch.get(self._actor.empty.remote(), timeout=30)

    def full(self) -> bool:
        return ray_tpu_torch.get(self._actor.full.remote(), timeout=30)

    def put_batch(self, items: List[Any]) -> None:
        for item in items:
            self.put(item)

    def shutdown(self) -> None:
        try:
            ray_tpu_torch.kill(self._actor)
        except Exception:
            pass

    def __reduce__(self):
        # Rebuild from the existing actor handle; Queue(0) here would spawn
        # (and leak) a fresh _QueueActor on every deserialization.
        return (_rebuild_queue, (self._actor,))


def _rebuild_queue(actor) -> "Queue":
    return Queue(_actor=actor)
