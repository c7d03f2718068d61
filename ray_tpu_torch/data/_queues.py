"""Bounded inter-operator queues for the streaming Dataset executor
(``ray_tpu/data/_queues.py`` without the ``res_debug`` registrations).

Two queue flavors, one contract — ``put()`` blocks when the queue is
full (backpressure), ``get()`` blocks when it is empty, ``put_stop()``
marks end-of-stream, and a reader past the stop marker sees
:class:`QueueStopped`:

- :class:`LocalQueue` — an in-process bounded queue (condition variable
  over a deque) for thread boundaries inside ONE process: the
  double-buffered device-ingest pipeline, driver-side prefetch.
- :class:`ChannelQueue` — a process-crossing queue riding one
  channel edge (``dag/ring.py`` shm SPSC ring same-node,
  ``dag/peer.py`` peer socket cross-node). Frames carry object REFS and
  metadata — block bytes never ride the queue, they stay in the shm
  object store and move over the object plane. Backpressure is the
  channel's own: ring capacity/byte bounds same-node, credit windows
  cross-node.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Optional

from ray_tpu_torch.dag.channel import (ChannelClosedError, ChannelError,
                                       ChannelReader, ChannelTimeoutError,
                                       ChannelWriter)

__all__ = ["ChannelQueue", "LocalQueue", "QueueStopped"]


class QueueStopped(Exception):
    """Raised by ``get()`` once the producer's stop marker is consumed."""


class LocalQueue:
    """Bounded in-process MPSC queue: ``put`` blocks at ``capacity``
    items (slow consumer throttles the producer — no unbounded
    buffering), ``get`` blocks on empty. One stop marker ends the
    stream for the consumer after the backlog drains."""

    def __init__(self, capacity: int, name: str = "local"):
        if capacity < 1:
            raise ValueError(f"queue capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.name = name
        self._items: collections.deque = collections.deque()
        self._cond = threading.Condition()
        self._stopped = False      # producer finished
        self._shutdown = False     # consumer gone: puts become no-ops

    def put(self, item: Any, timeout: Optional[float] = None) -> None:
        with self._cond:
            if not self._cond.wait_for(
                    lambda: (len(self._items) < self.capacity
                             or self._shutdown), timeout):
                raise TimeoutError(
                    f"queue {self.name!r} full for {timeout}s "
                    f"(capacity={self.capacity})")
            if self._shutdown:
                return  # consumer abandoned the stream: drop, don't block
            self._items.append(item)
            self._cond.notify_all()

    def put_stop(self) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify_all()

    def get(self, timeout: Optional[float] = None) -> Any:
        with self._cond:
            if not self._cond.wait_for(
                    lambda: (self._items or self._stopped
                             or self._shutdown), timeout):
                raise TimeoutError(
                    f"queue {self.name!r} empty for {timeout}s")
            if self._items:
                item = self._items.popleft()
                self._cond.notify_all()
                return item
            raise QueueStopped(self.name)

    def qsize(self) -> int:
        with self._cond:
            return len(self._items)

    def shutdown(self) -> None:
        """Consumer-side teardown: unblock producers forever."""
        with self._cond:
            self._shutdown = True
            self._items.clear()
            self._cond.notify_all()


class ChannelQueue:
    """One inter-operator edge over a dag channel. Constructed on the
    DRIVER around a ``RingChannel``/``CrossNodeChannel`` (see
    ``dag.channel.open_edge``) and pickled to the remote end inside the
    operator's attach call — the channel's rendezvous (shm ring file /
    head channel registry) connects the two processes. Role is fixed by
    first use: ``put``/``put_stop`` make this end the writer, ``get``
    the reader.

    Frames are small (refs + metadata); bounded-ness comes from the
    channel itself — ring ``capacity`` frames / ``ring_bytes`` bytes
    same-node, the credit window cross-node — so a stalled reader
    blocks ``put`` with zero driver involvement."""

    def __init__(self, channel, name: str = "edge"):
        self.channel = channel
        self.name = name
        self._writer: Optional[ChannelWriter] = None
        self._reader: Optional[ChannelReader] = None

    # -- pickling: the queue travels to the operator actor with its
    # channel; the facades are per-process state.
    def __getstate__(self):
        return {"channel": self.channel, "name": self.name}

    def __setstate__(self, state):
        self.channel = state["channel"]
        self.name = state["name"]
        self._writer = None
        self._reader = None

    def _ensure_role(self, writer: bool):
        if writer:
            if self._reader is not None:
                raise RuntimeError(f"queue {self.name!r} already a reader")
            if self._writer is None:
                self._writer = ChannelWriter(self.channel)
            return self._writer
        if self._writer is not None:
            raise RuntimeError(f"queue {self.name!r} already a writer")
        if self._reader is None:
            self._reader = ChannelReader(self.channel)
            self._reader.prepare()
        return self._reader

    def prepare_read(self) -> None:
        """Reader-side registration (peer channels need their inbox
        registered with the head BEFORE the writer looks it up)."""
        self._ensure_role(writer=False)

    def put(self, item: Any, timeout: Optional[float] = None) -> None:
        self._ensure_role(writer=True).send(item, timeout=timeout)

    def put_stop(self) -> None:
        w = self._ensure_role(writer=True)
        w.send_stop()

    def get(self, timeout: Optional[float] = None) -> Any:
        r = self._ensure_role(writer=False)
        try:
            return r.recv(timeout=timeout)
        except ChannelClosedError as e:
            raise QueueStopped(self.name) from e

    def shutdown(self, unlink: bool = False) -> None:
        """Close this end. ``unlink=True`` (driver teardown once the
        remote end is known dead) also removes a ring's shm file —
        normally the reader's job, but a killed operator actor never
        gets to do it."""
        close = getattr(self.channel, "close", None)
        if close is None:
            return
        try:
            if unlink:
                try:
                    close(unlink=True)
                except TypeError:  # peer channels take no unlink arg
                    close()
            else:
                end = self._writer or self._reader
                if end is not None:
                    end.close()
                else:
                    close()
        except (ChannelError, ChannelTimeoutError, OSError):
            pass
