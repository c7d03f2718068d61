"""Compiled-DAG channels: the data plane the compiled graph runs on
(``ray_tpu/dag/channel.py``, the port's own copy).

Two transports, selected at compile time once actor placement is known
(``compiled_dag._resolve_channel_kinds``):

- :class:`ShmChannel` (``ring.RingChannel``) — same-node edges ride an
  SPSC shm ring buffer (one mmap in /dev/shm per edge): a hop is a
  memcpy + an 8-byte cursor publish. See ``ring.py``.
- :class:`CrossNodeChannel` (``peer.CrossNodeChannel``) — cross-node
  edges ride a persistent peer socket carrying pickle-5 scatter frames
  with credit-based backpressure, negotiated ONCE through the head's
  channel registry. See ``peer.py``.

Both implement the same surface the compiled DAG drives::

    write(value, seq) / write_error(exc, seq) / write_stop(seq)
    read(seq, timeout)            # ordered; consumption is the ack
    wait_consumed(seq, timeout)   # teardown handshake
    drain(from_seq) / close()

``ChannelWriter`` / ``ChannelReader`` wrap an endpoint with a running
seq counter for long-lived streams (the disaggregated-serving KV mesh)
where callers want ``send()``/``recv()`` instead of explicit seqs.

Each endpoint class names its ``transport`` (``"ring"`` or ``"peer"``).
"""

from __future__ import annotations

import threading
from typing import Any, Optional

from ray_tpu_torch.dag.errors import (ChannelClosedError, ChannelError,
                                ChannelTimeoutError)
from ray_tpu_torch.dag.peer import (ChannelEndpoint, CrossNodeChannel,
                              endpoint_violations, get_endpoint)
from ray_tpu_torch.dag.ring import RingChannel, channel_dir

#: Same-node transport under its historical name (the compiled DAG and
#: its tests type-check channel kinds by these two class names).
ShmChannel = RingChannel

__all__ = [
    "ChannelClosedError", "ChannelEndpoint", "ChannelError",
    "ChannelReader", "ChannelTimeoutError", "ChannelWriter",
    "CrossNodeChannel", "RingChannel", "ShmChannel", "channel_dir",
    "endpoint_violations", "get_endpoint", "open_edge",
]


def open_edge(channel_id: bytes, *, writer_node: Optional[str],
              reader_node: Optional[str],
              writer_addr: Optional[str] = None,
              reader_addr: Optional[str] = None,
              capacity: int = 8, ring_bytes: Optional[int] = None,
              edge: str = ""):
    """Placement-aware channel construction for data-plane edges OUTSIDE
    compiled DAGs: the same ring-vs-peer decision
    ``compiled_dag._resolve_channel_kinds`` makes at compile time, packaged
    for callers that already know both endpoints' nodes. Same node (or
    unknown placement, e.g. a single-process runtime) -> shm SPSC ring;
    different nodes -> peer socket with credit backpressure (both node
    ADDRESSES required)."""
    if (writer_node is None or reader_node is None
            or writer_node == reader_node):
        return RingChannel(channel_id, capacity=capacity,
                           ring_bytes=ring_bytes, edge=edge)
    if not writer_addr or not reader_addr:
        raise ValueError(
            f"cross-node edge {edge or channel_id.hex()[:8]} needs both "
            f"node addresses ({writer_node!r} -> {reader_node!r})")
    ch = CrossNodeChannel(channel_id, writer_addr, reader_addr,
                          capacity=capacity)
    ch.edge = edge
    return ch


class ChannelWriter:
    """Thread-safe auto-seq facade over a channel's writer end: many
    producer threads, ONE ordered stream (the channel stays
    single-writer — the lock serializes, the counter orders)."""

    def __init__(self, channel):
        self.channel = channel
        self._seq = 0
        self._lock = threading.Lock()

    def send(self, value: Any, timeout: Optional[float] = None) -> int:
        with self._lock:
            seq = self._seq
            self._seq += 1
            self.channel.write(value, seq, timeout=timeout)
            return seq

    def send_stop(self) -> None:
        with self._lock:
            try:
                self.channel.write_stop(self._seq)
                self._seq += 1
            except (ChannelError, ChannelTimeoutError, OSError):
                pass

    def close(self) -> None:
        close = getattr(self.channel, "close", None)
        if close is not None:
            close()


class ChannelReader:
    """Auto-seq facade over a channel's reader end (single consumer)."""

    def __init__(self, channel):
        self.channel = channel
        self._seq = 0

    def prepare(self) -> None:
        prep = getattr(self.channel, "prepare_read", None)
        if prep is not None:
            prep()

    def recv(self, timeout: Optional[float] = None) -> Any:
        value = self.channel.read(self._seq, timeout=timeout)
        self._seq += 1
        return value

    def close(self) -> None:
        close = getattr(self.channel, "close", None)
        if close is not None:
            try:
                close(unlink=True)
            except TypeError:
                close()
