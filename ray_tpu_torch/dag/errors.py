"""Channel error types, shared by every transport
(``ray_tpu/dag/errors.py``, the port's own copy).

``ChannelTimeoutError`` carries structured context — which edge, which
seq, how many bytes were in flight, whether the peer was alive at the
time — because a bare "channel read timed out" message cannot say which
edge stalled or why.
"""

from __future__ import annotations

from typing import Optional


class ChannelError(RuntimeError):
    pass


class ChannelClosedError(ChannelError):
    """The peer endpoint closed (stop sentinel, teardown, or death)."""


class ChannelTimeoutError(TimeoutError):
    """A channel op exceeded its deadline.

    Attributes (any may be None when the transport cannot know):
      edge            "writer→reader" label of the channel
      seq             the message sequence the op was blocked on
      bytes_in_flight written-but-unconsumed bytes at timeout time
      peer_alive      liveness verdict for the remote endpoint (False =
                      the head's channel registry says it died; the
                      caller should treat the channel as closed)
    """

    def __init__(self, message: str = "channel op timed out", *,
                 edge: Optional[str] = None, seq: Optional[int] = None,
                 bytes_in_flight: Optional[int] = None,
                 peer_alive: Optional[bool] = None):
        self.edge = edge
        self.seq = seq
        self.bytes_in_flight = bytes_in_flight
        self.peer_alive = peer_alive
        parts = [message]
        ctx = []
        if edge is not None:
            ctx.append(f"edge={edge}")
        if seq is not None:
            ctx.append(f"seq={seq}")
        if bytes_in_flight is not None:
            ctx.append(f"bytes_in_flight={bytes_in_flight}")
        if peer_alive is not None:
            ctx.append(f"peer_alive={peer_alive}")
        if ctx:
            parts.append("(" + ", ".join(ctx) + ")")
        super().__init__(" ".join(parts))
