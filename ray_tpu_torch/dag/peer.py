"""Cross-node compiled-DAG transport: persistent peer sockets carrying
zero-copy scatter frames (``ray_tpu/dag/peer.py``, the port's own copy).

A DIRECT peer connection: the reader side runs one
``ChannelEndpoint`` per process (an accept loop on an ephemeral port,
registered once with the head under the channel id), the writer looks
the endpoint up ONCE and then every steady-state send is a single
``sendmsg`` of pickle-5 out-of-band buffers straight onto the socket —
no store put, no node-manager push RPC, no per-message ack object.

Wire format, writer → reader (one socket per channel edge)::

    hello:  u32 0xC0DE0001 | u32 idlen | channel_id
    data:   u32 size | u8 kind | u64 seq | u64 clock | u32 crc
            | u32 nparts | u32 lens[nparts] | parts...
                                            (size = sum of lens)

``clock``/``crc`` carry the RTPU_DEBUG_CHAN witness's Lamport stamp
and sampled payload checksum (``devtools/chan_debug.py``); both are 0
when the witness is off.

reader → writer (same socket)::

    ack:    u32 0xACACACAC | u64 consumed_seq   (cumulative)

Backpressure is credit-based: the writer admits ``seq`` only while
``seq - acked_through < capacity``; acks are sent when the APPLICATION
consumes a message, not on enqueue, so a stalled reader stalls the
writer by construction. The endpoint enforces per-channel seq
monotonicity on receipt — an inversion or re-delivery is recorded (and
printed as ``RTPU_CHANNEL:``).

Death handling rides the existing report path: the head scrubs channel
registrations when the owning worker dies, so a writer blocked on a
dead reader gets ``peer_alive=False`` context (and
``ChannelClosedError`` once the registry entry is gone) instead of an
opaque timeout.

``ray_tpu``'s tracing spans are left out of this copy; its channel,
resource and lock witnesses are the port's own ``devtools``.
"""

from __future__ import annotations

import logging
import pickle
import queue
import socket
import struct
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

from ray_tpu_torch.dag.errors import ChannelClosedError, ChannelTimeoutError
from ray_tpu_torch.dag.ring import KIND_ERR, KIND_OK, KIND_STOP
from ray_tpu_torch.devtools import chan_debug as _chandbg
from ray_tpu_torch.devtools import res_debug as _resdbg
from ray_tpu_torch.devtools.lock_debug import make_lock

_HELLO = 0xC0DE0001
_ACK = 0xACACACAC
_GONE = 0xDEADC0DE  # endpoint -> writer: channel is not served here


def _recv_exact(sock: socket.socket, n: int) -> Optional[memoryview]:
    buf = memoryview(bytearray(n))
    got = 0
    while got < n:
        try:
            r = sock.recv_into(buf[got:])
        except OSError:
            return None
        if not r:
            return None
        got += r
    return buf


class _Inbox:
    """Per-channel receive state on the endpoint."""

    def __init__(self, capacity: int):
        self.q: "queue.Queue" = queue.Queue(maxsize=max(2, capacity) + 2)
        self.conn: Optional[socket.socket] = None
        self.conn_lock = threading.Lock()
        self.last_seq = -1
        self.bytes_received = 0
        self.closed = False


class ChannelEndpoint:
    """Reader-side frame server: one per process, shared by every
    cross-node channel whose reader lives here."""

    chaos_role = "channel"  # fault-injection scope (devtools/chaos.py)

    def __init__(self, host: Optional[str] = None):
        self._inboxes: Dict[bytes, _Inbox] = {}
        self._lock = make_lock("dag.peer.endpoint._lock")
        self._violations: List[dict] = []
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host or "0.0.0.0", 0))
        self._sock.listen(64)
        self._stopped = False
        # The process-wide listener is long-lived BY DESIGN: it serves
        # every channel whose reader lives here.
        _resdbg.note_acquire("channel_endpoint",
                             key=("endpoint", id(self)), owner=self)
        self._accept_thread = _resdbg.track_thread(threading.Thread(
            target=self._accept_loop, daemon=True,
            name="dag-channel-endpoint"), owner=self)
        self._accept_thread.start()

    @property
    def port(self) -> int:
        return self._sock.getsockname()[1]

    def address(self, host: str) -> str:
        return f"{host}:{self.port}"

    def register(self, channel_id: bytes, capacity: int) -> _Inbox:
        with self._lock:
            ib = self._inboxes.get(channel_id)
            if ib is None:
                ib = self._inboxes[channel_id] = _Inbox(capacity)
            return ib

    def unregister(self, channel_id: bytes) -> None:
        with self._lock:
            ib = self._inboxes.pop(channel_id, None)
        if ib is not None:
            ib.closed = True
            with ib.conn_lock:
                conn, ib.conn = ib.conn, None
            if conn is not None:
                _shutdown(conn)

    def violations(self) -> List[dict]:
        with self._lock:
            return list(self._violations)

    def _note_violation(self, rec: dict) -> None:
        import sys

        with self._lock:
            self._violations.append(rec)
        print(f"RTPU_CHANNEL: {rec}", file=sys.stderr, flush=True)

    def _accept_loop(self) -> None:
        while not self._stopped:
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True, name="dag-channel-conn").start()

    def _serve_conn(self, conn: socket.socket) -> None:
        _resdbg.note_acquire("channel_sock",
                             key=("conn", id(conn)), owner=self)
        try:
            hdr = _recv_exact(conn, 8)
            if hdr is None:
                return
            magic, idlen = struct.unpack("<II", hdr)
            if magic != _HELLO or idlen > 256:
                return
            cid = _recv_exact(conn, idlen)
            if cid is None:
                return
            cid = bytes(cid)
            with self._lock:
                ib = self._inboxes.get(cid)
            if ib is None or ib.closed:
                # Active rejection: a writer dialing a torn-down (or
                # never-served) channel must learn it is GONE — silently
                # closing let buffered sends "succeed" into the void.
                try:
                    conn.sendall(struct.pack("<IQ", _GONE, 0))
                except OSError:
                    pass
                return
            with ib.conn_lock:
                ib.conn = conn
            self._pump(conn, cid, ib)
        finally:
            _shutdown(conn)
            _resdbg.note_release("channel_sock", ("conn", id(conn)))

    def _pump(self, conn: socket.socket, cid: bytes, ib: _Inbox) -> None:
        while not self._stopped and not ib.closed:
            hdr = _recv_exact(conn, 29)
            if hdr is None:
                return
            size, kind, seq, clock, crc = struct.unpack("<IBQQI",
                                                        hdr[:25])
            (nparts,) = struct.unpack("<I", hdr[25:29])
            lens_raw = _recv_exact(conn, 4 * nparts)
            if lens_raw is None:
                return
            lens = struct.unpack("<%dI" % nparts, lens_raw)
            parts = []
            for ln in lens:
                p = _recv_exact(conn, ln)
                if p is None:
                    return
                parts.append(p)
            # Monotonicity witness: SPSC channels deliver seq 0,1,2,...;
            # anything else is a transport bug (re-delivery, inversion).
            if seq <= ib.last_seq:
                self._note_violation({
                    "kind": "channel-seq-inversion",
                    "channel": cid.hex()[:12], "seq": seq,
                    "last": ib.last_seq})
                continue  # drop the duplicate/inverted frame
            if seq != ib.last_seq + 1 and ib.last_seq >= 0:
                self._note_violation({
                    "kind": "channel-seq-gap",
                    "channel": cid.hex()[:12], "seq": seq,
                    "last": ib.last_seq})
            try:
                ib.q.put((kind, seq, clock, crc, parts), timeout=60.0)
            except queue.Full:
                # last_seq NOT advanced: the frame never reached the
                # application, so a retransmit after reconnect must
                # not be dropped as an inversion.
                self._note_violation({
                    "kind": "channel-inbox-overflow",
                    "channel": cid.hex()[:12], "seq": seq})
                return
            ib.last_seq = seq
            ib.bytes_received += size

    def ack(self, ib: _Inbox, seq: int) -> None:
        with ib.conn_lock:
            conn = ib.conn
        if conn is None:
            return
        try:
            conn.sendall(struct.pack("<IQ", _ACK, seq))
        except OSError:
            pass  # writer's liveness probe covers a dead ack path

    def stop(self) -> None:
        self._stopped = True
        with self._lock:
            inboxes = list(self._inboxes.values())
            self._inboxes.clear()
        for ib in inboxes:
            ib.closed = True
            with ib.conn_lock:
                conn, ib.conn = ib.conn, None
            if conn is not None:
                _shutdown(conn)
        _shutdown(self._sock)
        _resdbg.note_release("channel_endpoint", ("endpoint", id(self)))
        if self._accept_thread is not threading.current_thread():
            self._accept_thread.join(timeout=5.0)


def _shutdown(sock: socket.socket) -> None:
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


_endpoint: Optional[ChannelEndpoint] = None
_endpoint_lock = threading.Lock()


def get_endpoint() -> ChannelEndpoint:
    global _endpoint
    with _endpoint_lock:
        if _endpoint is None or _endpoint._stopped:
            _endpoint = ChannelEndpoint()
        return _endpoint


def endpoint_violations() -> List[dict]:
    """Seq-monotonicity / overflow violations this process's endpoint
    observed."""
    with _endpoint_lock:
        if _endpoint is None:
            return []
    return _endpoint.violations()


def _local_host() -> str:
    """The host other nodes can dial this process on: the node
    manager's advertised host (worker and node manager share it)."""
    try:
        from ray_tpu_torch.core.runtime_context import get_runtime

        rt = get_runtime()
        for attr in ("node", "head"):
            client = getattr(rt, attr, None)
            addr = getattr(client, "addr", None) or getattr(
                client, "address", None)
            if isinstance(addr, str) and ":" in addr:
                host = addr.rsplit(":", 1)[0]
                if host not in ("0.0.0.0", ""):
                    return host
    except Exception as e:  # noqa: BLE001 — loopback fallback
        logger.debug("channel host resolution failed: %r", e)
    return "127.0.0.1"


def _head_client():
    try:
        from ray_tpu_torch.core.runtime_context import get_runtime

        rt = get_runtime()
        return getattr(rt, "head", None)
    except Exception as e:  # noqa: BLE001 — no-runtime processes
        logger.debug("no head client for channel registry: %r", e)
        return None


def _owner_tag() -> Tuple[str, str]:
    """(owner, node_id) identity the head's death-report scrub keys on:
    the worker's own address when it has one, plus its node."""
    try:
        from ray_tpu_torch.core.runtime_context import get_runtime

        rt = get_runtime()
        return (getattr(rt, "owner_addr", "") or "",
                str(getattr(rt, "node_id", "") or ""))
    except Exception as e:  # noqa: BLE001 — anonymous endpoint
        logger.debug("channel owner identity unavailable: %r", e)
        return "", ""


class CrossNodeChannel:
    """Single-writer single-reader ordered channel ACROSS nodes, over a
    persistent peer socket.

    The reader calls :meth:`prepare_read` (or just ``read``): it
    registers an inbox on this process's ``ChannelEndpoint`` and
    registers the endpoint's address with the head — the ONE-TIME
    negotiation. The writer resolves that address via
    ``channel_lookup`` on first write (or uses an explicit ``addr`` in
    tests/serve negotiation), connects once, and every later send is a
    single scatter ``sendmsg``.
    """

    transport = "peer"

    def __init__(self, channel_id: bytes, writer_node_addr: str = "",
                 reader_node_addr: str = "", capacity: int = 8,
                 edge: str = "", addr: Optional[str] = None):
        self.channel_id = channel_id
        self.writer_node_addr = writer_node_addr
        self.reader_node_addr = reader_node_addr
        self.capacity = capacity
        self.edge = edge or channel_id.hex()[:12]
        self._addr = addr           # explicit endpoint (skips the head)
        self._closed = False
        # writer state
        self._sock: Optional[socket.socket] = None
        self._send_lock = threading.Lock()
        self._ack_cond = threading.Condition()
        self._acked = -1
        self._sent_bytes = 0
        self._acked_bytes = 0
        # seq -> frame size for UNACKED sends (bounded by the credit
        # window); settles into _acked_bytes as acks advance so
        # bytes_in_flight reports what is actually outstanding.
        self._inflight_sizes: Dict[int, int] = {}
        self._sock_dead: Optional[str] = None
        self._peer_gone = False  # endpoint actively rejected the channel
        self._ack_thread = None
        # reader state
        self._inbox: Optional[_Inbox] = None
        self._registered = False

    def _witness_key(self) -> str:
        k = getattr(self, "_wkey", None)
        if k is None:
            k = self._wkey = f"{self.edge}@{id(self) & 0xFFFFFF:06x}"
        return k

    # ------------------------------------------------------------- reader

    def prepare_read(self) -> str:
        """Register this process as the channel's reader; returns the
        dialable endpoint address. Idempotent."""
        if self._registered and self._inbox is not None:
            return self._addr or ""
        ep = get_endpoint()
        self._inbox = ep.register(self.channel_id, self.capacity)
        addr = ep.address(_local_host())
        head = _head_client()
        if head is not None:
            owner, node_id = _owner_tag()
            try:
                head.retrying_call("channel_register", self.channel_id,
                                   addr, owner, node_id, timeout=10)
            except Exception as e:  # noqa: BLE001 — writer falls back to
                # its negotiate deadline (and the liveness probe)
                logger.debug("channel_register failed: %r", e)
        self._addr = self._addr or addr
        self._registered = True
        return addr

    def read(self, seq: int, timeout: Optional[float] = None) -> Any:
        if self._closed:
            raise ChannelClosedError(f"channel {self.edge} closed locally")
        self.prepare_read()
        ib = self._inbox
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while True:
            step = 0.5 if deadline is None else max(
                0.0, min(0.5, deadline - time.monotonic()))
            try:
                kind, got_seq, clock, crc, parts = ib.q.get(timeout=step)
                break
            except queue.Empty:
                if self._closed or ib.closed:
                    raise ChannelClosedError(
                        f"channel {self.edge} closed")
                if deadline is not None and time.monotonic() > deadline:
                    raise ChannelTimeoutError(
                        "cross-node channel read timed out",
                        edge=self.edge, seq=seq,
                        bytes_in_flight=ib.bytes_received,
                        peer_alive=None)
        if got_seq != seq:
            raise ChannelClosedError(
                f"channel {self.edge}: seq mismatch (got {got_seq}, "
                f"expected {seq})")
        if _chandbg.enabled():
            _chandbg.note_consume(self._witness_key(), got_seq, clock,
                                  crc, *parts)
        get_endpoint().ack(ib, seq)  # consumption credit -> writer
        if _chandbg.enabled():
            _chandbg.note_ack(self._witness_key(), seq)
        if kind == KIND_STOP:
            raise ChannelClosedError(f"channel {self.edge} closed")
        value = pickle.loads(bytes(parts[0]),
                             buffers=[bytes(p) for p in parts[1:]])
        if kind == KIND_ERR:
            raise value
        return value[1]

    # ------------------------------------------------------------- writer

    def _resolve_addr(self) -> str:
        if self._addr:
            return self._addr
        from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg

        head = _head_client()
        if head is None:
            raise ChannelClosedError(
                f"channel {self.edge}: no endpoint address and no head "
                "to negotiate through")
        deadline = time.monotonic() + cfg.dag_negotiate_timeout_s
        while True:
            try:
                ent = head.retrying_call("channel_lookup",
                                         self.channel_id, timeout=10)
            except Exception as e:  # noqa: BLE001 — retried to deadline
                logger.debug("channel_lookup failed: %r", e)
                ent = None
            if ent:
                if not ent.get("alive", True):
                    raise ChannelClosedError(
                        f"channel {self.edge}: reader endpoint died "
                        "before the writer connected")
                self._addr = ent["addr"]
                return self._addr
            if time.monotonic() > deadline:
                raise ChannelTimeoutError(
                    "channel negotiation: reader never registered",
                    edge=self.edge, peer_alive=None)
            time.sleep(0.05)

    def _connect(self) -> socket.socket:
        if self._sock is not None and self._sock_dead is None:
            return self._sock
        addr = self._resolve_addr()
        host, port = addr.rsplit(":", 1)
        sock = socket.create_connection((host, int(port)), timeout=10)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.sendall(struct.pack("<II", _HELLO, len(self.channel_id))
                         + self.channel_id)
        except BaseException:
            _shutdown(sock)
            raise
        self._sock = sock
        self._sock_dead = None
        _resdbg.note_acquire("channel_sock",
                             key=("writer", id(sock)), owner=self)
        t = _resdbg.track_thread(threading.Thread(
            target=self._ack_loop, args=(sock,), daemon=True,
            name="dag-channel-acks"), owner=self)
        self._ack_thread = t
        t.start()
        return sock

    def _ack_loop(self, sock: socket.socket) -> None:
        try:
            while True:
                frame = _recv_exact(sock, 12)
                if frame is None:
                    return
                magic, seq = struct.unpack("<IQ", frame)
                if magic == _GONE:
                    with self._ack_cond:
                        self._peer_gone = True
                        self._ack_cond.notify_all()
                    return
                if magic != _ACK:
                    return
                with self._ack_cond:
                    if seq > self._acked:
                        self._acked = seq
                        for s in [s for s in self._inflight_sizes
                                  if s <= seq]:
                            self._acked_bytes += \
                                self._inflight_sizes.pop(s)
                    self._ack_cond.notify_all()
        finally:
            with self._ack_cond:
                if self._sock is sock:
                    self._sock_dead = "ack stream ended"
                self._ack_cond.notify_all()
            _resdbg.note_release("channel_sock", ("writer", id(sock)))

    def _peer_alive(self) -> Optional[bool]:
        head = _head_client()
        if head is None:
            return None
        try:
            ent = head.retrying_call("channel_lookup", self.channel_id,
                                     timeout=5)
        except Exception as e:  # noqa: BLE001 — verdict stays unknown
            logger.debug("liveness probe failed: %r", e)
            return None
        if not ent:
            return None
        return bool(ent.get("alive", True))

    def write(self, value: Any, seq: int,
              timeout: Optional[float] = None) -> None:
        self._emit(KIND_OK, ("ok", value), seq, timeout)

    def write_error(self, exc: BaseException, seq: int) -> None:
        self._emit(KIND_ERR, exc, seq, None)

    def write_stop(self, seq: int) -> None:
        self._emit(KIND_STOP, None, seq, None)

    def _emit(self, kind: int, value: Any, seq: int,
              timeout: Optional[float]) -> None:
        if self._closed:
            raise ChannelClosedError(f"channel {self.edge} closed locally")
        if self._peer_gone:
            raise ChannelClosedError(
                f"channel {self.edge}: reader endpoint rejected the "
                f"channel (torn down or dead)")
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        # pickle-5 out-of-band buffers: large numpy payloads ride as raw
        # views scatter-gathered onto the socket — never flattened
        # host-side.
        bufs: List[Any] = []
        if kind == KIND_STOP:
            head_bytes = b""
        else:
            head_bytes = pickle.dumps(
                value, protocol=5,
                buffer_callback=lambda b: bufs.append(b.raw()))
        parts = [head_bytes] + [memoryview(b) for b in bufs]
        lens = [len(p) for p in parts]
        size = sum(lens)
        witness = _chandbg.enabled()
        clock = _chandbg.clock_stamp(self._witness_key()) if witness else 0
        crc = _chandbg.payload_crc(seq, *parts) if witness else 0
        hdr = (struct.pack("<IBQQII", size, kind, seq, clock, crc,
                           len(parts))
               + struct.pack("<%dI" % len(parts), *lens))
        from ray_tpu_torch.cluster.protocol import _sendmsg_all

        last_err: Optional[BaseException] = None
        for attempt in range(2):
            if self._peer_gone:
                raise ChannelClosedError(
                    f"channel {self.edge}: reader endpoint rejected the "
                    f"channel (torn down or dead)")
            try:
                # Connect BEFORE the window wait: acks only flow on a
                # live socket, and checking the window with no socket
                # would either deadlock (never connected) or bypass it
                # (just dropped) — the bypass could overrun the
                # reader's bounded inbox.
                with self._send_lock:
                    sock = self._connect()
                # Credit window: at most `capacity` unconsumed messages
                # in flight (acks applied by _ack_loop on this socket).
                with self._ack_cond:
                    while (seq - self._acked > self.capacity
                           and not self._peer_gone
                           and self._sock_dead is None):
                        step = 0.5 if deadline is None else max(
                            0.0, min(0.5, deadline - time.monotonic()))
                        self._ack_cond.wait(step)
                        if (deadline is not None
                                and time.monotonic() > deadline):
                            raise ChannelTimeoutError(
                                "peer write blocked on credit window",
                                edge=self.edge, seq=seq,
                                bytes_in_flight=self._sent_bytes
                                - self._acked_bytes,
                                peer_alive=self._peer_alive())
                with self._send_lock:
                    if self._sock is not sock:
                        raise OSError("socket superseded mid-emit")
                    _sendmsg_all(sock, [memoryview(hdr)] + parts)
                with self._ack_cond:
                    self._sent_bytes += size
                    self._inflight_sizes[seq] = size
                    floor = self._acked
                if witness:
                    _chandbg.note_send(self._witness_key(), seq, size,
                                       window=(floor, self.capacity))
                return
            except (ChannelClosedError, ChannelTimeoutError):
                raise
            except OSError as e:
                last_err = e
                self._drop_sock()
                alive = self._peer_alive()
                if alive is False:
                    break
                time.sleep(0.1)
        raise ChannelClosedError(
            f"channel {self.edge}: send to reader failed (seq={seq}, "
            f"peer_alive={self._peer_alive()}): {last_err!r}")

    def _drop_sock(self) -> None:
        sock, self._sock = self._sock, None
        if sock is not None:
            _shutdown(sock)

    # ------------------------------------------------------------ teardown

    def wait_consumed(self, seq: int, timeout: float = 10.0) -> bool:
        deadline = time.monotonic() + timeout
        with self._ack_cond:
            while self._acked < seq:
                if (self._sock_dead is not None
                        or time.monotonic() > deadline):
                    return self._acked >= seq
                self._ack_cond.wait(0.1)
        return True

    def drain(self, from_seq: int, span: int = 0) -> None:
        self.close()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._drop_sock()
        if self._registered:
            get_endpoint().unregister(self.channel_id)
            head = _head_client()
            if head is not None:
                try:
                    head.notify("channel_unregister", self.channel_id)
                except Exception as e:  # noqa: BLE001 — the register cap
                    # and death scrub bound a missed unregister
                    logger.debug("channel_unregister failed: %r", e)

    def __reduce__(self):
        return (CrossNodeChannel,
                (self.channel_id, self.writer_node_addr,
                 self.reader_node_addr, self.capacity, self.edge,
                 self._addr))
