"""Framed RPC substrate for the control plane (DCN traffic).

Parity target: the reference's gRPC layer (reference: src/ray/rpc/
grpc_server.h, retryable_grpc_client.h, rpc_chaos.h) re-designed small:
length-prefixed pickled frames over TCP, a threaded server (one reader thread
per peer — control-plane fan-in is O(workers/node), not O(tasks)), and a
thread-safe client with request pipelining (many in-flight calls multiplexed
over one socket, matched by request id).

Payloads are tuples:
    (req_id, method, args)        request  (req_id > 0)
    (0, method, args)             one-way notify
    (-req_id, ok: bool, result)   response

Two frame forms on the wire:

  legacy   u32 len | flat Serializer encoding        (small messages)
  scatter  u32 (0x80000000 | header_len) | u32 nbufs | i64 rid |
           u64 buf_len[nbufs] | header | buffers...

The scatter form carries the payload's pickle-5 out-of-band buffers as raw
trailing segments: the sender feeds them straight to ``sendmsg`` (payloads
holding large numpy arrays / shm views are never flattened host-side), and
the receiver lands each one in a freshly ``recv_into``-ed buffer — or, for
a response whose caller registered a sink (``RpcClient.call_into``),
DIRECTLY into the caller-supplied memoryview (e.g. a shm ``create_buffer``
view), so a pulled object chunk crosses the host at most once. The ``rid``
rides outside the pickle so the reader can route buffers before decoding.

Every connection opens with ``PORT_TAG``, eight bytes that a server
checks before it reads a frame: a process of this package never talks to
a ``ray_tpu`` head, node or worker, and the other way round, when both run
on one host.

Retry-safety contract: every ``rpc_*`` handler appears in exactly one of
the classification sets below.

- ``READONLY_RPCS``: pure queries, safe to re-deliver.
- ``IDEMPOTENT_RPCS``: mutating, but at-most-once by design (a dedup key
  or a state check makes a re-delivered request a no-op returning the
  same response).
- ``ACKED_RETRY_RPCS``: safe to retry because the caller drives an
  acked-retry loop with explicit loss handling.
- ``NON_RETRYABLE_RPCS``: everything else, declared: one-way notifies,
  availability nudges, outbox-ordered directory frames.

``RETRY_SAFE_RPCS`` (the ``retrying_call`` gate) is the union of the
first three.

Chaos injection, two tiers (as ``ray_tpu``'s): ``rpc_chaos_failure_prob``
drops requests or replies blindly, but only of methods in
``RETRY_SAFE_RPCS``; ``chaos_plan`` / ``RTPU_CHAOS_PLAN``
(``devtools/chaos.py``) applies a seeded plan by (method, role, peer, nth
call) at the dispatch and reply seams below. Under ``RTPU_DEBUG_RPC=1``
(``devtools/rpc_debug.py``) a dispatched method in none of the sets fails
loudly and idempotent requests are delivered twice with their replies
compared; under ``RTPU_DEBUG_RES=1`` every ``BufferLease`` registers in
the resource witness; under ``RTPU_DEBUG_LOCKS=1`` the module's locks are
witnessed.
"""

from __future__ import annotations

import itertools
import os
import random
import socket
import socketserver
import struct
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg
from ray_tpu_torch.core.serialization import SERIALIZER
from ray_tpu_torch.devtools import chaos as _chaos
from ray_tpu_torch.devtools import res_debug as _resdbg
from ray_tpu_torch.devtools import rpc_debug as _rpcdbg
from ray_tpu_torch.devtools.chaos import chaos_enabled as _chaos_enabled
from ray_tpu_torch.devtools.lock_debug import make_lock
from ray_tpu_torch.util import flight_recorder as _flight

_LEN = struct.Struct("<I")

#: The first bytes of every connection (see the module docstring).
PORT_TAG = b"RTTORCH1"


def _dial(host: str, port: int, timeout: float) -> socket.socket:
    """Connect and send ``PORT_TAG``."""
    sock = socket.create_connection((host, port), timeout=timeout)
    try:
        sock.sendall(PORT_TAG)
    except BaseException:
        _shutdown_socket(sock)
        raise
    return sock


class RpcError(Exception):
    pass


class ConnectionLost(RpcError):
    pass


class RemoteError(RpcError):
    """Handler raised; .cause carries the remote exception object."""

    def __init__(self, cause):
        super().__init__(repr(cause))
        self.cause = cause


_SCATTER_BIT = 0x80000000
_SCATTER_META = struct.Struct("<Iq")  # nbufs, rid
# At most this many out-of-band segments per frame (IOV sanity; payloads
# with more buffers flatten to the legacy form).
_SCATTER_MAX_BUFS = 256


class BufferLease:
    """Wraps an RPC handler's result whose out-of-band buffers BORROW
    memory (e.g. pinned shm views): the payload is sent scatter-gather
    straight from the borrowed views — no ``bytes()`` staging copy — and
    ``release`` runs once the frame is on the socket (or dropped).
"""

    __slots__ = ("value", "_release")

    def __init__(self, value: Any, release: Callable):
        self.value = value
        self._release = _resdbg.wrap_release("buffer_lease", release,
                                             owner=self)

    def release(self) -> None:
        rel, self._release = self._release, None
        if rel is not None:
            try:
                rel()
            except Exception:
                pass


def _shutdown_socket(sock: socket.socket) -> None:
    """shutdown + close: unlike a bare close(), shutdown() reliably wakes
    any thread blocked in recv on the socket (close only frees the fd)."""
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


def _as_byte_view(b) -> memoryview:
    mv = b if isinstance(b, memoryview) else memoryview(b)
    if mv.ndim != 1 or mv.format != "B":
        mv = mv.cast("B")
    return mv


def _payload_parts(payload: Any) -> list:
    """Serialize a payload into wire parts. One part (legacy frame) for
    small / buffer-free payloads; otherwise a scatter frame whose large
    buffers are passed through as separate segments for ``sendmsg`` —
    large objects are never flattened host-side."""
    header, buffers = SERIALIZER.serialize(payload)
    if buffers and len(buffers) <= _SCATTER_MAX_BUFS:
        oob = sum(b.nbytes for b in buffers)
        if oob >= cfg.rpc_scatter_min_bytes:
            rid = payload[0] if type(payload) is tuple and payload and \
                isinstance(payload[0], int) else 0
            prefix = (struct.pack("<I", _SCATTER_BIT | len(header))
                      + _SCATTER_META.pack(len(buffers), rid)
                      + struct.pack("<%dQ" % len(buffers),
                                    *(b.nbytes for b in buffers)))
            return [memoryview(prefix), memoryview(header)] + [
                _as_byte_view(b) for b in buffers]
    total = SERIALIZER.encode_total_size(header, buffers)
    if total >= _SCATTER_BIT:
        # The length prefix's top bit is the scatter flag: a >=2 GiB flat
        # frame would be misparsed as a scatter header on the receiver and
        # desynchronize the connection. In-band payloads this large are
        # pathological (big values go through the object store) — fail
        # loudly at the sender instead.
        raise ValueError(
            f"RPC frame of {total} bytes exceeds the 2 GiB flat-frame "
            "limit; pass large data via the object store or as pickle-5 "
            "out-of-band buffers")
    out = bytearray(4 + total)
    _LEN.pack_into(out, 0, total)
    SERIALIZER.encode_into(memoryview(out)[4:], header, buffers)
    return [memoryview(out)]


def _sendmsg_all(sock: socket.socket, views: list) -> None:
    """Gather-send every view (handles partial sends and IOV limits)."""
    while views:
        sent = sock.sendmsg(views[:_SCATTER_MAX_BUFS + 8])
        i = 0
        while i < len(views) and sent >= len(views[i]):
            sent -= len(views[i])
            i += 1
        views = views[i:]
        if views and sent:
            views[0] = views[0][sent:]


def _send_payload(sock: socket.socket, payload: Any,
                  lock: threading.Lock) -> None:
    parts = _payload_parts(payload)
    with lock:
        _sendmsg_all(sock, parts)


def _send_frame(sock: socket.socket, payload: bytes,
                lock: threading.Lock) -> None:
    """Send a pre-encoded flat payload as a legacy frame."""
    with lock:
        _sendmsg_all(sock, [memoryview(_LEN.pack(len(payload))),
                            _as_byte_view(payload)])


def _recv_exact_into(sock: socket.socket, view: memoryview) -> bool:
    """Fill ``view`` from the socket via recv_into — a single preallocated
    (or shm-destined) destination, no chunk list + join copy."""
    pos, n = 0, len(view)
    while pos < n:
        try:
            r = sock.recv_into(view[pos:],
                               min(n - pos, cfg.rpc_recv_chunk_bytes))
        except OSError:
            return False
        if not r:
            return False
        pos += r
    return True


def _recv_msg(sock: socket.socket, sink_for: Optional[Callable] = None
              ) -> Optional[Tuple[Any, bool]]:
    """Receive + decode one frame. Returns (payload, sink_used) or None on
    EOF/error. ``sink_for(rid, lens)`` may return caller-owned writable
    views to land a scatter frame's buffers in (zero staging copy)."""
    hdr = bytearray(4)
    if not _recv_exact_into(sock, memoryview(hdr)):
        return None
    (n,) = _LEN.unpack(hdr)
    if not n & _SCATTER_BIT:
        buf = memoryview(bytearray(n))
        if not _recv_exact_into(sock, buf):
            return None
        try:
            return SERIALIZER.decode(buf), False
        except Exception:
            return None
    hlen = n & ~_SCATTER_BIT
    meta = bytearray(_SCATTER_META.size)
    if not _recv_exact_into(sock, memoryview(meta)):
        return None
    nbufs, rid = _SCATTER_META.unpack(meta)
    if nbufs > _SCATTER_MAX_BUFS:
        return None  # corrupt frame
    lens_raw = bytearray(8 * nbufs)
    if not _recv_exact_into(sock, memoryview(lens_raw)):
        return None
    lens = struct.unpack("<%dQ" % nbufs, lens_raw)
    header = bytearray(hlen)
    if not _recv_exact_into(sock, memoryview(header)):
        return None
    sinks = sink_for(rid, lens) if sink_for is not None else None
    buffers = []
    for i, blen in enumerate(lens):
        dest = sinks[i] if sinks is not None else memoryview(
            bytearray(blen))
        if not _recv_exact_into(sock, dest):
            return None
        buffers.append(dest)
    try:
        return SERIALIZER.deserialize(bytes(header), buffers), \
            sinks is not None
    except Exception:
        return None


#: Pure queries: blind-droppable (callers retry or poll), re-delivery
#: is harmless, but responses may differ call-to-call (stats move, time
#: passes) so the duplicate-delivery audit does not compare them.
READONLY_RPCS = frozenset({
    "ping", "list_nodes", "list_actors", "list_leases", "list_task_events",
    "cluster_resources", "cluster_leases", "get_actor_info",
    "get_named_actor", "get_trace", "trace_tail", "trace_stats",
    "clock_probe", "dump_flight", "pick_node", "pick_nodes",
    "object_locations", "scheduler_stats", "pg_table", "pg_ready",
    "kv_get", "kv_keys", "get_demand", "has_object", "store_stats",
    "spawn_stats",
    # channel negotiation: endpoint + liveness read (writers poll it
    # during the one-time negotiation and on timeout liveness probes).
    # The streaming Dataset executor's inter-operator edges and the
    # channel shuffle mesh (data/_executor.py, data/_exchange.py) ride
    # these same three channel RPCs — the data plane adds NO new
    # handlers to classify.
    "channel_lookup",
    "pull_stats", "wait_object", "wait_objects", "get_object",
    "stream_consumed", "wait_actor_address",
    # chunk serving is a pure read of a sealed object (the pull
    # manager's fan-out retries recover lost chunks)
    "fetch_object",
})

#: At-most-once by dedup key / state check: a re-delivered request is a
#: no-op returning the SAME response.
IDEMPOTENT_RPCS = frozenset({
    "register_node", "register_actor", "register_worker",
    "request_lease", "return_lease", "create_actor", "create_pg",
    "remove_pg", "reserve_bundle", "release_bundle", "mark_actor_host",
    "push_tasks", "push_actor_batch", "pull_object", "pull_direct",
    "push_object", "subscribe", "unsubscribe",
    "kv_put", "kv_del", "drain_node",
    # rolling-upgrade handover: draining twice is draining (the
    # checkpoint re-runs, the summary re-reads), and resume just clears
    # the flag — both safe to retry or re-deliver
    "prepare_upgrade", "resume_serving",
    # channel negotiation: register overwrites with the same entry
    # (re-delivery is a no-op returning True), unregister of an
    # already-gone channel is True — the state "not registered" holds
    "channel_register", "channel_unregister",
    # lease blocks (owner-routed steady-state dispatch): grant/renew
    # memo the reply by caller-supplied block_id (a retry returns the
    # SAME grant), install re-applies the same block (no-op when
    # present), and revoke of an unknown/already-revoked block is True
    # — the state "not installed" holds either way
    "lease_block_grant", "lease_block_renew", "lease_block_revoke",
    "lease_block_install",
})

#: Caller-side acked-retry loops with explicit loss handling; a
#: duplicate may observably differ (new_job_id burns an id) but the
#: protocol tolerates it by construction.
ACKED_RETRY_RPCS = frozenset({
    "heartbeat", "kill_actor", "actor_died", "worker_dead_at",
    "task_done", "actor_call_done", "batch_done", "new_job_id",
})

#: Methods safe for BLIND probabilistic drops (see module docstring for
#: the full contract): the union of the three recovery groups above.
RETRY_SAFE_RPCS = READONLY_RPCS | IDEMPOTENT_RPCS | ACKED_RETRY_RPCS

#: Explicitly NOT retry-safe: one-way notifies whose loss is tolerated
#: by design, ordering-sensitive outbox frames, observability flushes,
#: and the client-gateway session surface. Declared so that "forgot to
#: classify" is distinguishable from "classified as unsafe".
NON_RETRYABLE_RPCS = frozenset({
    # loss tolerated by transfer pins / periodic re-flush
    "add_borrowers", "remove_borrower",
    # best-effort recovery nudge (owner re-checks liveness itself)
    "recover_object",
    # availability nudges: a lost unblock self-corrects at lease return
    "worker_blocked", "worker_unblocked",
    # outbox-ordered object-directory frames: re-delivery or reordering
    # inverts add/remove pairs — they ride ONE
    # batched outbox per process, never a retry loop
    "object_added", "object_removed", "object_batch",
    # observability / control flushes (best-effort by contract)
    "trace_spans", "publish", "report_task_events", "report_backlog",
    # cancellation: re-delivery could cancel a legitimately re-executed
    # retry of the same task id
    "cancel_task",
    # client-gateway session surface: the remote driver has no
    # caller-side retry loop, and session state (held refs, actor
    # ownership) makes duplicates observable
    "client_hello", "put", "get", "wait", "release", "hold",
    "submit_task", "cancel", "client_create_actor", "submit_actor_task",
    "get_actor", "nodes", "kv",
})


# Per-method handler accounting (reference: common/event_stats.h — the
# structural defense for event-loop discipline). Cheap enough to default
# on: one dict update per RPC. Read at call time so _system_config /env
# overrides work like every other flag.
def _stats_on() -> bool:
    return bool(cfg.event_stats_enabled)


# Lock-free per-thread accumulation, folded on read: the old single global
# lock serialized every RPC dispatch across every peer connection — the
# stats meant to OBSERVE the multi-peer dispatch path were throttling it.
# Each dispatch thread appends to its own dict (GIL-atomic); the rare
# reader folds all thread dicts. Per-field tearing across a concurrent
# update is possible and acceptable for monitoring counters.
_event_stats_local = threading.local()
_event_stats_all: list = []  # [per-thread {method: [count, errors, total_s, max_s]}]
_event_stats_retired: dict = {}  # folded dicts of finished recorder threads
_event_stats_lock = threading.Lock()  # guards registration + fold only


def _fold_into(out: dict, d: dict) -> None:
    for m, s in list(d.items()):
        agg = out.get(m)
        if agg is None:
            agg = out[m] = [0, 0, 0.0, 0.0]
        agg[0] += s[0]
        agg[1] += s[1]
        agg[2] += s[2]
        agg[3] = max(agg[3], s[3])


def _record_event_stat(method: str, seconds: float, ok: bool) -> None:
    d = getattr(_event_stats_local, "d", None)
    if d is None:
        d = _event_stats_local.d = {}
        with _event_stats_lock:
            _event_stats_all.append((threading.current_thread(), d))
            if len(_event_stats_all) > 512:
                # Short-lived dispatch threads (one per blocking RPC) must
                # not grow the registry without bound: fold DEAD threads'
                # dicts into the cumulative retired aggregate. Live ones
                # stay (their dicts still receive updates).
                live = []
                for t, od in _event_stats_all:
                    if t.is_alive():
                        live.append((t, od))
                    else:
                        _fold_into(_event_stats_retired, od)
                _event_stats_all[:] = live
    s = d.get(method)
    if s is None:
        s = d[method] = [0, 0, 0.0, 0.0]
    s[0] += 1
    if not ok:
        s[1] += 1
    s[2] += seconds
    if seconds > s[3]:
        s[3] = seconds


def get_event_stats() -> dict:
    with _event_stats_lock:
        snapshot = [d for _t, d in _event_stats_all]
        folded: dict = {m: list(s) for m, s in _event_stats_retired.items()}
    for d in snapshot:
        _fold_into(folded, d)
    return {m: {"count": s[0], "errors": s[1], "total_s": s[2],
                "max_s": s[3]}
            for m, s in folded.items()}


# --------------------------------------------------------------------------
# Server
# --------------------------------------------------------------------------


def _chaos_drop(method: str) -> bool:
    p = cfg.rpc_chaos_failure_prob
    return (p > 0 and method in RETRY_SAFE_RPCS
            and random.random() < p)


class RpcServer:
    """Threaded frame server. ``handler_obj`` methods named ``rpc_<method>``
    are callable remotely; each gets (conn, *args) where conn is the
    per-connection context (usable for push-back / peer identity)."""

    def __init__(self, handler_obj: Any, host: str = "127.0.0.1",
                 port: int = 0):
        self.handler_obj = handler_obj
        # Fault-injection scope: chaos-plan rules target the RECEIVING
        # process by the role its handler declares (head / node / worker
        # / driver — set by HeadServer, NodeManager, ClusterCore).
        self.chaos_role = getattr(handler_obj, "chaos_role", "")
        outer = self

        class _Handler(socketserver.BaseRequestHandler):
            def handle(self) -> None:  # one thread per peer connection
                # Replies are latency-critical small frames: without
                # NODELAY, Nagle + delayed ACK can stall each response up
                # to 40ms (clients already set it; servers must too).
                self.request.setsockopt(socket.IPPROTO_TCP,
                                        socket.TCP_NODELAY, 1)
                tag = bytearray(len(PORT_TAG))
                if (not _recv_exact_into(self.request, memoryview(tag))
                        or bytes(tag) != PORT_TAG):
                    return  # not a peer of this package: drop it unread
                conn = PeerConnection(self.request, outer)
                try:
                    outer._on_connect(conn)
                    while True:
                        msg = _recv_msg(self.request)
                        if msg is None:
                            return
                        outer._dispatch(conn, msg[0])
                finally:
                    outer._on_disconnect(conn)

        class _Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True
            # Connection storms (scale tests: hundreds of workers
            # registering at once) overflow the default backlog of 5.
            request_queue_size = cfg.rpc_listen_backlog

        self._server = _Server((host, port), _Handler)
        self.address = "%s:%d" % self._server.server_address
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name=f"rpc-server-{self.address}")
        self._conn_hooks = []
        # Live peer connections: severed on stop() — server_close() only
        # closes the LISTENING socket, and a handler thread parked in
        # recv on an established peer socket would keep serving a
        # "stopped" server's stale state indefinitely (peers must fail
        # over to the replacement, not talk to a zombie).
        self._conns: set = set()
        self._conns_lock = make_lock("protocol.server._conns_lock")

    def start(self) -> "RpcServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        try:
            self._server.shutdown()
            self._server.server_close()
        except Exception:  # rtpu-lint: disable=swallowed-exception — best-effort teardown
            pass
        # serve_forever returns after shutdown(): join so teardown is
        # ordered (no acceptor thread outliving its server object).
        self._thread.join(timeout=2.0)
        with self._conns_lock:
            conns, self._conns = list(self._conns), set()
        for conn in conns:
            _shutdown_socket(conn.sock)

    def _on_connect(self, conn: "PeerConnection") -> None:
        with self._conns_lock:
            self._conns.add(conn)

    def _on_disconnect(self, conn: "PeerConnection") -> None:
        with self._conns_lock:
            self._conns.discard(conn)
        hook = getattr(self.handler_obj, "on_peer_disconnect", None)
        if hook is not None:
            try:
                hook(conn)
            except Exception:
                pass

    def _dispatch(self, conn: "PeerConnection", payload) -> None:
        req_id, method, args = payload
        # Flight recorder: one ring append per dispatched RPC — the
        # post-mortem record of what this process was serving in the
        # seconds before a kill (heartbeats are recorded by their loops).
        if method != "heartbeat":
            _flight.record("rpc", m=method, notify=req_id == 0)
        if _chaos_enabled():
            if _chaos.apply(self.chaos_role, method, "request",
                            conn) is not None:
                return  # plan dropped the request / severed the peer
            if _chaos_drop(method):
                return  # request lost (blind mode, retry-safe only)
        fn = getattr(self.handler_obj, "rpc_" + method, None)
        # RTPU_DEBUG_RPC witness: off, ``audit`` stays None and the
        # handler runs directly; on, every dispatched method must be
        # classified, and idempotent requests are delivered twice with
        # their replies compared.
        audit = _rpcdbg.dispatch_audit(method, self.handler_obj) \
            if _rpcdbg.enabled() else None

        def run():
            t0 = time.monotonic() if _stats_on() else 0.0
            lease = None
            try:
                if fn is None:
                    raise RpcError(f"no such rpc method: {method}")
                if audit is not None:
                    result = audit(fn, conn, args)
                else:
                    result = fn(conn, *args)
                ok = True
            except BaseException as e:  # noqa: BLE001
                result, ok = e, False
            if isinstance(result, BufferLease):
                lease, result = result, result.value
            if _stats_on():
                _record_event_stat(method, time.monotonic() - t0, ok)
            try:
                if req_id > 0:
                    lost = False
                    if _chaos_enabled():
                        lost = (_chaos.apply(self.chaos_role, method,
                                             "response", conn) is not None
                                or _chaos_drop(method))
                    if not lost:
                        try:
                            conn.send_payload((-req_id, ok, result))
                        except Exception:
                            pass
            finally:
                if lease is not None:
                    lease.release()

        # Fast handlers run inline; blocking ones (marked) get a thread so
        # one slow call can't head-of-line-block the peer's other requests.
        if getattr(fn, "_rpc_blocking", False):
            threading.Thread(target=run, daemon=True,
                             name=f"rpc-{method}").start()
        else:
            run()


def blocking_rpc(fn: Callable) -> Callable:
    """Mark an rpc_ handler as potentially blocking (gets its own thread)."""
    fn._rpc_blocking = True
    return fn


class PeerConnection:
    """Server-side view of one connected peer."""

    def __init__(self, sock: socket.socket, server: RpcServer):
        self.sock = sock
        self.server = server
        self.send_lock = make_lock("protocol.send_lock")
        self.peer_info: Dict[str, Any] = {}  # set by register handlers

    def send_payload(self, payload) -> None:
        _send_payload(self.sock, payload, self.send_lock)

    def send_raw(self, payload: bytes) -> None:
        _send_frame(self.sock, payload, self.send_lock)

    def notify(self, method: str, *args) -> None:
        """Server->client push (client must run a ClientListener)."""
        self.send_payload((0, method, args))


# --------------------------------------------------------------------------
# Client
# --------------------------------------------------------------------------


class RpcClient:
    """Thread-safe client: many in-flight requests over one socket.

    ``on_push`` (optional) handles server->client notify frames
    (method, args). Reconnects are NOT transparent: callers use
    `retrying_call` for idempotent methods.
    """

    def __init__(self, address: str, on_push: Optional[Callable] = None,
                 connect_timeout: Optional[float] = None,
                 on_close: Optional[Callable] = None):
        host, port = address.rsplit(":", 1)
        self.address = address
        self._on_close = on_close
        self._sock = _dial(host, int(port),
                           connect_timeout or cfg.rpc_connect_timeout_s)
        self._sock.settimeout(None)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._send_lock = make_lock("protocol._send_lock")
        self._req_counter = itertools.count(1)
        self._pending: Dict[int, "_Waiter"] = {}
        self._pending_lock = make_lock("protocol._pending_lock")
        #: req_id -> writable memoryview: the reader lands a scatter
        #: response's single buffer directly here (see call_into).
        self._sinks: Dict[int, memoryview] = {}
        self._on_push = on_push
        self._closed = False
        self._alive = True
        self._start_reader(self._sock)

    def _start_reader(self, sock: socket.socket) -> None:
        threading.Thread(target=self._read_loop, args=(sock,), daemon=True,
                         name=f"rpc-client-{self.address}").start()

    def _take_sink(self, rid: int, lens) -> Optional[list]:
        """Reader-side sink routing: a response whose caller registered a
        destination view (call_into) and whose single buffer matches it
        exactly lands straight in that view."""
        if rid >= 0:
            return None
        with self._pending_lock:
            mv = self._sinks.get(-rid)
            if mv is None or len(lens) != 1 or lens[0] != len(mv):
                return None
            del self._sinks[-rid]
            return [mv]

    def _read_loop(self, sock: socket.socket) -> None:
        """Reader bound to one socket generation. A reconnect() superseded
        reader exits silently: it must neither steal frames from the new
        socket nor fail waiters registered on the fresh connection."""
        while not self._closed:
            if sock is not self._sock:
                return  # superseded by reconnect(); new reader owns state
            msg = _recv_msg(sock, self._take_sink)
            if msg is None:
                break
            (rid, a, b), sink_used = msg
            if rid == 0:
                if self._on_push is not None:
                    try:
                        self._on_push(a, b)
                    except Exception:
                        pass
                continue
            with self._pending_lock:
                waiter = self._pending.pop(-rid, None)
            if waiter is not None:
                waiter.sink_used = sink_used
                waiter.set(a, b)
        # Connection died: fail waiters — but only if we are still the
        # CURRENT reader (reconnect() already failed/migrated the old ones).
        with self._pending_lock:
            if sock is not self._sock:
                return
            self._alive = False
            pending, self._pending = self._pending, {}
            self._sinks.clear()
        for w in pending.values():
            w.fail(ConnectionLost(self.address))
        if self._on_close is not None and not self._closed:
            try:
                self._on_close(self)
            except Exception:
                pass

    def call_async(self, method: str, *args,
                   _sink: Optional[memoryview] = None) -> "_Waiter":
        """Fire a request and return its waiter without blocking: callers
        pipeline many requests then collect acks (the dispatcher's push path
        needs in-flight depth without one thread per push)."""
        rid = next(self._req_counter)
        waiter = _Waiter()
        waiter._rid = rid
        waiter._client = self
        with self._pending_lock:
            if self._closed:
                raise ConnectionLost(self.address)
            self._pending[rid] = waiter
            if _sink is not None:
                self._sinks[rid] = _sink
        try:
            _send_payload(self._sock, (rid, method, args), self._send_lock)
        except OSError as e:
            with self._pending_lock:
                self._pending.pop(rid, None)
                self._sinks.pop(rid, None)
            raise ConnectionLost(f"{self.address}: {e}") from e
        return waiter

    def call(self, method: str, *args, timeout: Optional[float] = None) -> Any:
        waiter = self.call_async(method, *args)
        try:
            return waiter.wait(timeout)
        except TimeoutError:
            # Drop the stale waiter so a late reply doesn't pile up state.
            with self._pending_lock:
                self._pending.pop(waiter._rid, None)
            raise

    def call_into(self, method: str, *args, sink: memoryview,
                  timeout: Optional[float] = None) -> Tuple[Any, bool]:
        """call(), but a scatter response whose single out-of-band buffer
        is exactly ``len(sink)`` bytes is received DIRECTLY into ``sink``
        (e.g. a shm create_buffer view) — no staging copy. Returns
        (result, landed): when ``landed`` is True the result's buffer IS a
        view of ``sink`` and the bytes are already in place."""
        waiter = self.call_async(method, *args, _sink=sink)
        try:
            result = waiter.wait(timeout)
        except TimeoutError:
            with self._pending_lock:
                untouched = self._sinks.pop(waiter._rid, None) is not None
                if untouched or waiter._event.is_set():
                    # Reader never took the sink (or already finished):
                    # safe to hand the memory back to the caller.
                    self._pending.pop(waiter._rid, None)
                    raise
            # The reader popped the sink and is landing the late response
            # INTO the caller's view right now. Returning would let it
            # keep writing after the caller frees/reuses that memory
            # (e.g. a shm block aborted and reallocated) — wait for the
            # frame to finish; a wedged peer is cut off by shutting the
            # socket down, which errors the reader's recv out of the sink.
            if not waiter._event.wait(30.0):
                _shutdown_socket(self._sock)
                waiter._event.wait(30.0)
            with self._pending_lock:
                self._pending.pop(waiter._rid, None)
            raise
        finally:
            # Non-scatter / mismatched replies leave the sink registered.
            with self._pending_lock:
                self._sinks.pop(waiter._rid, None)
        return result, waiter.sink_used

    def notify(self, method: str, *args) -> None:
        _send_payload(self._sock, (0, method, args), self._send_lock)

    def retrying_call(self, method: str, *args,
                      timeout: Optional[float] = None) -> Any:
        """For idempotent methods: retry on timeouts/connection loss (chaos
        tolerance). Reconnects the socket between attempts.

        Timeouts stop after ``rpc_retry_max_attempts`` (worst case is
        unchanged: attempts x per-try timeout). INSTANT connection
        failures (refused connect to a dead-but-respawning peer) keep
        retrying for at least ``rpc_retry_min_window_s``: pure attempt
        counting burns all five tries in ~3s of backoff, which is less
        than a SIGKILL'd head or node takes to respawn — the chaos
        scenarios fail exactly there without the window."""
        attempts = cfg.rpc_retry_max_attempts
        delay = cfg.rpc_retry_delay_ms / 1000.0
        per_try = timeout if timeout is not None else 5.0
        start = time.monotonic()
        window = cfg.rpc_retry_min_window_s
        i = 0
        while True:
            try:
                return self.call(method, *args, timeout=per_try)
            except (TimeoutError, ConnectionLost) as e:
                if isinstance(e, ConnectionLost):
                    try:
                        self.reconnect()
                    except OSError:
                        pass
                i += 1
                elapsed = time.monotonic() - start
                if i >= attempts and (isinstance(e, TimeoutError)
                                      or elapsed >= window):
                    raise
                time.sleep(min(delay * (2 ** min(i, 6)), 2.0))

    def reconnect(self) -> None:
        host, port = self.address.rsplit(":", 1)
        new_sock = _dial(host, int(port), cfg.rpc_connect_timeout_s)
        try:
            new_sock.settimeout(None)
            new_sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except BaseException:
            # Not yet published to self._sock: nobody else can ever
            # close this fd — it would leak once per failed reconnect.
            _shutdown_socket(new_sock)
            raise
        with self._pending_lock:
            old = self._sock
            self._sock = new_sock  # supersede the old reader atomically
            self._alive = True
            # Requests in flight on the old socket will never be answered.
            pending, self._pending = self._pending, {}
            self._sinks.clear()
        # Tear the old socket down BEFORE failing waiters: the superseded
        # reader may be mid-recv_into a call_into sink (caller-owned shm),
        # and a failed waiter lets its caller free/reuse that memory.
        # shutdown() — not just close() — is what actually wakes a thread
        # blocked in recv on another fd reference.
        _shutdown_socket(old)
        for w in pending.values():
            w.fail(ConnectionLost(f"{self.address}: reconnected"))
        self._start_reader(new_sock)

    def close(self) -> None:
        self._closed = True
        _shutdown_socket(self._sock)


class _Waiter:
    __slots__ = ("_event", "_ok", "_result", "_exc", "_rid", "_client",
                 "sink_used")

    def __init__(self):
        self._event = threading.Event()
        self._ok = None
        self._result = None
        self._exc = None
        self._rid = 0
        self._client = None
        self.sink_used = False  # response buffer landed in a call_into sink

    def set(self, ok: bool, result: Any) -> None:
        self._ok, self._result = ok, result
        self._event.set()

    def fail(self, exc: Exception) -> None:
        self._exc = exc
        self._event.set()

    def wait(self, timeout: Optional[float]) -> Any:
        if not self._event.wait(timeout):
            raise TimeoutError("rpc call timed out")
        if self._exc is not None:
            raise self._exc
        if not self._ok:
            if isinstance(self._result, BaseException):
                raise self._result
            raise RemoteError(self._result)
        return self._result


class ClientPool:
    """Caches one RpcClient per address (process-wide).

    Connection CREATION runs under a per-address lock, not the pool
    lock: a fan-out over N fresh peers (the head's lease census at 100
    nodes) otherwise serializes N TCP connects behind one global lock —
    the pool's own bookkeeping is microseconds, the connects are not."""

    def __init__(self):
        self._clients: Dict[str, RpcClient] = {}
        self._creating: Dict[str, threading.Lock] = {}
        self._lock = make_lock("protocol.client_pool._lock")

    @staticmethod
    def _upgrade(c: RpcClient, on_push: Optional[Callable],
                 on_close: Optional[Callable]) -> RpcClient:
        # Upgrade: a later caller may care about conn-loss or push
        # frames on a connection first opened by a caller that
        # didn't. Without the on_push half, a cached client created
        # push-less silently DROPPED every later caller's server
        # pushes for the life of the connection.
        if on_close is not None and c._on_close is None:
            c._on_close = on_close
        if on_push is not None and c._on_push is None:
            c._on_push = on_push
        return c

    def get(self, address: str, on_push: Optional[Callable] = None,
            on_close: Optional[Callable] = None) -> RpcClient:
        with self._lock:
            c = self._clients.get(address)
            if c is not None and not c._closed and c._alive:
                return self._upgrade(c, on_push, on_close)
            mk = self._creating.setdefault(address, threading.Lock())
        with mk:
            with self._lock:
                c = self._clients.get(address)
                if c is not None and not c._closed and c._alive:
                    return self._upgrade(c, on_push, on_close)
            # A client whose socket died (reader exited) must not be
            # handed out again: replace it with a fresh connection —
            # dialed WITHOUT the pool lock (two addresses connect
            # concurrently; the per-address lock stops a thundering
            # herd on one address).
            c = RpcClient(address, on_push=on_push, on_close=on_close)
            with self._lock:
                self._clients[address] = c
            return c

    def invalidate(self, address: str) -> None:
        # _creating entries are deliberately NEVER popped: a dial may be
        # in flight under that lock right now, and replacing the lock
        # would let a second dial race it — the loser's client would be
        # overwritten in _clients and leak its socket + reader thread.
        # One tiny Lock per distinct address ever dialed is bounded by
        # the same set that bounds _clients itself.
        with self._lock:
            c = self._clients.pop(address, None)
        if c is not None:
            c.close()

    def close_all(self) -> None:
        with self._lock:
            clients, self._clients = list(self._clients.values()), {}
        for c in clients:
            c.close()
