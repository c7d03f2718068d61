"""Same-node compiled-DAG transport: an SPSC shm ring buffer
(``ray_tpu/dag/ring.py``, the port's own copy).

A classic single-producer single-consumer byte ring over one mmap'd file
in /dev/shm: a steady-state hop is a memcpy into the ring plus one 8-byte
position publish — no store RPC, no scheduler, no head.

Layout (offsets in bytes)::

    0   magic   u32  (creator writes this LAST: attachers spin on it)
    4   version u32
    8   capacity u64   data bytes
    16  write_pos u64  monotonic byte cursor (writer-owned)
    24  read_pos  u64  monotonic byte cursor (reader-owned)
    32  read_seq  u64  messages consumed (reader-owned; backpressure +
                       wait_consumed read this)
    40  writer_closed u8 / reader_closed u8
    64  data[capacity]

Records never wrap:
``[u32 size | u32 kind | u64 seq | u64 clock | u32 crc | payload]``
padded to 8 bytes; when the contiguous tail is too small the writer
stamps a wrap marker (size = 0xFFFFFFFF) and continues at offset 0.
``clock``/``crc`` carry the RTPU_DEBUG_CHAN witness's Lamport stamp and
sampled payload checksum (``devtools/chan_debug.py``) and are 0 when the
witness is off, as in ``ray_tpu``'s layout v3.
Position publishes happen AFTER the payload memcpy, so the reader only
ever observes complete records (aligned 8-byte stores are atomic on
the platforms this runtime targets).

Rendezvous needs no coordination service: both endpoints derive the
ring path from the channel id and race ``O_CREAT|O_EXCL`` — the loser
attaches. Payloads larger than ``dag_ring_spill_bytes`` spill to a
side file the ring references; the writer pins each spill (RTPU_DEBUG_RES
kind ``channel_spill``) until it observes consumption and reclaims
unconsumed spills at close, so a dead reader cannot leak them.

Values travel as ``pickle.dumps(("ok", value), protocol=5)``: a CPU torch
tensor rides as it is (its storage's bytes), and a KV page keeps its
dtype. Ring and spill files are ``rtt-ring-*`` and ``rtt-spill-*``, the
port's own names, so ``ray_tpu``'s channels (``rtpu-*``) and the port's
never meet on one host.
"""

from __future__ import annotations

import mmap
import os
import pickle
import struct
import tempfile
import time
from typing import Any, List, Optional, Tuple

from ray_tpu_torch.dag.errors import ChannelClosedError, ChannelTimeoutError
from ray_tpu_torch.devtools import chan_debug as _chandbg
from ray_tpu_torch.devtools import res_debug as _resdbg

_MAGIC = 0x52545543  # "RTUC"
_VERSION = 3
_HDR = 64
_REC_HDR = 32  # <IIQQI = 28 bytes of header, padded to 8-alignment
_WRAP = 0xFFFFFFFF

# Record kinds (mirrored by the cross-node transport in peer.py).
KIND_OK = 0       # pickled ("ok", value)
KIND_ERR = 1      # pickled exception
KIND_STOP = 2     # stop sentinel (no payload)
KIND_SPILL = 8    # payload = utf-8 side-file name carrying a KIND_OK body
KIND_SPILL_ERR = 9  # side file carries a KIND_ERR body

_O_MAGIC = 0
_O_VERSION = 4
_O_CAP = 8
_O_WPOS = 16
_O_RPOS = 24
_O_RSEQ = 32
_O_WCLOSED = 40
_O_RCLOSED = 41

RING_PREFIX = "rtt-ring-"
SPILL_PREFIX = "rtt-spill-"


def channel_dir() -> str:
    """The node-local rendezvous directory for rings and spill files."""
    from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg

    d = cfg.dag_channel_dir
    if d:
        return d
    if os.path.isdir("/dev/shm"):
        return "/dev/shm"
    return tempfile.gettempdir()


def _align8(n: int) -> int:
    return (n + 7) & ~7


class _Waiter:
    """Latency-tiered wait for the ring's poll loops: pure spin for the
    first ~200 probes (a hop lands in tens of µs when the peer is
    active), then ``sleep(0)`` yields (stay runnable, surrender the
    core), then exponential timed sleeps (the kernel's minimum timed
    sleep is ~0.5 ms, so sleeping first would put that on every hop)."""

    __slots__ = ("spins", "pause")

    def __init__(self):
        self.spins = 0
        self.pause = 0.0002

    def wait(self) -> None:
        self.spins += 1
        if self.spins <= 200:
            return
        if self.spins <= 1200:
            time.sleep(0)
            return
        time.sleep(self.pause)
        self.pause = min(self.pause * 2, 0.005)


class RingChannel:
    """Single-writer single-reader ordered channel over one shm ring.

    Both endpoints construct it from the (serializable) ``channel_id``;
    whichever process touches the ring first creates the file, the
    other attaches. ``capacity`` bounds in-flight MESSAGES (the channel
    slots the compiled DAG pipelines against) and ``cfg.dag_ring_bytes``
    bounds in-flight BYTES.
    """

    transport = "ring"

    def __init__(self, channel_id: bytes, capacity: int = 8,
                 ring_bytes: Optional[int] = None, edge: str = ""):
        self.channel_id = channel_id
        self.capacity = capacity
        self.edge = edge or channel_id.hex()[:12]
        self._ring_bytes = ring_bytes
        self._mm: Optional[mmap.mmap] = None
        self._path: Optional[str] = None
        self._closed = False
        self._role: Optional[str] = None  # "w" | "r", set on first op
        self._read_seq = 0               # next seq this end expects
        # Writer-side spill ledger: (record_end_pos, path) pending
        # consumption; settled when read_pos passes end_pos, reclaimed
        # (unlinked) at close if the reader never got there.
        self._spills: List[Tuple[int, str]] = []

    # ------------------------------------------------------------- mapping

    def _ring_path(self) -> str:
        return os.path.join(channel_dir(),
                            f"{RING_PREFIX}{self.channel_id.hex()}.ch")

    def _ensure(self) -> mmap.mmap:
        if self._closed:
            raise ChannelClosedError(f"channel {self.edge} closed locally")
        if self._mm is not None:
            return self._mm
        from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg

        cap = self._ring_bytes or cfg.dag_ring_bytes
        path = self._ring_path()
        size = _HDR + cap
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
            creator = True
        except FileExistsError:
            fd = os.open(path, os.O_RDWR)
            creator = False
        try:
            if creator:
                os.ftruncate(fd, size)
                mm = mmap.mmap(fd, size)
                struct.pack_into("<I", mm, _O_VERSION, _VERSION)
                struct.pack_into("<Q", mm, _O_CAP, cap)
                # Magic last: attachers spin on it below, so a half-
                # initialized header is never observable.
                struct.pack_into("<I", mm, _O_MAGIC, _MAGIC)
            else:
                deadline = time.monotonic() + cfg.dag_negotiate_timeout_s
                while os.fstat(fd).st_size < _HDR:
                    if time.monotonic() > deadline:
                        raise ChannelTimeoutError(
                            "ring rendezvous: creator never sized "
                            f"{path}", edge=self.edge)
                    time.sleep(0.001)
                mm = mmap.mmap(fd, os.fstat(fd).st_size)
                while struct.unpack_from("<I", mm, _O_MAGIC)[0] != _MAGIC:
                    if time.monotonic() > deadline:
                        raise ChannelTimeoutError(
                            "ring rendezvous: header never initialized",
                            edge=self.edge)
                    time.sleep(0.001)
                ver = struct.unpack_from("<I", mm, _O_VERSION)[0]
                if ver != _VERSION:
                    mm.close()
                    raise ChannelClosedError(
                        f"channel {self.edge}: ring layout v{ver} != "
                        f"v{_VERSION} — both endpoints must run the "
                        "same build (record headers are incompatible)")
        finally:
            os.close(fd)
        self._mm = mm
        self._path = path
        self._cap = struct.unpack_from("<Q", mm, _O_CAP)[0]
        # Keyed by ENDPOINT identity, not path: both ends of a
        # same-process channel map the same file and must balance
        # independently.
        _resdbg.note_acquire("channel_ring",
                             key=(os.getpid(), id(self)), owner=self)
        return mm

    def _witness_key(self) -> str:
        """RTPU_DEBUG_CHAN endpoint token: edge + object identity, so a
        reopened channel under the same edge name starts a fresh
        stream in the witness registry."""
        k = getattr(self, "_wkey", None)
        if k is None:
            k = self._wkey = f"{self.edge}@{id(self) & 0xFFFFFF:06x}"
        return k

    # ------------------------------------------------------------- cursors

    def _u64(self, off: int) -> int:
        return struct.unpack_from("<Q", self._mm, off)[0]

    def _set_u64(self, off: int, v: int) -> None:
        struct.pack_into("<Q", self._mm, off, v)

    def _peer_closed(self, role: str) -> bool:
        off = _O_RCLOSED if role == "w" else _O_WCLOSED
        return self._mm[off] != 0

    def bytes_in_flight(self) -> int:
        if self._mm is None:
            return 0
        return self._u64(_O_WPOS) - self._u64(_O_RPOS)

    # -------------------------------------------------------------- writer

    def write(self, value: Any, seq: int,
              timeout: Optional[float] = None) -> None:
        self._emit(KIND_OK, pickle.dumps(("ok", value), protocol=5),
                   seq, timeout)

    def write_error(self, exc: BaseException, seq: int) -> None:
        self._emit(KIND_ERR, pickle.dumps(exc, protocol=5), seq, None)

    def write_stop(self, seq: int) -> None:
        self._emit(KIND_STOP, b"", seq, None)

    def _emit(self, kind: int, payload: bytes, seq: int,
              timeout: Optional[float]) -> None:
        from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg

        mm = self._ensure()
        self._role = "w"
        witness = _chandbg.enabled()
        clock = crc = 0
        if witness:
            clock = _chandbg.clock_stamp(self._witness_key())
            # crc over the ORIGINAL payload, before any spill-out: the
            # reader recomputes after spill resolution, so a side file
            # mutated between send and consume is caught too.
            crc = _chandbg.payload_crc(seq, payload)
        if len(payload) > cfg.dag_ring_spill_bytes:
            payload = self._spill_out(payload, seq)
            kind = KIND_SPILL if kind == KIND_OK else KIND_SPILL_ERR
        size = len(payload)
        rec = _REC_HDR + _align8(size)
        if rec > self._cap:
            raise ValueError(
                f"channel {self.edge}: {size}-byte record exceeds the "
                f"{self._cap}-byte ring (raise dag_ring_bytes)")
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        waiter = _Waiter()
        while True:
            wpos = self._u64(_O_WPOS)
            rpos = self._u64(_O_RPOS)
            off = wpos % self._cap
            tail = self._cap - off
            need = rec if tail >= rec else tail + rec
            window_ok = seq - self._u64(_O_RSEQ) < self.capacity
            if self._cap - (wpos - rpos) >= need and window_ok:
                break
            if self._peer_closed("w"):
                raise ChannelClosedError(
                    f"channel {self.edge}: reader closed "
                    f"(seq={seq}, {wpos - rpos} bytes unconsumed)")
            if deadline is not None and time.monotonic() > deadline:
                raise ChannelTimeoutError(
                    "ring write blocked on backpressure",
                    edge=self.edge, seq=seq,
                    bytes_in_flight=wpos - rpos, peer_alive=True)
            self._settle_spills(rpos)
            waiter.wait()
        if tail < rec:
            if tail >= 4:
                struct.pack_into("<I", mm, _HDR + off, _WRAP)
            wpos += tail
            off = 0
        struct.pack_into("<IIQQI", mm, _HDR + off, size, kind, seq,
                         clock, crc)
        mm[_HDR + off + _REC_HDR:_HDR + off + _REC_HDR + size] = payload
        # Publish AFTER the payload memcpy: the reader never sees a
        # partial record.
        self._set_u64(_O_WPOS, wpos + rec)
        if kind in (KIND_SPILL, KIND_SPILL_ERR):
            self._spills.append((wpos + rec, self._last_spill_path))
            if witness:
                _chandbg.note_spill_pin(self._witness_key(),
                                        self._last_spill_path,
                                        wpos + rec)
        if witness:
            _chandbg.note_cursor(self._witness_key(), "wpos", wpos + rec)
            _chandbg.note_send(self._witness_key(), seq, size,
                               window=(self._u64(_O_RSEQ),
                                       self.capacity))
        self._settle_spills(self._u64(_O_RPOS))

    def _spill_out(self, payload: bytes, seq: int) -> bytes:
        name = f"{SPILL_PREFIX}{self.channel_id.hex()}-{seq}.sp"
        path = os.path.join(channel_dir(), name)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(payload)
        os.replace(tmp, path)
        self._last_spill_path = path
        _resdbg.note_acquire("channel_spill",
                             key=(os.getpid(), path), owner=self)
        return name.encode()

    def _settle_spills(self, rpos: int) -> None:
        while self._spills and self._spills[0][0] <= rpos:
            _end, path = self._spills.pop(0)
            _resdbg.note_release("channel_spill", (os.getpid(), path))
            _chandbg.note_spill_release(self._witness_key(), path)

    # -------------------------------------------------------------- reader

    def read(self, seq: int, timeout: Optional[float] = None) -> Any:
        """Blocking ordered read; the record's seq must match ``seq``
        (SPSC streams are strictly ordered — a mismatch is a protocol
        violation, not a wait). Raises carried errors; a stop sentinel
        raises ChannelClosedError."""
        self._ensure()
        self._role = "r"
        kind, got_seq, payload = self._next_record(timeout)
        if got_seq != seq:
            raise ChannelClosedError(
                f"channel {self.edge}: seq inversion (got {got_seq}, "
                f"expected {seq})")
        if kind == KIND_STOP:
            raise ChannelClosedError(f"channel {self.edge} closed")
        if kind == KIND_ERR:
            raise pickle.loads(payload)
        return pickle.loads(payload)[1]

    def _spill_in(self, kind: int, name_b: bytes):
        path = os.path.join(channel_dir(), name_b.decode())
        # CLAIM the side file by atomic rename before touching its
        # contents: the writer's close() reclaims spills it believes
        # unconsumed once its grace window expires, and a plain open()
        # here would race that unlink (the reader had dequeued the ring
        # record but not yet opened the file). rename vs unlink is
        # atomic either way: if we win, the writer's unlink of the
        # original ENOENTs harmlessly; if the writer won, the rename
        # fails and the stream is truthfully reported closed.
        claimed = path + ".rd"
        try:
            os.rename(path, claimed)
        except FileNotFoundError:
            raise ChannelClosedError(
                f"channel {self.edge}: spill {os.path.basename(path)} "
                "reclaimed by writer close before the reader consumed "
                "it") from None
        with open(claimed, "rb") as f:
            payload = f.read()
        try:
            os.unlink(claimed)
        except OSError:
            pass
        return (KIND_OK if kind == KIND_SPILL else KIND_ERR), payload

    def _next_record(self, timeout: Optional[float]):
        mm = self._mm
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        waiter = _Waiter()
        while True:
            rpos = self._u64(_O_RPOS)
            wpos = self._u64(_O_WPOS)
            if wpos > rpos:
                off = rpos % self._cap
                tail = self._cap - off
                if tail < _REC_HDR:
                    self._set_u64(_O_RPOS, rpos + tail)
                    continue
                size, kind, seq, clock, crc = struct.unpack_from(
                    "<IIQQI", mm, _HDR + off)
                if size == _WRAP:
                    self._set_u64(_O_RPOS, rpos + tail)
                    continue
                payload = bytes(mm[_HDR + off + _REC_HDR:
                                   _HDR + off + _REC_HDR + size])
                if kind in (KIND_SPILL, KIND_SPILL_ERR):
                    # Resolve the side file BEFORE publishing the
                    # cursor: the writer settles its spill ledger on
                    # cursor advance, so advancing first would let a
                    # reader crash in the window strand the file.
                    kind, payload = self._spill_in(kind, payload)
                new_rpos = rpos + _REC_HDR + _align8(size)
                self._set_u64(_O_RPOS, new_rpos)
                self._set_u64(_O_RSEQ, seq + 1)
                self._read_seq = seq + 1
                if _chandbg.enabled():
                    _chandbg.note_cursor(self._witness_key(), "rpos",
                                         new_rpos)
                    _chandbg.note_consume(self._witness_key(), seq,
                                          clock, crc, payload)
                return kind, seq, payload
            if self._peer_closed("r"):
                raise ChannelClosedError(
                    f"channel {self.edge}: writer closed with no "
                    "pending record")
            if deadline is not None and time.monotonic() > deadline:
                raise ChannelTimeoutError(
                    "ring read timed out",
                    edge=self.edge, seq=self._read_seq,
                    bytes_in_flight=wpos - rpos,
                    peer_alive=not self._peer_closed("r"))
            waiter.wait()

    # ------------------------------------------------------------ teardown

    def wait_consumed(self, seq: int, timeout: float = 10.0) -> bool:
        """Writer-side handshake: block until the reader consumed
        message ``seq`` (its read_seq cursor passed it)."""
        self._ensure()
        deadline = time.monotonic() + timeout
        pause = 0.001
        while self._u64(_O_RSEQ) <= seq:
            if self._peer_closed("w") or time.monotonic() > deadline:
                return self._u64(_O_RSEQ) > seq
            time.sleep(pause)
            pause = min(pause * 2, 0.02)
        return True

    def drain(self, from_seq: int, span: int = 0) -> None:
        """Teardown cleanup: discard whatever is left and close."""
        if self._mm is not None and not self._closed:
            try:
                if self._role != "w":
                    self._set_u64(_O_RPOS, self._u64(_O_WPOS))
            except (ValueError, OSError):
                pass
        self.close(unlink=True)

    def close(self, unlink: bool = False) -> None:
        if self._closed:
            # One endpoint object can hold both roles (a compiled-DAG edge
            # between two ops of one actor): a close as the writer, then
            # one as the reader, must still remove the file.
            if unlink:
                self.unlink()
            return
        self._closed = True
        if self._mm is None:
            # Endpoint never mapped the ring: still honor unlink (the
            # PEER may have created the file).
            if unlink:
                try:
                    os.unlink(self._ring_path())
                except OSError:
                    pass
            return
        try:
            off = _O_WCLOSED if self._role == "w" else _O_RCLOSED
            if self._role is not None:
                self._mm[off] = 1
            elif unlink:
                # Endpoint that never transferred: mark both sides so a
                # blocked peer wakes either way.
                self._mm[_O_WCLOSED] = 1
        except (ValueError, OSError):
            pass
        # Reclaim spills the reader never consumed (reader death must
        # not strand multi-MB side files). But a spill whose ring record
        # the reader ALREADY dequeued may be opened by _spill_in any
        # instant now, so observe consumption first: poll rpos until the
        # ledger settles, the reader declares itself closed, or the grace
        # window expires — only what is still unconsumed THEN is treated
        # as stranded and reclaimed.
        if self._spills and self._role == "w":
            from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg

            deadline = time.monotonic() + cfg.dag_spill_reclaim_grace_s
            pause = 0.0005
            while self._spills:
                try:
                    self._settle_spills(self._u64(_O_RPOS))
                    if (not self._spills or self._mm[_O_RCLOSED]
                            or time.monotonic() > deadline):
                        break
                except (ValueError, OSError):
                    break
                time.sleep(pause)
                pause = min(pause * 2, 0.02)
        if self._spills and self._role == "w" and _chandbg.enabled():
            # A pin whose record the reader already dequeued but that
            # never settled is the spill reclaim race: reclaiming it
            # below would unlink a file _spill_in may open any instant.
            try:
                _chandbg.note_close(self._witness_key(),
                                    self._u64(_O_RPOS))
            except (ValueError, OSError):
                pass
        for _end, path in self._spills:
            try:
                os.unlink(path)
            except OSError:
                pass
            _resdbg.note_release("channel_spill", (os.getpid(), path))
            _chandbg.note_spill_release(self._witness_key(), path)
        self._spills = []
        path, mm, self._mm = self._path, self._mm, None
        try:
            mm.close()
        except (ValueError, OSError):
            pass
        _resdbg.note_release("channel_ring", (os.getpid(), id(self)))
        if unlink and path:
            try:
                os.unlink(path)
            except OSError:
                pass

    def unlink(self) -> None:
        """Remove the ring's file (port addition). Endpoints that mapped
        the ring keep working; only a later attach would miss it. A server
        whose peer may have died without closing calls this so the file
        does not outlive the edge."""
        try:
            os.unlink(self._ring_path())
        except OSError:
            pass

    # The compiled DAG ships channel objects inside actor schedules.
    def __reduce__(self):
        return (RingChannel, (self.channel_id, self.capacity,
                              self._ring_bytes, self.edge))
