"""The port's channel transports (``ray_tpu_torch/dag/ring.py``,
``peer.py``, ``channel.py``) on the CPU: the store-free counterparts of
``tests/test_dag_channels.py``, each asserting what ``ray_tpu``'s test
asserts.

``ray_tpu``'s resource-witness cases (``RTPU_DEBUG_RES``) become plain
close and file-count checks, since the port has no witness. Then what the
port adds: its ring records are ``ray_tpu``'s byte for byte (the same
values written through both packages' rings leave the same bytes), its
files carry its own ``rtt-`` prefix, and a bf16 CPU tensor crosses a ring
and a peer socket bit for bit. Every blocking read and write has a
timeout.
"""

import glob
import mmap
import os
import pickle
import socket
import struct
import threading
import time
import uuid

import numpy as np
import pytest
import torch

from ray_tpu.dag.ring import RingChannel as JRingChannel
from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg
from ray_tpu_torch.dag.channel import ChannelReader, ChannelWriter
from ray_tpu_torch.dag.errors import ChannelClosedError, ChannelTimeoutError
from ray_tpu_torch.dag.peer import (_HELLO, ChannelEndpoint,
                                    CrossNodeChannel, get_endpoint)
from ray_tpu_torch.dag.ring import RingChannel, channel_dir


def _pair(capacity=4, ring_bytes=8192):
    cid = uuid.uuid4().bytes
    return (RingChannel(cid, capacity=capacity, ring_bytes=ring_bytes),
            RingChannel(cid, capacity=capacity, ring_bytes=ring_bytes))


def _spill_files(cid):
    return glob.glob(os.path.join(channel_dir(), f"rtt-spill-{cid.hex()}*"))


# ----------------------------------------------------------------- ring


def test_ring_roundtrip_and_wraparound():
    w, r = _pair(ring_bytes=4096)
    try:
        # Far more bytes than the ring holds: every record wraps the
        # cursor many times over and each read must be byte-faithful.
        for i in range(200):
            w.write({"i": i, "pad": bytes([i % 256]) * 333}, i, timeout=10)
            got = r.read(i, timeout=10)
            assert got["i"] == i and got["pad"][:1] == bytes([i % 256])
    finally:
        w.close()
        r.close(unlink=True)


def test_ring_rendezvous_either_order():
    """Whichever endpoint touches the channel first creates the file;
    the other attaches — no coordination service involved."""
    cid = uuid.uuid4().bytes
    r = RingChannel(cid, capacity=4)
    w = RingChannel(cid, capacity=4)
    try:
        got = []
        t = threading.Thread(
            target=lambda: got.append(r.read(0, timeout=10)))
        t.start()  # reader first: blocks on an empty (created) ring
        time.sleep(0.05)
        w.write("hello", 0, timeout=10)
        t.join(timeout=10)
        assert got == ["hello"]
    finally:
        w.close()
        r.close(unlink=True)


def test_ring_backpressure_blocks_and_unblocks():
    w, r = _pair(capacity=3)
    try:
        for i in range(3):
            w.write(i, i, timeout=10)  # fills the message window
        state = {"unblocked_at": None}

        def drain():
            time.sleep(0.3)
            for i in range(3, 8):
                r.read(i - 3, timeout=10)

        t = threading.Thread(target=drain)
        t.start()
        t0 = time.monotonic()
        w.write(3, 3, timeout=10)  # must BLOCK until the reader drains
        state["unblocked_at"] = time.monotonic() - t0
        for i in range(4, 8):
            w.write(i, i, timeout=10)
        t.join(timeout=10)
        assert state["unblocked_at"] > 0.2, state
    finally:
        w.close()
        r.close(unlink=True)


def test_ring_timeout_carries_context():
    cid = uuid.uuid4().bytes
    w = RingChannel(cid, capacity=2, ring_bytes=2048, edge="a->b")
    r = RingChannel(cid, capacity=2, ring_bytes=2048, edge="a->b")
    try:
        w.write(b"x" * 100, 0, timeout=10)
        w.write(b"x" * 100, 1, timeout=10)
        with pytest.raises(ChannelTimeoutError) as ei:
            w.write(b"x" * 100, 2, timeout=0.2)
        e = ei.value
        assert e.edge == "a->b" and e.seq == 2
        assert e.bytes_in_flight and e.peer_alive is True
        for f in ("edge=a->b", "seq=2", "bytes_in_flight=",
                  "peer_alive=True"):
            assert f in str(e), str(e)
        # Reader-side timeout context too.
        with pytest.raises(ChannelTimeoutError) as ei2:
            empty_w, empty_r = _pair()
            try:
                empty_r.read(0, timeout=0.2)
            finally:
                empty_w.close()
                empty_r.close(unlink=True)
        assert ei2.value.seq == 0
    finally:
        w.close()
        r.close(unlink=True)


def test_ring_reader_death_fails_writer():
    w, r = _pair(capacity=2)
    w.write(0, 0, timeout=10)
    r.read(0, timeout=5)
    r.close(unlink=True)  # reader dies
    with pytest.raises(ChannelClosedError):
        for i in range(1, 10):
            w.write(i, i, timeout=5)
    w.close()


def test_ring_spill_large_payload_and_reclaim():
    """Payloads past the spill threshold ride a side file; the writer
    reclaims unconsumed spills at close (a reader death must not leak
    them). ``ray_tpu`` counts them in its resource witness; here the side
    files themselves are counted."""
    big = os.urandom(1 << 19)  # 512 KiB > dag_ring_spill_bytes default
    assert len(big) > cfg.dag_ring_spill_bytes
    w, r = _pair(capacity=4)
    cid = w.channel_id
    w.write(big, 0, timeout=10)
    assert len(_spill_files(cid)) == 1 and len(w._spills) == 1
    assert r.read(0, timeout=10) == big
    assert _spill_files(cid) == []  # the reader claimed and removed it
    # A consumed spill settles once the writer observes the cursor.
    w.write(b"small", 1, timeout=10)
    assert w._spills == []
    # Unconsumed spill + writer close => reclaimed, not leaked. (Close
    # grants an alive reader a grace window to consume in-flight spills
    # first; this reader is parked, so keep the wait short.)
    old_grace = cfg.dag_spill_reclaim_grace_s
    cfg.set("dag_spill_reclaim_grace_s", 0.05)
    w.write(big, 2, timeout=10)
    assert len(_spill_files(cid)) == 1
    try:
        w.close()
    finally:
        cfg.set("dag_spill_reclaim_grace_s", old_grace)
    assert _spill_files(cid) == [] and w._spills == []
    ring = r._path
    assert os.path.exists(ring)  # the reader still holds the ring
    r.close(unlink=True)
    assert not os.path.exists(ring)


def test_ring_writer_close_waits_for_inflight_spill_read(monkeypatch):
    """The reader dequeues a spill record, then opens the side file —
    rpos only advances AFTER the open. A writer closing in that window
    must observe consumption before reclaiming a spill an alive reader
    can still reach, not unlink the file under the open."""
    big = os.urandom(1 << 19)  # > dag_ring_spill_bytes: rides a side file
    w, r = _pair(capacity=4)
    orig = RingChannel._spill_in

    def slow_spill_in(self, kind, name_b):
        time.sleep(0.3)  # widen the dequeue -> open race window
        return orig(self, kind, name_b)

    monkeypatch.setattr(RingChannel, "_spill_in", slow_spill_in)
    w.write(big, 0, timeout=10)
    out = {}

    def reader():
        try:
            out["val"] = r.read(0, timeout=10)
        except Exception as e:  # noqa: BLE001 — surfaced via assert below
            out["err"] = e

    t = threading.Thread(target=reader)
    t.start()
    time.sleep(0.1)  # reader is inside _spill_in, file not yet opened
    w.close()  # must wait out the in-flight read, not unlink blindly
    t.join(10)
    assert "err" not in out, f"reader died: {out.get('err')!r}"
    assert out["val"] == big
    r.close(unlink=True)


def test_ring_spill_claim_race_grace_zero(monkeypatch):
    """With the reclaim grace forced to ZERO the writer unlinks
    unconsumed spills the instant close() runs — racing a reader that
    already dequeued the ring record. The reader must either CLAIM the
    side file (atomic rename in _spill_in) and return the payload, or
    surface a clean ChannelClosedError; a raw FileNotFoundError escaping
    _spill_in is the bug."""
    big = os.urandom(1 << 19)  # > dag_ring_spill_bytes: rides a side file
    orig = RingChannel._spill_in

    def slow_spill_in(self, kind, name_b):
        time.sleep(0.15)  # widen the dequeue -> claim race window
        return orig(self, kind, name_b)

    monkeypatch.setattr(RingChannel, "_spill_in", slow_spill_in)
    for _ in range(3):
        w, r = _pair(capacity=4)
        w.write(big, 0, timeout=10)
        out = {}

        def reader():
            try:
                out["val"] = r.read(0, timeout=10)
            except Exception as e:  # noqa: BLE001 — asserted below
                out["err"] = e

        t = threading.Thread(target=reader)
        t.start()
        time.sleep(0.05)  # reader is inside _spill_in, pre-claim
        old_grace = cfg.dag_spill_reclaim_grace_s
        cfg.set("dag_spill_reclaim_grace_s", 0.0)
        try:
            w.close()
        finally:
            cfg.set("dag_spill_reclaim_grace_s", old_grace)
        t.join(10)
        err = out.get("err")
        assert err is None or isinstance(err, ChannelClosedError), \
            repr(err)
        if err is None:
            assert out["val"] == big
        r.close(unlink=True)
        assert _spill_files(w.channel_id) == []


def test_ring_stop_sentinel_and_error_forwarding():
    w, r = _pair()
    try:
        w.write_error(ValueError("boom"), 0)
        with pytest.raises(ValueError, match="boom"):
            r.read(0, timeout=5)
        w.write_stop(1)
        assert w.wait_consumed(0, timeout=5)
        with pytest.raises(ChannelClosedError):
            r.read(1, timeout=5)
        assert w.wait_consumed(1, timeout=5)
    finally:
        w.close()
        r.close(unlink=True)


def test_ring_seq_mismatch_is_loud():
    w, r = _pair()
    try:
        w.write("a", 0, timeout=10)
        with pytest.raises(ChannelClosedError, match="seq inversion"):
            r.read(5, timeout=5)
    finally:
        w.close()
        r.close(unlink=True)


def test_ring_file_lives_in_channel_dir():
    w, r = _pair()
    try:
        w.write(1, 0, timeout=10)
        path = w._path
        assert path and path.startswith(channel_dir())
        assert os.path.basename(path).startswith("rtt-ring-")
        assert os.path.exists(path)
    finally:
        w.close()
        r.close(unlink=True)
    assert not os.path.exists(path)  # reader unlink cleaned it up


def test_ring_records_equal_ray_tpus_bytes():
    """The same writes through ``ray_tpu``'s ring and the port's leave
    the same header and records (only the files' names differ), so the
    two packages keep one wire layout."""
    values = [0, "two", {"k": [1, 2.5]}, b"x" * 3000, None]
    rings = []
    for cls in (JRingChannel, RingChannel):
        cid = uuid.uuid4().bytes
        w = cls(cid, capacity=8, ring_bytes=4096)
        r = cls(cid, capacity=8, ring_bytes=4096)
        try:
            for i, v in enumerate(values):
                w.write(v, i, timeout=10)
                if i % 2:
                    assert r.read(i - 1, timeout=10) == values[i - 1]
                    assert r.read(i, timeout=10) == v
            with open(w._path, "rb") as f:
                rings.append(f.read())
        finally:
            w.close()
            r.close(unlink=True)
    assert len(rings[0]) == len(rings[1]) == 64 + 4096
    assert rings[0] == rings[1]


def test_ring_carries_a_bf16_tensor_bit_for_bit():
    t = torch.randn(2, 8, 16, 32, generator=torch.Generator().manual_seed(0)
                    ).to(torch.bfloat16)
    w, r = _pair(capacity=4, ring_bytes=1 << 20)
    try:
        w.write(("req", {"pages_k": [t, t[:1]]}), 0, timeout=10)
        rid, payload = r.read(0, timeout=10)
        got = payload["pages_k"]
        assert rid == "req" and got[0].dtype == torch.bfloat16
        assert torch.equal(got[0].view(torch.int16), t.view(torch.int16))
        assert torch.equal(got[1], t[:1])
    finally:
        w.close()
        r.close(unlink=True)


# ----------------------------------------------------------------- peer


def _peer_pair(capacity=4):
    cid = uuid.uuid4().bytes
    rd = CrossNodeChannel(cid, capacity=capacity, edge="w->r")
    addr = rd.prepare_read()
    wr = CrossNodeChannel(cid, capacity=capacity, edge="w->r", addr=addr)
    return wr, rd


def test_peer_scatter_byte_identity():
    """Multi-MB numpy payload crosses the socket as pickle-5 scatter
    frames and arrives byte-identical; so does a bf16 tensor."""
    wr, rd = _peer_pair()
    try:
        payload = np.random.default_rng(0).integers(
            0, 255, size=(1 << 20,), dtype=np.uint8)
        wr.write(payload, 0, timeout=30)
        out = rd.read(0, timeout=30)
        assert isinstance(out, np.ndarray)
        assert np.array_equal(out, payload)
        t = torch.randn(64, 128).to(torch.bfloat16)
        wr.write(t, 1, timeout=30)
        got = rd.read(1, timeout=30)
        assert torch.equal(got.view(torch.int16), t.view(torch.int16))
    finally:
        wr.close()
        rd.close()


def test_peer_credit_window_backpressure():
    wr, rd = _peer_pair(capacity=3)
    try:
        blocked = {}

        def drain():
            time.sleep(0.3)
            for i in range(12):
                rd.read(i, timeout=10)

        t = threading.Thread(target=drain)
        t.start()
        t0 = time.monotonic()
        for i in range(12):
            wr.write(i, i, timeout=10)
        blocked["dt"] = time.monotonic() - t0
        t.join(timeout=10)
        assert blocked["dt"] > 0.2, blocked  # window forced a wait
        assert wr.wait_consumed(11, timeout=5)
    finally:
        wr.close()
        rd.close()


def test_peer_reader_death_rejects_writer():
    wr, rd = _peer_pair()
    wr.write("x", 0, timeout=10)
    assert rd.read(0, timeout=10) == "x"
    rd.close()  # teardown: endpoint now actively rejects the channel
    with pytest.raises((ChannelClosedError, ChannelTimeoutError)):
        for i in range(1, 20):
            wr.write(i, i, timeout=2)
    wr.close()


def test_peer_seq_monotonicity_witness():
    """Out-of-order / duplicate frames are recorded as violations and
    duplicates are dropped, not delivered twice."""
    cid = uuid.uuid4().bytes
    rd = CrossNodeChannel(cid, capacity=8)
    addr = rd.prepare_read()
    host, port = addr.rsplit(":", 1)
    s = socket.create_connection((host, int(port)), timeout=10)
    try:
        s.sendall(struct.pack("<II", _HELLO, len(cid)) + cid)

        def frame(seq):
            body = pickle.dumps(("ok", seq), protocol=5)
            # clock=0 / crc=0, as the port always sends them
            return (struct.pack("<IBQQII", len(body), 0, seq, 0, 0, 1)
                    + struct.pack("<I", len(body)) + body)

        s.sendall(frame(0) + frame(2) + frame(1))  # gap, then inversion
        assert rd.read(0, timeout=5) == 0
        assert rd.read(2, timeout=5) == 2  # gap flagged but delivered
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            kinds = [v["kind"] for v in get_endpoint().violations()]
            if ("channel-seq-gap" in kinds
                    and "channel-seq-inversion" in kinds):
                break
            time.sleep(0.05)
        assert "channel-seq-gap" in kinds, kinds
        assert "channel-seq-inversion" in kinds, kinds
    finally:
        s.close()
        rd.close()


def test_peer_sockets_closed():
    """``ray_tpu`` witnesses the peer sockets in its resource registry;
    here close is checked directly: the writer drops its socket, its ack
    thread ends, and the endpoint forgets the channel's inbox."""
    wr, rd = _peer_pair()
    wr.write("x", 0, timeout=10)
    assert rd.read(0, timeout=10) == "x"
    assert wr._sock is not None and wr._ack_thread.is_alive()
    assert rd.channel_id in get_endpoint()._inboxes
    wr.close()
    rd.close()
    wr._ack_thread.join(timeout=5)
    assert wr._sock is None and not wr._ack_thread.is_alive()
    assert rd.channel_id not in get_endpoint()._inboxes


def test_private_endpoint_isolated_stop():
    """A dedicated endpoint stops cleanly and rejects later dials."""
    ep = ChannelEndpoint()
    port = ep.port
    ep.stop()
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", port), timeout=1)


# ------------------------------------------------------ writer/reader API


def test_channel_writer_reader_facade():
    cid = uuid.uuid4().bytes
    # Window > messages sent: the facade test exercises ordering, not
    # backpressure (test_ring_backpressure covers blocking).
    w = ChannelWriter(RingChannel(cid, capacity=16))
    r = ChannelReader(RingChannel(cid, capacity=16))
    try:
        for i in range(10):
            w.send({"n": i}, timeout=10)
        for i in range(10):
            assert r.recv(timeout=5)["n"] == i
        w.send_stop()
        with pytest.raises(ChannelClosedError):
            r.recv(timeout=5)
    finally:
        w.close()
        r.close()
    assert not os.path.exists(w.channel._ring_path())
