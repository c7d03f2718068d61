"""The port's channel witness (``ray_tpu_torch/devtools/chan_debug.py``,
``RTPU_DEBUG_CHAN=1``), case for case with ``tests/test_chan_debug.py``.

Each scenario runs over ``ray_tpu``'s ring and peer channels and over the
port's under the same flag; the port must report ``ray_tpu``'s violation
kinds and witness the same frames. The ring records' witness fields
(Lamport clock, sampled crc) are 0 with the flag off and equal
``ray_tpu``'s with it on, so the record bytes are ``ray_tpu``'s either way.
"""

import importlib
import os
import struct
import uuid

import pytest

PKGS = ("ray_tpu", "ray_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _chan(pkg):
    return _mod(pkg, "devtools.chan_debug")


def _kinds(pkg):
    return [v["kind"] for v in _chan(pkg).violations()]


def _both(scenario):
    out = []
    for pkg in PKGS:
        _chan(pkg).reset()
        out.append(scenario(pkg))
        _chan(pkg).reset()
    ref, got = out
    assert got == ref, (got, ref)
    return got


@pytest.fixture
def witness(monkeypatch):
    monkeypatch.setenv("RTPU_DEBUG_CHAN", "1")
    yield
    for pkg in PKGS:
        _chan(pkg).reset()


def _ring_pair(pkg, capacity=4, ring_bytes=8192):
    Ring = _mod(pkg, "dag.ring").RingChannel
    cid = uuid.uuid4().bytes
    return (Ring(cid, capacity=capacity, ring_bytes=ring_bytes),
            Ring(cid, capacity=capacity, ring_bytes=ring_bytes))


def _close(w, r):
    w.close()
    r.close(unlink=True)


# ------------------------------------------------------- clean surface


def test_clean_ring_traffic_zero_violations(witness):
    def run(pkg):
        w, r = _ring_pair(pkg)
        try:
            got = []
            for i in range(40):
                w.write({"i": i}, i, timeout=10)
                got.append(r.read(i, timeout=10))
        finally:
            _close(w, r)
        return got, _kinds(pkg), _chan(pkg).frames_witnessed()

    got, kinds, frames = _both(run)
    assert got == [{"i": i} for i in range(40)]
    assert kinds == [] and frames >= 40


def test_clean_peer_traffic_zero_violations(witness):
    def run(pkg):
        Cross = _mod(pkg, "dag.peer").CrossNodeChannel
        cid = uuid.uuid4().bytes
        rd = Cross(cid, capacity=8, edge="w->r")
        addr = rd.prepare_read()
        wr = Cross(cid, capacity=8, edge="w->r", addr=addr)
        try:
            got = []
            for i in range(20):
                wr.write({"i": i}, i, timeout=10)
                got.append(rd.read(i, timeout=10))
        finally:
            wr.close()
            rd.close()
        return got, _kinds(pkg), _chan(pkg).frames_witnessed()

    got, kinds, frames = _both(run)
    assert got == [{"i": i} for i in range(20)]
    assert kinds == [] and frames >= 20


def test_clean_spill_roundtrip_zero_violations(witness):
    big = os.urandom(1 << 19)

    def run(pkg):
        w, r = _ring_pair(pkg)
        try:
            w.write(big, 0, timeout=10)
            ok = r.read(0, timeout=10) == big
            w.write("after", 1, timeout=10)
            after = r.read(1, timeout=10)
        finally:
            _close(w, r)
        return ok, after, _kinds(pkg)

    assert _both(run) == (True, "after", [])


# -------------------------------------------------- injection: seq gap


def test_injected_seq_gap_reported_exactly_once(witness):
    def run(pkg):
        w, r = _ring_pair(pkg)
        try:
            w.write("a", 0, timeout=10)
            w.write("b", 2, timeout=10)  # a hand-minted gap
        finally:
            _close(w, r)
        return _kinds(pkg), _chan(pkg).violations()[0]["seq"]

    assert _both(run) == (["send-seq-gap"], 2)


# ----------------------------------- injection: late buffer mutation


def test_injected_late_mutation_reported_exactly_once(witness):
    def run(pkg):
        w, r = _ring_pair(pkg)
        try:
            w.write(b"A" * 200, 0, timeout=10)
            idx = w._mm.find(b"A" * 50)
            assert idx > 0
            w._mm[idx:idx + 1] = b"B"
            torn = r.read(0, timeout=10) != b"A" * 200
        finally:
            _close(w, r)
        return torn, _kinds(pkg)

    assert _both(run) == (True, ["payload-mismatch"])


# -------------------------------- injection: unreleased spill pin


def test_injected_unreleased_spill_pin_reported_exactly_once(
        witness, monkeypatch):
    big = os.urandom(1 << 19)

    def run(pkg):
        cfg = _mod(pkg, "core.config").GLOBAL_CONFIG
        Ring = _mod(pkg, "dag.ring").RingChannel
        monkeypatch.setattr(Ring, "_settle_spills",
                            lambda self, rpos: None)
        old_grace = cfg.dag_spill_reclaim_grace_s
        cfg.set("dag_spill_reclaim_grace_s", 0.05)
        w, r = _ring_pair(pkg)
        try:
            w.write(big, 0, timeout=10)
            ok = r.read(0, timeout=10) == big
            w.close()
            return ok, _kinds(pkg)
        finally:
            cfg.set("dag_spill_reclaim_grace_s", old_grace)
            _close(w, r)

    assert _both(run) == (True, ["spill-reclaim-race"])


# ------------------------------------------------ registry unit checks


def test_note_ack_before_consume_flagged(witness):
    def run(pkg):
        c = _chan(pkg)
        c.note_consume("e@1", 0, 0, 0, b"x")
        c.note_ack("e@1", 0)
        c.note_ack("e@1", 3)  # phantom credit
        return _kinds(pkg)

    assert _both(run) == ["ack-before-consume"]


def test_note_cursor_regression_flagged(witness):
    def run(pkg):
        c = _chan(pkg)
        for v in (128, 256, 64):
            c.note_cursor("e@1", "wpos", v)
        return _kinds(pkg)

    assert _both(run) == ["cursor-regression"]


def test_note_send_duplicate_flagged(witness):
    def run(pkg):
        c = _chan(pkg)
        for seq in (0, 1, 1):
            c.note_send("e@1", seq, 10)
        return _kinds(pkg)

    assert _both(run) == ["send-seq-duplicate"]


def test_note_send_credit_overrun_flagged(witness):
    def run(pkg):
        _chan(pkg).note_send("e@1", 9, 10, window=(0, 4))
        return _kinds(pkg)

    assert _both(run) == ["credit-overrun"]


def test_clock_inversion_flagged(witness):
    def run(pkg):
        c = _chan(pkg)
        c.note_consume("e@1", 0, 7, 0, b"x")
        c.note_consume("e@1", 1, 5, 0, b"x")
        return _kinds(pkg)

    assert _both(run) == ["clock-inversion"]


def test_lamport_merge_advances_process_clock(witness):
    def run(pkg):
        c = _chan(pkg)
        c.note_consume("e@1", 0, 1000, 0, b"x")
        return c.clock_stamp("e@2")

    assert _both(run) == 1001


def test_endpoint_tokens_isolate_reopened_channels(witness):
    def run(pkg):
        c = _chan(pkg)
        c.note_send("edge@aaa", 5, 10)
        c.note_send("edge@bbb", 0, 10)
        return _kinds(pkg)

    assert _both(run) == []


# ----------------------------------------------------- off by default


def test_zero_overhead_when_off(monkeypatch):
    monkeypatch.delenv("RTPU_DEBUG_CHAN", raising=False)

    def run(pkg):
        c = _chan(pkg)
        stamps = (c.clock_stamp("e@1"), c.payload_crc(0, b"payload"))
        c.note_send("e@1", 9, 10, window=(0, 1))
        c.note_consume("e@1", 3, 1, 1, b"x")
        c.note_ack("e@1", 7)
        w, r = _ring_pair(pkg)
        try:
            w.write("x", 0)
            got = r.read(0, timeout=10)
        finally:
            _close(w, r)
        return stamps, got, _kinds(pkg), c.frames_witnessed()

    assert _both(run) == ((0, 0), "x", [], 0)


# ------------------------------------------------ the record bytes


def _records(pkg, values):
    """The raw ring records (header + payload) of ``values`` written in
    order on a fresh ring of ``pkg``."""
    ring = _mod(pkg, "dag.ring")
    w, r = _ring_pair(pkg, capacity=8, ring_bytes=1 << 16)
    try:
        off, out = 0, []
        for seq, v in enumerate(values):
            w.write(v, seq, timeout=10)
            size = struct.unpack_from("<I", w._mm, ring._HDR + off)[0]
            rec = ring._REC_HDR + size
            out.append(bytes(w._mm[ring._HDR + off:ring._HDR + off + rec]))
            off += ring._REC_HDR + ((size + 7) & ~7)
            assert r.read(seq, timeout=10) == v
    finally:
        _close(w, r)
    return out


@pytest.mark.parametrize("flag", ["off", "on"])
def test_record_bytes_equal_ray_tpus(monkeypatch, flag):
    """Seventeen records (seq 0 and 16 carry a sampled crc): with the
    flag off the witness fields are 0; with it on they carry the same
    clock and crc as ray_tpu's, so every record is byte for byte
    ray_tpu's."""
    if flag == "on":
        monkeypatch.setenv("RTPU_DEBUG_CHAN", "1")
    else:
        monkeypatch.delenv("RTPU_DEBUG_CHAN", raising=False)
    values = [{"i": i, "payload": b"v" * i} for i in range(17)]
    recs = {}
    for pkg in PKGS:
        _chan(pkg).reset()
        recs[pkg] = _records(pkg, values)
        _chan(pkg).reset()
    assert recs["ray_tpu_torch"] == recs["ray_tpu"]
    fields = [struct.unpack_from("<QI", rec, 16) for rec in recs["ray_tpu"]]
    if flag == "off":
        assert all(f == (0, 0) for f in fields)
    else:
        assert all(clock > 0 for clock, _ in fields)
        assert fields[0][1] and fields[16][1] and not fields[1][1]


# ----------------------------------------------------------- reporting


def test_report_and_dump_payload_shapes(witness):
    def run(pkg):
        w, r = _ring_pair(pkg)
        try:
            w.write("x", 0, timeout=10)
            got = r.read(0, timeout=10)
        finally:
            _close(w, r)
        rep = _chan(pkg).report()
        dump = _chan(pkg).dump_payload()
        return (got, rep["frames"], rep["violations"], len(rep["edges"]),
                sorted(dump), dump["open_pins"])

    got, frames, bad, edges, keys, pins = _both(run)
    assert got == "x" and frames >= 1 and bad == 0 and edges >= 1
    assert keys == ["edges", "frames", "open_pins", "violations"]
    assert pins == 0


def test_flight_recorder_carries_chan_debug(witness):
    def run(pkg):
        payload = _mod(pkg, "util.flight_recorder").dump_payload()
        return sorted(payload["chan_debug"])

    assert _both(run) == ["edges", "frames", "open_pins", "violations"]
