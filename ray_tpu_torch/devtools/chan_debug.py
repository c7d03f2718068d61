"""Runtime channel-protocol witness (``RTPU_DEBUG_CHAN=1``) — the
dynamic half of the ``chan`` rtpu-lint rule family, mirroring
``rpc_debug.py`` / ``res_debug.py``: zero overhead when the flag is
off, and when on it checks the frame-stream invariants every channel
transport (``dag/ring.py`` shm rings, ``dag/peer.py`` peer sockets)
promises, ONLINE, per edge endpoint:

- **seq discipline** — a writer's seqs are gapless and duplicate-free
  (``note_send``), a consumer's arrive in order (``note_consume``).
  The static side is chan-raw-seq-send: sends that bypass the auto-seq
  facades are exactly how a gap ships.
- **credit accounting** — a send admitted while more than ``capacity``
  messages are unacked/unconsumed overran the credit window
  (``note_send(window=...)``); an ack for a seq the application never
  consumed is a phantom credit (``note_ack``).
- **cursor monotonicity** — ring wpos/rpos only ever advance
  (``note_cursor``); a regression means a torn or reordered publish.
- **frame checksums** — every ``SAMPLE_EVERY``-th frame carries a crc32
  of its payload, computed at send and recomputed at consume. A
  mismatch is a torn read or a writer that mutated the buffer after
  handing it to the transport (the chan-mutate-after-send race,
  observed empirically).
- **Lamport clocks** — every frame carries the sending process's
  Lamport stamp; consumers merge it and require per-edge monotonicity,
  so a frame reordered against its own stream (the object_batch
  add/remove-inversion class) is caught even when seqs
  were re-minted.
- **spill pin/reclaim pairing** — a ring spill side-file pinned at
  send must be settled once its record's consumption is observed;
  ``note_close`` flags any pin whose record the reader already
  consumed (end_pos <= rpos) that was never settled — the
  ``_spill_in`` reclaim race shape, caught at writer close instead of
  as a reader FileNotFoundError.

Violations print one ``RTPU_CHAN:`` line each (plus a compact registry
report) and are queryable via :func:`violations`; the per-process
summary rides every flight-recorder dump (``"chan_debug"`` key), so a
cluster-wide ``chan_violations`` verdict can be aggregated over the
same ``dump_flight`` RPC the other witnesses use.

With ``RTPU_DEBUG_CHAN`` unset every hook is one env read returning
its input untouched, and the transports skip the hook blocks entirely
— frame headers carry zeros in the clock/crc fields.

Knobs:
  RTPU_DEBUG_CHAN=1  enable the witness (inherited by every spawned
                     cluster process, like the other RTPU_DEBUG_ flags)
"""

from __future__ import annotations

import os
import threading
import zlib
from typing import Any, Dict, List, Optional, Tuple

#: Sample the payload checksum on every Nth seq per edge (seq % N == 0).
#: A full crc32 on every frame would eat the <5% witness-overhead
#: budget on a ~26us ring hop; sampling keeps the empirical
#: mutate-after-send/torn-read check while staying off the hot cost.
SAMPLE_EVERY = 16

_CRC_MASK = 0xFFFFFFFF


def enabled() -> bool:
    return os.environ.get("RTPU_DEBUG_CHAN", "") == "1"


class _Registry:
    """Process-global per-edge frame-stream state. Keys are ENDPOINT
    tokens (edge name + object id), not bare edge names: a process that
    reopens a channel under the same edge restarts its seqs at 0, and
    the two streams must not be conflated."""

    def __init__(self):
        self._mu = threading.Lock()
        self.clock = 0  # process Lamport clock (merged on consume)
        self.frames = 0
        # endpoint token -> stream state
        self.edges: Dict[str, Dict[str, Any]] = {}
        # (endpoint token, spill path) -> record end_pos
        self.pins: Dict[Tuple[str, str], int] = {}
        self.violations: List[dict] = []

    def edge(self, tok: str) -> Dict[str, Any]:
        st = self.edges.get(tok)
        if st is None:
            st = self.edges[tok] = {"sent": -1, "consumed": -1,
                                    "acked": -1, "clock_seen": 0}
        return st

    def note_violation(self, kind: str, edge: str, message: str,
                       **fields) -> None:
        rec = {"kind": kind, "edge": edge, "message": message}
        rec.update(fields)
        with self._mu:
            self.violations.append(rec)
            st = dict(self.edges.get(edge, {}))
        print(f"RTPU_CHAN: [{kind}] {edge}: {message} (edge state {st})",
              flush=True)

    def reset(self) -> None:
        with self._mu:
            self.clock = 0
            self.frames = 0
            self.edges.clear()
            self.pins.clear()
            self.violations.clear()


_REGISTRY = _Registry()


# ------------------------------------------------------------ frame hooks


def clock_stamp(edge: str) -> int:
    """Writer-side Lamport stamp for the next frame; 0 when off (the
    header field ships 0 and consumers skip the check)."""
    if not enabled():
        return 0
    with _REGISTRY._mu:
        _REGISTRY.clock += 1
        return _REGISTRY.clock


def payload_crc(seq: int, *parts) -> int:
    """Sampled frame checksum: crc32 over the payload parts on every
    SAMPLE_EVERY-th seq, else 0 ("not sampled"). A real crc of 0 maps
    to 1 so 0 stays unambiguous. Returns 0 when off."""
    if not enabled() or seq % SAMPLE_EVERY:
        return 0
    c = 0
    for p in parts:
        c = zlib.crc32(p, c)
    return (c & _CRC_MASK) or 1


def note_send(edge: str, seq: int, nbytes: int,
              window: Optional[Tuple[int, int]] = None) -> None:
    """One frame handed to the transport. ``window=(floor, capacity)``
    is the writer's credit view (ring: read_seq; peer: acked seq) —
    admission more than ``capacity`` past the floor overran the
    window."""
    if not enabled():
        return
    gap = dup = False
    with _REGISTRY._mu:
        _REGISTRY.frames += 1
        st = _REGISTRY.edge(edge)
        last_sent = st["sent"]
        if last_sent >= 0 and seq != last_sent + 1:
            dup = seq <= last_sent
            gap = not dup
        if seq > st["sent"]:
            st["sent"] = seq
    if dup:
        _REGISTRY.note_violation(
            "send-seq-duplicate", edge,
            f"seq {seq} re-sent (stream already at {last_sent}) — a "
            "duplicate frame on an SPSC stream (route sends through "
            "the ChannelWriter facade)", seq=seq)
    elif gap:
        _REGISTRY.note_violation(
            "send-seq-gap", edge,
            f"seq {seq} sent after a gap — the stream skipped at least "
            "one seq (a raw-seq send bypassed the auto-seq facade)",
            seq=seq)
    if window is not None:
        floor, cap = window
        if seq - floor > cap:
            _REGISTRY.note_violation(
                "credit-overrun", edge,
                f"seq {seq} admitted {seq - floor} past the consumption "
                f"floor {floor} (capacity {cap}) — a send bypassed the "
                "credit window", seq=seq, floor=floor, capacity=cap)


def note_consume(edge: str, seq: int, clock: int, crc: int,
                 *parts) -> None:
    """One frame consumed by the application. Recomputes the sampled
    checksum and checks seq + Lamport-clock monotonicity."""
    if not enabled():
        return
    if crc:
        c = 0
        for p in parts:
            c = zlib.crc32(p, c)
        c = (c & _CRC_MASK) or 1
        if c != crc:
            _REGISTRY.note_violation(
                "payload-mismatch", edge,
                f"seq {seq}: payload crc at consume ({c:#x}) != crc at "
                f"send ({crc:#x}) — a torn read, or the writer mutated "
                "the buffer after handing it to the transport "
                "(chan-mutate-after-send)", seq=seq)
    gap = inversion = clock_bad = False
    with _REGISTRY._mu:
        st = _REGISTRY.edge(edge)
        if st["consumed"] >= 0 and seq != st["consumed"] + 1:
            inversion = seq <= st["consumed"]
            gap = not inversion
        if seq > st["consumed"]:
            st["consumed"] = seq
        if clock:
            if clock <= st["clock_seen"]:
                clock_bad = True
            else:
                st["clock_seen"] = clock
            if clock > _REGISTRY.clock:  # Lamport merge
                _REGISTRY.clock = clock
    if inversion:
        _REGISTRY.note_violation(
            "consume-seq-inversion", edge,
            f"seq {seq} consumed after the stream already passed it — "
            "re-delivery or inversion on an SPSC stream", seq=seq)
    elif gap:
        _REGISTRY.note_violation(
            "consume-seq-gap", edge,
            f"seq {seq} consumed after a gap — at least one frame was "
            "lost or skipped", seq=seq)
    if clock_bad:
        _REGISTRY.note_violation(
            "clock-inversion", edge,
            f"seq {seq} carries Lamport clock {clock} <= the edge's "
            "last observed stamp — frames reordered against their own "
            "send order (the add/remove-inversion class)",
            seq=seq, clock=clock)


def note_ack(edge: str, seq: int) -> None:
    """A consumption ack leaving this endpoint: acking past the last
    application consume mints phantom credit."""
    if not enabled():
        return
    bad = False
    with _REGISTRY._mu:
        st = _REGISTRY.edge(edge)
        if seq > st["consumed"]:
            bad = True
        if seq > st["acked"]:
            st["acked"] = seq
    if bad:
        _REGISTRY.note_violation(
            "ack-before-consume", edge,
            f"seq {seq} acked before the application consumed it — the "
            "credit window no longer bounds unconsumed frames",
            seq=seq)


def note_cursor(edge: str, name: str, value: int) -> None:
    """A ring cursor publish (wpos/rpos). Cursors are monotonic byte
    counters; a regression means a torn or reordered publish."""
    if not enabled():
        return
    bad = last = None
    with _REGISTRY._mu:
        st = _REGISTRY.edge(edge)
        key = "cur_" + name
        last = st.get(key, -1)
        if value < last:
            bad = True
        else:
            st[key] = value
    if bad:
        _REGISTRY.note_violation(
            "cursor-regression", edge,
            f"{name} published {value} after {last} — ring cursors "
            "only advance (publish-before-fill or a reordered store)",
            cursor=name, value=value, last=last)


# ------------------------------------------------------------ spill pins


def note_spill_pin(edge: str, path: str, end_pos: int) -> None:
    """A ring spill side-file pinned at send; ``end_pos`` is its ring
    record's end cursor (consumption is observable as rpos >= end_pos)."""
    if not enabled():
        return
    with _REGISTRY._mu:
        _REGISTRY.pins[(edge, path)] = end_pos


def note_spill_release(edge: str, path: str) -> None:
    """The pin settled (consumption observed, or legitimately reclaimed
    as stranded at close). Idempotent, unknown pins ignored."""
    if not enabled():
        return
    with _REGISTRY._mu:
        _REGISTRY.pins.pop((edge, path), None)


def note_close(edge: str, rpos: int) -> None:
    """Writer close: a pin whose record the reader ALREADY consumed
    (end_pos <= rpos) but that was never settled means the writer is
    about to reclaim — or already failed to settle — a spill the
    consumption path raced (the ``_spill_in`` shape)."""
    if not enabled():
        return
    with _REGISTRY._mu:
        stale = [(path, end) for (e, path), end in _REGISTRY.pins.items()
                 if e == edge and end <= rpos]
    for path, end in stale:
        _REGISTRY.note_violation(
            "spill-reclaim-race", edge,
            f"spill {os.path.basename(path)} consumed by the reader "
            f"(record end {end} <= rpos {rpos}) but never settled — "
            "writer close would reclaim a file the reader's _spill_in "
            "may still open (the spill reclaim race)", path=path)


# -------------------------------------------------------------- queries


def violations() -> List[dict]:
    with _REGISTRY._mu:
        return [dict(v) for v in _REGISTRY.violations]


def frames_witnessed() -> int:
    with _REGISTRY._mu:
        return _REGISTRY.frames


def reset() -> None:
    """Clear the witness registry (tests isolate scenarios with this)."""
    _REGISTRY.reset()


def report() -> Dict[str, Any]:
    """Compact per-edge registry report (tests and smokes print
    this next to a violation verdict)."""
    with _REGISTRY._mu:
        return {
            "edges": {tok: dict(st)
                      for tok, st in _REGISTRY.edges.items()},
            "pins": len(_REGISTRY.pins),
            "frames": _REGISTRY.frames,
            "clock": _REGISTRY.clock,
            "violations": len(_REGISTRY.violations),
        }


def dump_payload() -> Dict[str, Any]:
    """The snapshot riding ``flight_recorder.dump_payload`` under the
    ``"chan_debug"`` key: enough to aggregate a cluster-wide
    chan_violations verdict (frames_witnessed is the
    coverage evidence — a 0-violation verdict over 0 frames is
    vacuous)."""
    with _REGISTRY._mu:
        return {
            "frames": _REGISTRY.frames,
            "edges": len(_REGISTRY.edges),
            "open_pins": len(_REGISTRY.pins),
            "violations": len(_REGISTRY.violations),
        }
