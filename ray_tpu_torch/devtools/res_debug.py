"""Runtime resource-lifetime witness (``RTPU_DEBUG_RES=1``) — the
dynamic half of the ``res`` rtpu-lint rule family, mirroring
``rpc_debug.py`` / ``cuda_debug.py`` / ``lock_debug.py``: zero overhead
when the flag is off, and when on it turns the repo's acquire/release
seams into a per-process BALANCE registry:

- **BufferLease pin/release** (``protocol.BufferLease``): every lease
  registers on construction and settles when its release callable runs;
  a lease dropped on an error path (the forever-pinned-borrow
  shape) stays outstanding forever and shows up in every snapshot.
- **Lease grant/return** (``node_manager``): the node's lease table was
  a known leak site — grants register, every pop path (return, worker
  death, orphan reclaim) settles.
- **KV speculation begin/commit/release** (``kv_manager``): an
  in-flight reservation that neither commits nor dies with its slot
  strands ``used_blocks()`` permanently.
- **Store seal/delete**: counted as gauges (``counters()``) — the store
  legitimately holds objects across a snapshot, so they ride the dump
  for attribution but are never part of the leak verdict.
- **Tracked threads** (:func:`track_thread` — the make_lock move
  applied to thread registration): a started thread is outstanding
  until its ``run()`` returns; owners assert theirs are gone at
  ``close()``.

The outstanding-count snapshot rides every flight-recorder dump
(``flight_recorder.dump_payload``, ``"res_debug"`` key), so a
CLUSTER-WIDE ``leaked_resources`` count can be aggregated over the
same ``dump_flight`` RPC the RPC witness already uses —
and :func:`check_balanced` lets ``LLMEngine.close()`` /
``ClusterCore.shutdown()`` assert their scope drained at teardown
(violations print ``RTPU_DEBUG_RES:`` lines and are queryable via
:func:`violations`).

With ``RTPU_DEBUG_RES`` unset every hook is one env read returning its
input untouched — the instrumented paths are byte-identical to a build
without this module.

Knobs:
  RTPU_DEBUG_RES=1   enable the witness (inherited by every spawned
                     cluster process, like the other RTPU_DEBUG_ flags)
"""

from __future__ import annotations

import itertools
import os
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

#: Kinds whose outstanding count MUST be zero once a workload drains:
#: these feed the cluster-wide ``leaked_resources`` verdict.
#: "thread" is deliberately absent (daemon loops are legitimately alive
#: mid-run; owners assert them at close) and the store gauges are
#: informational only. The channel kinds (dag/ring.py, dag/peer.py)
#: count mapped ring files, spilled payload side-files, and peer
#: sockets: a compiled DAG or disaggregated-serving mesh torn down
#: without releasing them is a leak a chaos run fails on.
#: ``data_queue`` / ``data_operator`` (data/_queues.py, data/_executor.py)
#: count the streaming Dataset executor's bounded inter-operator queues
#: and long-lived operator actors: a pipeline torn down without closing
#: its edges or killing its lanes is a leak.
#: ``kv_page_obj`` (serve/engine/core.py + kv_fleet.py) counts IN-FLIGHT
#: fleet KV page transfers — a spilled block exported off-device but not
#: yet landed in the page store, or a pulled payload fetched but not yet
#: installed/rejected. Resident store objects are a cache, not a leak;
#: only a tier TRANSITION abandoned halfway is.
#: The serving front door's state joins the same ledger: ``qos_tenant``
#: (serve/_private/qos.py) counts live WFQ tenant lanes — configure()d
#: tenants are pinned by the operator, but lazily-minted ones must be
#: reaped once idle or a tenant-churn workload grows the scheduler
#: forever; ``serve_stream`` (serve/_private/replica.py) counts open
#: streaming cursor slots, released on completion, error, cancel, or
#: the TTL reaper; ``parked_kv`` (serve/engine/core.py) counts
#: preempted sessions parked with their KV residency — released on
#: resume or engine close. All three must balance after a
#: tenant-churn + stream-cancel loop drains.
LEAK_KINDS = ("buffer_lease", "lease", "kv_spec",
              "channel_ring", "channel_spill", "channel_sock",
              "data_queue", "data_operator", "kv_page_obj",
              "qos_tenant", "serve_stream", "parked_kv")


def enabled() -> bool:
    return os.environ.get("RTPU_DEBUG_RES", "") == "1"


class _Registry:
    """Process-global balance state: (kind, key) acquisitions vs
    releases, plus monotonic event counters (the store gauges)."""

    def __init__(self):
        self._mu = threading.Lock()
        self._seq = itertools.count(1)
        # (kind, key) -> {"owner": int|None, "note": str}
        self.open: Dict[Tuple[str, Any], dict] = {}
        self.acquired: Dict[str, int] = {}
        self.released: Dict[str, int] = {}
        self.counters: Dict[str, int] = {}
        self.violations: List[dict] = []

    def note_violation(self, kind: str, message: str, **fields) -> None:
        rec = {"kind": kind, "message": message}
        rec.update(fields)
        with self._mu:
            self.violations.append(rec)
        print(f"RTPU_DEBUG_RES: {message}", flush=True)

    def reset(self) -> None:
        with self._mu:
            self.open.clear()
            self.acquired.clear()
            self.released.clear()
            self.counters.clear()
            self.violations.clear()


_REGISTRY = _Registry()


# ----------------------------------------------------------- primitives


def note_acquire(kind: str, key: Any = None, owner: Any = None,
                 note: str = "") -> Any:
    """Register one acquisition; returns the key (minted when None).
    No-op (returns ``key``) when the witness is off."""
    if not enabled():
        return key
    if key is None:
        key = next(_REGISTRY._seq)
    with _REGISTRY._mu:
        _REGISTRY.acquired[kind] = _REGISTRY.acquired.get(kind, 0) + 1
        _REGISTRY.open[(kind, key)] = {"owner": id(owner) if owner
                                       is not None else None,
                                       "note": note}
    return key


def note_release(kind: str, key: Any) -> None:
    """Settle one acquisition. Unknown keys are ignored — release paths
    are legitimately re-entered (idempotent returns, double-release
    guards) and the witness must never turn a benign re-release into a
    false report. No-op when the witness is off."""
    if not enabled() or key is None:
        return
    with _REGISTRY._mu:
        if _REGISTRY.open.pop((kind, key), None) is not None:
            _REGISTRY.released[kind] = \
                _REGISTRY.released.get(kind, 0) + 1


def note_event(kind: str, n: int = 1) -> None:
    """Bump a monotonic gauge (store seal/delete). No-op when off."""
    if not enabled():
        return
    with _REGISTRY._mu:
        _REGISTRY.counters[kind] = _REGISTRY.counters.get(kind, 0) + n


def wrap_release(kind: str, release: Optional[Callable],
                 owner: Any = None) -> Optional[Callable]:
    """Pair an acquisition with its release callable (the BufferLease
    seam): registers now, settles when the returned callable runs.
    Returns ``release`` untouched when the witness is off."""
    if not enabled():
        return release
    key = note_acquire(kind, owner=owner)

    def _wrapped(*a, **kw):
        note_release(kind, key)
        if release is not None:
            return release(*a, **kw)

    return _wrapped


def track_thread(thread: "threading.Thread",
                 owner: Any = None) -> "threading.Thread":
    """make_lock-style registration for threads: the thread counts as
    outstanding from this call until its ``run()`` returns. Returns the
    thread untouched when the witness is off (zero overhead)."""
    if not enabled():
        return thread
    key = note_acquire("thread", owner=owner,
                       note=thread.name or "thread")
    orig_run = thread.run

    def _run():
        try:
            orig_run()
        finally:
            note_release("thread", key)

    thread.run = _run
    return thread


# ------------------------------------------------------------- queries


def outstanding(kind: Optional[str] = None,
                owner: Any = None) -> Dict[str, int]:
    """Open (unreleased) acquisitions per kind, optionally filtered to
    one kind and/or one owner object."""
    want_owner = id(owner) if owner is not None else None
    out: Dict[str, int] = {}
    with _REGISTRY._mu:
        for (k, _key), meta in _REGISTRY.open.items():
            if kind is not None and k != kind:
                continue
            if want_owner is not None and meta["owner"] != want_owner:
                continue
            out[k] = out.get(k, 0) + 1
    return out


def counts() -> Dict[str, Dict[str, int]]:
    """Per-kind {acquired, released, outstanding} totals."""
    with _REGISTRY._mu:
        kinds = set(_REGISTRY.acquired) | set(_REGISTRY.released)
        out = {}
        for k in kinds:
            a = _REGISTRY.acquired.get(k, 0)
            r = _REGISTRY.released.get(k, 0)
            out[k] = {"acquired": a, "released": r, "outstanding": a - r}
        return out


def counters() -> Dict[str, int]:
    """Monotonic event gauges (store seal/delete)."""
    with _REGISTRY._mu:
        return dict(_REGISTRY.counters)


def violations() -> List[dict]:
    with _REGISTRY._mu:
        return [dict(v) for v in _REGISTRY.violations]


def reset() -> None:
    """Clear the witness registry (tests isolate scenarios with this)."""
    _REGISTRY.reset()


def dump_payload() -> Dict[str, Any]:
    """The snapshot that rides ``flight_recorder.dump_payload`` under
    the ``"res_debug"`` key: outstanding per kind, leak-kind total,
    gauges, and violation count — enough for a chaos run to aggregate a
    cluster-wide leak verdict without a new RPC surface."""
    out = outstanding()
    with _REGISTRY._mu:
        acquired = dict(_REGISTRY.acquired)
    return {
        "outstanding": out,
        "leaked": sum(out.get(k, 0) for k in LEAK_KINDS),
        # Coverage evidence: how many acquisitions the witness actually
        # observed (a leaked==0 verdict over zero acquires is vacuous —
        # surface the sum as the audited acquisitions).
        "acquired": acquired,
        "counters": counters(),
        "violations": len(violations()),
    }


def check_balanced(scope: str, kinds: Tuple[str, ...],
                   owner: Any = None) -> bool:
    """Teardown assertion: every acquisition of ``kinds`` (optionally
    owner-scoped) has been released. Imbalance records a violation and
    prints an ``RTPU_DEBUG_RES:`` line — teardown itself proceeds (the
    witness reports, it never breaks the close path). Returns True when
    balanced / witness off."""
    if not enabled():
        return True
    bad = {}
    for k in kinds:
        n = outstanding(kind=k, owner=owner).get(k, 0)
        if n:
            bad[k] = n
    if not bad:
        return True
    detail = ", ".join(f"{k}={n}" for k, n in sorted(bad.items()))
    _REGISTRY.note_violation(
        "unbalanced-at-close",
        f"{scope} closed with unreleased resources: {detail} — an "
        "acquire path has no matching release (see reslint: "
        "acquire-without-release / begin-without-commit)",
        scope=scope, outstanding=dict(bad))
    return False
