"""Runtime RPC-contract witness (``RTPU_DEBUG_RPC=1``) — the dynamic
half of the ``dist`` rtpu-lint rule family, mirroring ``cuda_debug.py``
and ``lock_debug.py``: zero overhead when the flag is off, and when on
it turns the protocol's declared retry/idempotency contract
(``protocol.READONLY_RPCS`` / ``IDEMPOTENT_RPCS`` / ``ACKED_RETRY_RPCS``
/ ``NON_RETRYABLE_RPCS``) into observable, assertable facts:

- **Classification hole** (:func:`dispatch_audit`): every method a
  server actually dispatches must appear in one of the declared sets.
  An unclassified method fails its RPC loudly (``UnclassifiedRpcError``
  back to the caller, ``RTPU_DEBUG_RPC:`` line on the server) instead
  of silently riding whatever retry semantics the caller assumed.
- **Duplicate-delivery audit**: requests for methods in
  ``IDEMPOTENT_RPCS`` are delivered TWICE (second delivery after the
  first completes — the lost-ack-then-retry shape) and the two
  responses must be equivalent: a mismatch means the handler's dedup
  key / state check does not actually make re-delivery a no-op, which
  is precisely what a head's WAL replay and re-delivery would
  silently corrupt. Read-only and acked-retry methods are exempt by
  classification (their responses may legitimately differ).
- **Outbox ordering witness** (:func:`stamp_outbox` /
  :func:`check_outbox`): object-directory ``object_batch`` frames are
  stamped with a per-(sender, receiver) sequence number at the sending
  outbox and checked monotonic at the receiver — a reordered,
  re-delivered, or outbox-bypassing add/remove frame (the add/remove
  inversion) is caught at the moment it arrives.

Violations are recorded in a process-local registry (:func:`violations`)
and printed as ``RTPU_DEBUG_RPC:`` lines; chaos scenarios and smokes
assert the registry (and the cluster logs) stay empty. With
``RTPU_DEBUG_RPC`` unset every hook is one env read returning
``None``/its input untouched — the dispatch path is byte-identical to a
build without this module.

Knobs:
  RTPU_DEBUG_RPC=1            enable the witness
  RTPU_DEBUG_RPC_DUP_NTH=N    duplicate every Nth idempotent request
                              (default 1 = every one; 0 disables the
                              duplicate-delivery audit only)
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple


def enabled() -> bool:
    return os.environ.get("RTPU_DEBUG_RPC", "") == "1"


def _dup_nth() -> int:
    try:
        return int(os.environ.get("RTPU_DEBUG_RPC_DUP_NTH", "1"))
    except ValueError:
        return 1


class UnclassifiedRpcError(RuntimeError):
    """A dispatched method is in neither RETRY_SAFE_RPCS (any group)
    nor NON_RETRYABLE_RPCS — its retry semantics are undeclared."""


#: IDEMPOTENT_RPCS members whose duplicate is effect-idempotent but
#: whose RESPONSE intentionally reports information a re-delivery
#: cannot observe. Kept deliberately tiny; every entry needs a reason.
DUP_RESPONSE_EXEMPT = {
    # Response is "did the key exist" — a duplicate of a successful
    # delete correctly reports False; the deletion itself is a no-op.
    "kv_del",
}

#: IDEMPOTENT_RPCS members the audit does NOT double-deliver: whole
#: object transfers whose duplicate costs a full re-copy and whose
#: outcome legitimately tracks concurrent peer liveness (under chaos
#: SIGKILLs the two deliveries can truthfully answer differently).
#: Their re-delivery safety ("local copy already present" fast path)
#: is covered by the chaos scenarios' real retries instead.
DUP_INJECT_SKIP = {
    "pull_object", "pull_direct", "push_object",
}


class _Registry:
    """Process-global witness state."""

    def __init__(self):
        self._mu = threading.Lock()
        self.violations: List[dict] = []
        self.dup_checked: Dict[str, int] = {}   # method -> dups injected
        self._dup_calls: Dict[str, int] = {}    # method -> calls seen
        self.send_seq: Dict[str, int] = {}      # sender -> last seq sent
        # (sender, receiver) -> highest seq accepted
        self.recv_seq: Dict[Tuple[str, str], int] = {}

    def note_violation(self, kind: str, message: str, **fields) -> None:
        rec = {"kind": kind, "message": message}
        rec.update(fields)
        with self._mu:
            self.violations.append(rec)
        print(f"RTPU_DEBUG_RPC: {message}", flush=True)

    def should_dup(self, method: str) -> bool:
        nth = _dup_nth()
        if nth <= 0:
            return False
        with self._mu:
            n = self._dup_calls.get(method, 0) + 1
            self._dup_calls[method] = n
            return n % nth == 0

    def note_dup(self, method: str) -> None:
        with self._mu:
            self.dup_checked[method] = self.dup_checked.get(method, 0) + 1

    def reset(self) -> None:
        with self._mu:
            self.violations.clear()
            self.dup_checked.clear()
            self._dup_calls.clear()
            self.send_seq.clear()
            self.recv_seq.clear()


_REGISTRY = _Registry()


def violations() -> List[dict]:
    with _REGISTRY._mu:
        return [dict(v) for v in _REGISTRY.violations]


def dup_audit_counts() -> Dict[str, int]:
    """How many duplicate deliveries were injected, per method."""
    with _REGISTRY._mu:
        return dict(_REGISTRY.dup_checked)


def reset() -> None:
    """Clear the witness registry (tests isolate scenarios with this)."""
    _REGISTRY.reset()


# ------------------------------------------------------------- dispatch


def _sets():
    # Deferred: protocol imports this module at its top level.
    from ray_tpu_torch.cluster import protocol as _p

    return (_p.RETRY_SAFE_RPCS, _p.IDEMPOTENT_RPCS, _p.NON_RETRYABLE_RPCS)


def _canonical(value: Any) -> Any:
    """A comparable form of a handler response: serialized header bytes
    plus raw buffer bytes (covers numpy arrays, PickleBuffer views, shm
    memoryviews). Falls back to ``==``-comparable passthrough."""
    from ray_tpu_torch.core.serialization import SERIALIZER

    header, buffers = SERIALIZER.serialize(value)
    return (bytes(header),
            [bytes(memoryview(b).cast("B")) for b in buffers])


def _equivalent(a: Any, b: Any) -> bool:
    try:
        return _canonical(a) == _canonical(b)
    except Exception:  # noqa: BLE001 — the witness must never break the
        try:           # call it observes; degrade to weaker comparisons
            return bool(a == b)
        except Exception:  # noqa: BLE001
            return repr(a) == repr(b)


def dispatch_audit(method: str,
                   handler_obj: Any = None) -> Optional[Callable]:
    """Per-dispatch audit hook. Returns None when the witness is off
    (the server's dispatch then runs the handler directly — unwrapped);
    when on, returns ``audit(fn, conn, args)`` which enforces the
    classification contract and injects duplicate delivery for
    idempotent methods.

    Server classes OUTSIDE the cluster control plane (test fixtures,
    future plugin servers) declare their methods locally instead of
    growing protocol.py's sets: class attributes
    ``extra_retry_safe_rpcs`` / ``extra_idempotent_rpcs`` /
    ``extra_non_retryable_rpcs`` (the ``dist`` lint family honors the
    same declarations)."""
    if not enabled():
        return None
    retry_safe, idempotent, non_retryable = _sets()
    if handler_obj is not None:
        retry_safe = retry_safe | frozenset(
            getattr(handler_obj, "extra_retry_safe_rpcs", ()))
        extra_idem = frozenset(
            getattr(handler_obj, "extra_idempotent_rpcs", ()))
        idempotent = idempotent | extra_idem
        retry_safe = retry_safe | extra_idem
        non_retryable = non_retryable | frozenset(
            getattr(handler_obj, "extra_non_retryable_rpcs", ()))
    if method not in retry_safe and method not in non_retryable:
        _REGISTRY.note_violation(
            "classification-hole",
            f"dispatched method '{method}' is in neither RETRY_SAFE_RPCS "
            "nor NON_RETRYABLE_RPCS — declare its retry semantics in "
            "cluster/protocol.py (unclassified-rpc-handler)",
            method=method)

        def refuse(fn, conn, args):
            raise UnclassifiedRpcError(
                f"rpc method '{method}' has no declared retry/idempotency "
                "classification (see cluster/protocol.py)")

        return refuse
    if method not in idempotent or method in DUP_INJECT_SKIP:
        return None  # classified; nothing further to audit per-call

    def audit(fn, conn, args):
        result = fn(conn, *args)
        if not _REGISTRY.should_dup(method):
            return result
        # Duplicate delivery: the lost-ack-then-retry shape — the same
        # request arrives again AFTER the first delivery completed.
        _REGISTRY.note_dup(method)
        try:
            dup = fn(conn, *args)
        except Exception as e:  # noqa: BLE001 — a raising duplicate IS
            _REGISTRY.note_violation(  # the reported defect
                "dup-raised",
                f"duplicate delivery of idempotent '{method}' raised "
                f"{e!r} where the first delivery succeeded — the "
                "handler's dedup does not tolerate re-delivery",
                method=method)
            return result
        # BufferLease duplicates borrow pinned memory: compare the
        # value, then release the duplicate's pin (the original lease
        # flows onward to the response path as usual).
        from ray_tpu_torch.cluster.protocol import BufferLease

        r_val = result.value if isinstance(result, BufferLease) else result
        d_val = dup.value if isinstance(dup, BufferLease) else dup
        try:
            if method not in DUP_RESPONSE_EXEMPT and \
                    not _equivalent(r_val, d_val):
                _REGISTRY.note_violation(
                    "dup-mismatch",
                    f"duplicate delivery of idempotent '{method}' "
                    f"returned a different response ({_clip(r_val)} vs "
                    f"{_clip(d_val)}) — at-most-once is not actually "
                    "held by its dedup key/state check",
                    method=method)
        finally:
            if isinstance(dup, BufferLease):
                dup.release()
        return result

    return audit


def _clip(v: Any, limit: int = 80) -> str:
    s = repr(v)
    return s if len(s) <= limit else s[: limit - 3] + "..."


# ------------------------------------------------------- outbox ordering

#: Marker entry prepended to a stamped object_batch frame. Shaped like a
#: real ("kind", oid, size) entry so an unmatched receiver (which cannot
#: happen with inherited env, but defensively) degrades harmlessly.
SEQ_KIND = "__rtpu_dbg_seq__"


def stamp_outbox(sender: str, entries: list) -> list:
    """Prepend a per-sender sequence entry to an outbox frame (no-op
    when the witness is off or the frame is empty). ``sender`` must be
    stable for the life of the sending process (owner address, node
    id); a respawned process is a new sender."""
    if not enabled() or not entries:
        return entries
    with _REGISTRY._mu:
        n = _REGISTRY.send_seq.get(sender, 0) + 1
        _REGISTRY.send_seq[sender] = n
    return [(SEQ_KIND, sender, n)] + list(entries)


def check_outbox(receiver: str, entries: list) -> list:
    """Strip sequence entries from a received outbox frame, asserting
    per-(sender, receiver) monotonicity: a frame arriving with a
    sequence number at or below the last accepted one was re-delivered
    or reordered — an add/remove inversion waiting to corrupt the
    directory. A frame carrying NO stamp at all is a violation too:
    with the witness on, every designated outbox sender stamps (the
    env is inherited process-tree-wide), so an unstamped frame came
    from a path that bypassed the outbox — the stale-directory bug class, caught
    on arrival. Returns the frame without the marker entries."""
    if not entries:
        return entries
    if enabled():
        try:
            stamped = any(e and e[0] == SEQ_KIND for e in entries)
        except Exception:  # noqa: BLE001 — malformed entries are the
            stamped = True  # receiver's problem, not the witness's
        if not stamped:
            _REGISTRY.note_violation(
                "outbox-unstamped",
                f"outbox frame arrived at '{receiver}' with no "
                "sequence stamp — it was sent outside the designated "
                "outbox sender (direct-notify-bypasses-outbox, the "
                "stale-directory bug class)",
                receiver=receiver)
    out = []
    for e in entries:
        try:
            is_seq = e[0] == SEQ_KIND
        except Exception:  # noqa: BLE001 — malformed entries are the
            is_seq = False  # receiver's problem, not the witness's
        if not is_seq:
            out.append(e)
            continue
        _, sender, n = e
        inverted = False
        with _REGISTRY._mu:
            # pop + reinsert = move-to-end: eviction below is LRU by
            # last frame, not insertion order (a dict updated in place
            # keeps its original position, so plain FIFO would evict
            # the busiest LIVE streams — inserted at cluster start —
            # while dead respawned senders survived).
            last = _REGISTRY.recv_seq.pop((sender, receiver), None)
            if last is not None and n <= last:
                inverted = True
            _REGISTRY.recv_seq[(sender, receiver)] = max(n, last or 0)
            # Bounded: every respawned peer is a NEW sender (that is
            # the point of the per-incarnation stream), so a long
            # chaos run accretes dead-sender entries forever — the
            # exact unbounded-registry-growth shape this repo's res
            # lint family polices. Evict the least-recently-heard-from
            # stream (a dead sender, by construction); losing its
            # high-water mark can only relax a check, never fabricate
            # a violation.
            while len(_REGISTRY.recv_seq) > 4096:
                _REGISTRY.recv_seq.pop(next(iter(_REGISTRY.recv_seq)))
        if inverted:
            _REGISTRY.note_violation(
                "outbox-inversion",
                f"outbox frame from '{sender}' arrived at '{receiver}' "
                f"with seq {n} <= last accepted {last} — frames were "
                "reordered or re-delivered (add/remove inversion "
                "hazard)",
                sender=sender, receiver=receiver, seq=n, last=last)
    return out
