"""Always-on, lock-cheap per-process flight recorder
(``ray_tpu/util/flight_recorder.py``). A dump carries the debug
witnesses' per-process stats (``"rpc_debug"``, ``"res_debug"`` and
``"chan_debug"`` keys, each only with its flag on), and the chaos harness
dumps the ring just before a planned kill (``devtools/chaos.py``).

Parity target: the reference's in-memory event recorders (the GCS/raylet
debug-state dumps plus RAY_event ring buffers) redesigned as one tiny
per-process ring of structured runtime events — RPC dispatches,
heartbeats, lease churn, store create/seal/evict, engine ticks — that is
ALWAYS on (the default ring costs one deque append per event) and can be
dumped at the moment of death:

- ``rpc_dump_flight`` on the head, every node manager, and every worker
  runtime returns the live ring over RPC (``scripts/trace_dump.py``
  merges them into one chrome-trace JSON);
- ``install_signal_handler()`` arms SIGUSR2 = dump-to-file (the analog
  of faulthandler's SIGUSR1 stack dump, but for runtime events);
- worker processes dump on an unhandled fatal exception — the
  post-mortem record of the seconds before a death.

Hot-path discipline: ``record()`` is a config read + one bounded-deque
append (GIL-atomic; no lock). Events are ``[wall_ts, kind, fields]``
with JSON-safe scalar fields only — callers must not pass payload
objects. Dumps never raise into their caller.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg

# Bounded deque; append/popleft are GIL-atomic so the hot path takes no
# lock. The lock below only serializes resize (config change) and dump.
# REENTRANT: the SIGUSR2 dump handler runs between bytecodes ON the
# thread that received the signal — if that thread is inside dump/resize
# holding the lock, a plain Lock would self-deadlock the process at the
# exact moment an operator asks for a post-mortem.
_ring: Optional[collections.deque] = None
_ring_maxlen: int = -1
_lock = threading.RLock()
_role = "proc"  # head / node / worker / driver — set by process entry
_node_id: Optional[str] = None
_clock_offset_s: Optional[float] = None  # head_time - local_time (EWMA)
_dump_seq = 0


def enabled() -> bool:
    return bool(cfg.flight_recorder_enabled)


def set_role(role: str, node_id: Optional[str] = None) -> None:
    """Tag this process's events/dumps (head/node/worker/driver). The
    node id + clock offset ride every dump — including the OFFLINE ones
    (SIGUSR2 / worker-death), so trace_dump can clock-align
    a dead process's last seconds."""
    global _role, _node_id
    _role = role
    if node_id is not None:
        _node_id = node_id


def set_clock_offset(offset_s: float) -> None:
    """Record this process's head-relative clock offset (node managers
    update it from their heartbeat-RTT probe)."""
    global _clock_offset_s
    _clock_offset_s = offset_s


def _get_ring() -> collections.deque:
    global _ring, _ring_maxlen
    size = int(cfg.flight_recorder_size)
    if _ring is None or _ring_maxlen != size:
        with _lock:
            if _ring is None or _ring_maxlen != size:
                old = list(_ring) if _ring is not None else []
                _ring = collections.deque(old, maxlen=max(1, size))
                _ring_maxlen = size
    return _ring


def record(kind: str, **fields: Any) -> None:
    """Append one event. One config read + one deque append when on;
    a single branch when off."""
    if not cfg.flight_recorder_enabled:
        return
    _get_ring().append([time.time(), kind, fields])


def snapshot() -> List[list]:
    """A consistent copy of the ring (oldest first)."""
    if _ring is None:
        return []
    with _lock:
        return list(_ring)


def clear() -> None:
    with _lock:
        if _ring is not None:
            _ring.clear()


def dump_payload(clock_offset_s: Optional[float] = None) -> Dict[str, Any]:
    """The RPC/dump-file payload: ring + enough identity to merge dumps
    from many processes (``scripts/trace_dump.py``). ``clock_offset_s``
    defaults to the process's registered estimate (set_clock_offset)."""
    payload = {
        "role": _role,
        "pid": os.getpid(),
        "node_id": _node_id,
        "dumped_at": time.time(),
        "clock_offset_s": (clock_offset_s if clock_offset_s is not None
                           else _clock_offset_s),
        "events": snapshot(),
    }
    # The witnesses' stats ride the flight dump: it is the one channel
    # every process (head/node/worker) already serves, so a driver can
    # aggregate cluster-wide audit coverage, leak and violation counts
    # without a new RPC surface.
    from ray_tpu_torch.devtools import chan_debug as _chandbg
    from ray_tpu_torch.devtools import res_debug as _resdbg
    from ray_tpu_torch.devtools import rpc_debug as _rpcdbg

    if _rpcdbg.enabled():
        payload["rpc_debug"] = {
            "violations": len(_rpcdbg.violations()),
            "dup_audits": sum(_rpcdbg.dup_audit_counts().values()),
        }
    if _resdbg.enabled():
        payload["res_debug"] = _resdbg.dump_payload()
    if _chandbg.enabled():
        payload["chan_debug"] = _chandbg.dump_payload()
    return payload


def dump_to_file(reason: str = "manual",
                 clock_offset_s: Optional[float] = None) -> Optional[str]:
    """Write the ring to a JSON file under ``flight_recorder_dump_dir``
    (default: the log dir). Returns the path, or None on failure —
    dumps run at death sites and must never raise into their caller."""
    global _dump_seq
    try:
        d = cfg.flight_recorder_dump_dir or cfg.log_dir
        os.makedirs(d, exist_ok=True)
        with _lock:
            _dump_seq += 1
            seq = _dump_seq
        path = os.path.join(
            d, f"flight-{_role}-{os.getpid()}-{seq}.json")
        payload = dump_payload(clock_offset_s)
        payload["reason"] = reason
        with open(path, "w") as f:
            json.dump(payload, f, default=str)
        return path
    except Exception:  # noqa: BLE001 — death-site dumps must never raise
        return None


def install_signal_handler() -> bool:
    """Arm SIGUSR2 = dump-to-file. Main-thread only (signal module
    restriction); returns False where that isn't possible."""
    import signal

    def _on_sigusr2(_signum, _frame):
        path = dump_to_file(reason="SIGUSR2")
        if path:
            print(f"RTPU_FLIGHT: dumped {path}", flush=True)

    try:
        signal.signal(signal.SIGUSR2, _on_sigusr2)
        return True
    except (ValueError, OSError):  # not the main thread / unsupported
        return False
