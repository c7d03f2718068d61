"""Chrome-trace timeline export of per-task state events
(``ray_tpu/util/timeline.py``).

Parity target: `ray timeline` (reference: python/ray/_private/state.py
chrome_tracing_dump) fed by the task event buffer
(src/ray/core_worker/task_event_buffer.h -> GcsTaskManager).
Events are recorded into a bounded in-process ring buffer by the runtimes.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Optional

from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg

_lock = threading.Lock()
# Sized LAZILY from the config (and re-created on a size change): binding
# maxlen at import time froze the default — a task_events_buffer_size set
# via _system_config/env AFTER this module imported was silently ignored.
_events: Optional[deque] = None
_events_maxlen: int = -1


def _ring() -> deque:
    """Callers hold ``_lock``. Returns the ring, re-created (keeping the
    newest events) whenever the configured size changed."""
    global _events, _events_maxlen
    size = max(1, int(cfg.task_events_buffer_size))
    if _events is None or _events_maxlen != size:
        old = list(_events) if _events is not None else []
        _events = deque(old[-size:], maxlen=size)
        _events_maxlen = size
    return _events


def record_event(name: str, category: str, start_ts: float, end_ts: float,
                 pid: int = 0, tid: int = 0, args: Optional[dict] = None) -> None:
    with _lock:
        _ring().append({
            "name": name, "cat": category, "ph": "X",
            "ts": start_ts * 1e6, "dur": (end_ts - start_ts) * 1e6,
            "pid": pid, "tid": tid, "args": args or {},
        })


def record_instant(name: str, category: str = "event", args: Optional[dict] = None) -> None:
    with _lock:
        _ring().append({
            "name": name, "cat": category, "ph": "i", "ts": time.time() * 1e6,
            "pid": 0, "tid": 0, "s": "g", "args": args or {},
        })


def dump_timeline(filename: Optional[str] = None):
    with _lock:
        events = list(_ring())
    if filename is None:
        return events
    with open(filename, "w") as f:
        json.dump(events, f)
    return filename


def clear() -> None:
    with _lock:
        _ring().clear()
