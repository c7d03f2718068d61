"""Node memory monitor: kill the worst worker before the kernel OOMs us.

Parity target: the reference's MemoryMonitor + worker killing policy
(reference: src/ray/common/memory_monitor.h:52 usage_threshold refresh
loop, src/ray/raylet/worker_killing_policy.h group-by-and-kill-newest),
re-designed small: a node-manager thread samples cgroup/host memory every
``memory_monitor_refresh_ms``; above ``memory_usage_threshold`` it kills
the highest-RSS NON-ACTOR worker first (retriable — the submitter's
worker-crash path resubmits the task), falling back to the newest actor
host. Each kill is logged with a per-process RSS breakdown so the
operator can see WHY (the reference's TopNMemoryDebugString).
"""

from __future__ import annotations

import os
import time
from typing import List, Optional, Tuple


def _host_memory() -> Tuple[int, int]:
    """(used_bytes, total_bytes) — cgroup v2 limits win over /proc (the
    container's ceiling is what the kernel enforces)."""
    try:
        with open("/sys/fs/cgroup/memory.max") as f:
            raw = f.read().strip()
        if raw != "max":
            limit = int(raw)
            with open("/sys/fs/cgroup/memory.current") as f:
                used = int(f.read().strip())
            return used, limit
    except OSError:
        pass
    total = avail = 0
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemTotal:"):
                total = int(line.split()[1]) * 1024
            elif line.startswith("MemAvailable:"):
                avail = int(line.split()[1]) * 1024
    return total - avail, total


def _rss_bytes(pid: int) -> int:
    try:
        with open(f"/proc/{pid}/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, IndexError, ValueError):
        return 0


class MemoryMonitor:
    """Runs inside the node manager; consult + kill via the worker table."""

    def __init__(self, node_manager, usage_threshold: float,
                 refresh_ms: int, min_kill_interval_s: float = 5.0):
        self._nm = node_manager
        self.threshold = usage_threshold
        self.refresh_s = max(0.1, refresh_ms / 1000.0)
        self.min_kill_interval_s = min_kill_interval_s
        self._last_kill = 0.0
        self.kills = 0

    def tick(self) -> Optional[int]:
        """One refresh; returns the killed pid (or None)."""
        used, total = _host_memory()
        if total <= 0 or used / total < self.threshold:
            return None
        if time.monotonic() - self._last_kill < self.min_kill_interval_s:
            return None
        victim = self._pick_victim()
        if victim is None:
            return None
        pid = victim.proc.pid
        try:
            import sys

            print(f"memory monitor: host at {used / total:.0%} "
                  f"(threshold {self.threshold:.0%}); killing worker "
                  f"{victim.worker_id[:8]} pid={pid} "
                  f"rss={_rss_bytes(pid) >> 20}MB\n"
                  f"{self._top_n_debug(5)}",
                  file=sys.stderr, flush=True)
            victim.proc.kill()
        except Exception:
            return None
        self._last_kill = time.monotonic()
        self.kills += 1
        return pid

    def _pick_victim(self):
        """Highest-RSS plain task worker first (tasks are retriable);
        newest actor host only as a last resort (reference killing policy:
        prefer retriable, then newest)."""
        with self._nm._lock:
            workers = [w for w in self._nm._workers.values()
                       if w.proc.poll() is None and w.ready.is_set()]
        if not workers:
            return None
        task_workers = [w for w in workers if not w.is_actor_host]
        pool = task_workers or workers
        busy = [w for w in pool if w.lease_id is not None
                or w.is_actor_host]
        pool = busy or pool
        if pool and pool[0].is_actor_host:
            return max(pool, key=lambda w: w.idle_since)  # newest actor
        return max(pool, key=lambda w: _rss_bytes(w.proc.pid))

    def _top_n_debug(self, n: int) -> str:
        with self._nm._lock:
            workers = [w for w in self._nm._workers.values()
                       if w.proc.poll() is None]
        rows = sorted(((_rss_bytes(w.proc.pid), w.proc.pid,
                        w.worker_id[:8]) for w in workers), reverse=True)
        return "\n".join(f"  rss={r >> 20:6d}MB pid={p} worker={wid}"
                         for r, p, wid in rows[:n])

    def run_forever(self, stop_event) -> None:
        while not stop_event.wait(self.refresh_s):
            try:
                self.tick()
            except Exception:
                pass
