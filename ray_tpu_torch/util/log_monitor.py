"""Log monitor: ships worker/node log lines to the driver's stdout.

Parity target: reference python/ray/_private/log_monitor.py:103 — the
reference tails per-worker log files and publishes lines to the driver;
here the driver tails the shared log dir directly (same host in-process
clusters; remote nodes' logs stay local to them).
"""

from __future__ import annotations

import glob
import os
import sys
import threading
import time
from typing import Dict, Optional


class LogMonitor:
    def __init__(self, log_dir: str,
                 poll_interval_s: Optional[float] = None,
                 out=None):
        from ray_tpu_torch.core.config import GLOBAL_CONFIG as _cfg

        self._dir = log_dir
        self._poll = (poll_interval_s if poll_interval_s is not None
                      else _cfg.log_monitor_poll_s)
        self._offsets: Dict[str, int] = {}
        self._stop = threading.Event()
        self._out = out or sys.stdout
        self._thread: threading.Thread = threading.Thread(
            target=self._loop, daemon=True, name="log-monitor")

    def start(self) -> "LogMonitor":
        # Existing content predates this driver: start at EOF, ship only
        # NEW lines (a fresh driver must not replay old clusters' logs).
        for path in glob.glob(os.path.join(self._dir, "*.log")):
            try:
                self._offsets[path] = os.path.getsize(path)
            except OSError:
                pass
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        while not self._stop.wait(self._poll):
            self.poll_once()

    def poll_once(self) -> int:
        shipped = 0
        for path in glob.glob(os.path.join(self._dir, "*.log")):
            pos = self._offsets.get(path, 0)
            try:
                size = os.path.getsize(path)
                if size <= pos:
                    if size < pos:  # truncated/rotated
                        self._offsets[path] = 0
                    continue
                with open(path, "rb") as f:
                    f.seek(pos)
                    chunk = f.read(256 * 1024)
                    self._offsets[path] = pos + len(chunk)
            except OSError:
                continue
            tag = os.path.basename(path).rsplit(".", 1)[0]
            text = chunk.decode(errors="replace")
            for line in text.splitlines():
                if line.strip():
                    print(f"({tag}) {line}", file=self._out)
                    shipped += 1
        return shipped
