"""Per-engine serving metrics: TTFT, TPOT, host syncs, decode utilization,
speculation (drafted, accepted, verify chunks).

``ray_tpu/serve/engine/metrics.py`` feeds both a process-wide Prometheus
registry and ``EngineMetrics.snapshot()``; the port keeps only the
snapshot — plain counters that the engine's ``stats()`` reads. The
registry comes with the serve runtime (ROADMAP).
"""

from __future__ import annotations

import collections
import itertools
import threading
from typing import Any, Dict, Optional

_ENGINE_SEQ = itertools.count()


class EngineMetrics:
    """One engine's counters: written by the engine thread, read by
    callers' ``stats()`` (every access holds ``_lock``)."""

    def __init__(self, name: Optional[str] = None):
        self.name = name or f"engine-{next(_ENGINE_SEQ)}"
        self._lock = threading.Lock()
        self.requests = 0
        self.tokens_generated = 0
        self.prefill_tokens = 0
        self.host_syncs = 0        # decode-loop device fetches
        self.decode_steps = 0      # live slot-steps advanced on device
        self.spec_drafted = 0      # draft tokens proposed
        self.spec_accepted = 0     # draft tokens verified + accepted
        self.spec_chunks = 0       # chunks through the verify program
        self._ttfts = collections.deque(maxlen=256)   # seconds
        self._tpots = collections.deque(maxlen=1024)  # seconds/token
        self._ewma_ttft_s: Optional[float] = None

    def record_admit(self, ttft_s: float, prefill_tokens: int) -> None:
        with self._lock:
            self.requests += 1
            self.prefill_tokens += prefill_tokens
            self.tokens_generated += 1  # prefill yields the first token
            self._ttfts.append(ttft_s)
            self._ewma_ttft_s = (ttft_s if self._ewma_ttft_s is None
                                 else 0.3 * ttft_s
                                 + 0.7 * self._ewma_ttft_s)

    def record_chunk(self, tokens: int, live_steps: int,
                     elapsed_s: float) -> None:
        """One decode-loop dispatch+fetch: ``tokens`` delivered to
        callers, ``live_steps`` device steps across live slots."""
        with self._lock:
            self.host_syncs += 1
            self.tokens_generated += tokens
            self.decode_steps += live_steps
            if tokens:
                self._tpots.append(elapsed_s / tokens)

    def record_spec(self, drafted: int, accepted: int) -> None:
        """One speculative verify chunk: ``drafted`` tokens proposed
        across the roster, ``accepted`` of them verified correct."""
        with self._lock:
            self.spec_chunks += 1
            self.spec_drafted += drafted
            self.spec_accepted += accepted

    @staticmethod
    def _p50(values) -> float:
        vals = sorted(values)
        return vals[len(vals) // 2] if vals else 0.0

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "engine": self.name,
                "requests": self.requests,
                "tokens_generated": self.tokens_generated,
                "prefill_tokens": self.prefill_tokens,
                "decode_host_syncs": self.host_syncs,
                "decode_steps": self.decode_steps,
                # decode tokens delivered per device token-position
                # scanned (first tokens come from prefill): < 1.0 when
                # slots freeze mid-chunk or drafted window positions are
                # rejected.
                "decode_utilization": round(
                    (self.tokens_generated - self.requests)
                    / self.decode_steps, 4) if self.decode_steps else 0.0,
                "spec_chunks": self.spec_chunks,
                "spec_drafted": self.spec_drafted,
                "spec_accepted": self.spec_accepted,
                "spec_accept_rate": round(
                    self.spec_accepted / self.spec_drafted, 4)
                    if self.spec_drafted else 0.0,
                "ttft_ms_p50": round(self._p50(self._ttfts) * 1e3, 3),
                "ttft_ms_ewma": round((self._ewma_ttft_s or 0.0) * 1e3, 3),
                "tpot_ms_p50": round(self._p50(self._tpots) * 1e3, 3),
            }
