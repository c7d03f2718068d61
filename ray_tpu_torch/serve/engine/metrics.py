"""Per-engine serving metrics: TTFT, TPOT, host syncs, decode utilization,
speculation (drafted, accepted, verify chunks)
(``ray_tpu/serve/engine/metrics.py``).

Two surfaces, one source of truth:

- the process-global Prometheus registry (util/metrics.py) gets the
  engine-labelled counters/histograms/gauges under ``ray_tpu``'s names and
  help strings (dashboards carry over); a cluster process publishes the
  registry to the head's KV (``metrics/<node>``) and a node manager serves
  it at ``GET /metrics``;
- ``EngineMetrics.snapshot()`` feeds the engine's ``stats()`` surface
  with plain floats.
"""

from __future__ import annotations

import collections
import itertools
import threading
from typing import Any, Dict, Optional

from ray_tpu_torch.util import metrics as _m

_ENGINE_SEQ = itertools.count()

# Registry metrics are process-global and engine-labelled; module import
# creates them once (util/metrics.py registers by name).
TTFT_SECONDS = _m.Histogram(
    "rtpu_llm_ttft_seconds", "time to first generated token",
    boundaries=[0.001, 0.005, 0.02, 0.1, 0.5, 2, 10, 60])
TPOT_SECONDS = _m.Histogram(
    "rtpu_llm_tpot_seconds", "per-output-token decode time",
    boundaries=[0.0005, 0.002, 0.01, 0.05, 0.2, 1])
QUEUE_DEPTH = _m.Gauge("rtpu_llm_queue_depth",
                       "requests waiting for a slot")
ACTIVE_SLOTS = _m.Gauge("rtpu_llm_active_slots",
                        "slots decoding this tick")
PREFIX_HIT_RATE = _m.Gauge("rtpu_llm_prefix_hit_rate",
                           "prefix-cache hit rate since engine start")
REQUESTS_TOTAL = _m.Counter("rtpu_llm_requests_total",
                            "generation requests accepted")
TOKENS_TOTAL = _m.Counter("rtpu_llm_tokens_generated_total",
                          "tokens returned to callers")
PREFILL_TOKENS_TOTAL = _m.Counter(
    "rtpu_llm_prefill_tokens_total",
    "prompt tokens run through prefill (bucket-padded tokens excluded)")
PREFIX_REUSED_TOTAL = _m.Counter(
    "rtpu_llm_prefix_tokens_reused_total",
    "prompt tokens served from the prefix cache instead of prefill")
HOST_SYNCS_TOTAL = _m.Counter(
    "rtpu_llm_decode_host_syncs_total",
    "device->host fetches issued by the decode loop (one per chunk)")
SPEC_DRAFTED_TOTAL = _m.Counter(
    "rtpu_llm_spec_drafted_total",
    "draft tokens proposed by prompt-lookup speculation")
SPEC_ACCEPTED_TOTAL = _m.Counter(
    "rtpu_llm_spec_accepted_total",
    "draft tokens accepted by the device verify step")
SPEC_ACCEPT_RATE = _m.Gauge(
    "rtpu_llm_spec_accept_rate",
    "accepted/drafted ratio since engine start")
SPEC_CHUNKS_TOTAL = _m.Counter(
    "rtpu_llm_spec_chunks_total",
    "decode chunks dispatched through the speculative verify program")
# TTFT decomposition (labels: component=queue|route|prefill) — the
# serve-path breakdown the router/SLO PRs are judged on: `queue` is the
# engine-side wait from arrival to prefill dispatch, `route` the
# handle-side replica choice, `prefill` the device prefill + first-token
# fetch. Fed by api.DeploymentHandle (route) and the engine's admission
# path (queue/prefill); always on — two clock reads per request.
SERVE_TTFT_BREAKDOWN_MS = _m.Histogram(
    "rtpu_serve_ttft_breakdown_ms",
    "TTFT component breakdown in milliseconds (component label)",
    boundaries=[0.1, 0.5, 2, 10, 50, 250, 1000, 5000])


class EngineMetrics:
    """One engine's counters: written by the engine thread, read by
    callers' ``stats()`` (every access holds ``_lock``)."""

    def __init__(self, name: Optional[str] = None):
        self.name = name or f"engine-{next(_ENGINE_SEQ)}"
        self._labels = {"engine": self.name}
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

    def record_admit(self, ttft_s: float, prefill_tokens: int,
                     reused_tokens: int = 0) -> None:
        with self._lock:
            self.requests += 1
            self.prefill_tokens += prefill_tokens
            self.tokens_generated += 1  # prefill yields the first token
            self._ttfts.append(ttft_s)
            self._ewma_ttft_s = (ttft_s if self._ewma_ttft_s is None
                                 else 0.3 * ttft_s
                                 + 0.7 * self._ewma_ttft_s)
        REQUESTS_TOTAL.inc(labels=self._labels)
        TOKENS_TOTAL.inc(labels=self._labels)
        TTFT_SECONDS.observe(ttft_s, labels=self._labels)
        PREFILL_TOKENS_TOTAL.inc(prefill_tokens, labels=self._labels)
        if reused_tokens:
            PREFIX_REUSED_TOTAL.inc(reused_tokens, labels=self._labels)

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
        HOST_SYNCS_TOTAL.inc(labels=self._labels)
        if tokens:
            TOKENS_TOTAL.inc(tokens, labels=self._labels)
            TPOT_SECONDS.observe(elapsed_s / tokens, labels=self._labels)

    def record_spec(self, drafted: int, accepted: int) -> None:
        """One speculative verify chunk: ``drafted`` tokens proposed
        across the roster, ``accepted`` of them verified correct."""
        with self._lock:
            self.spec_chunks += 1
            self.spec_drafted += drafted
            self.spec_accepted += accepted
            rate = (self.spec_accepted / self.spec_drafted
                    if self.spec_drafted else 0.0)
        SPEC_CHUNKS_TOTAL.inc(labels=self._labels)
        if drafted:
            SPEC_DRAFTED_TOTAL.inc(drafted, labels=self._labels)
        if accepted:
            SPEC_ACCEPTED_TOTAL.inc(accepted, labels=self._labels)
        SPEC_ACCEPT_RATE.set(rate, labels=self._labels)

    def record_depths(self, queue_depth: int, active: int,
                      prefix_hit_rate: float) -> None:
        QUEUE_DEPTH.set(queue_depth, labels=self._labels)
        ACTIVE_SLOTS.set(active, labels=self._labels)
        PREFIX_HIT_RATE.set(prefix_hit_rate, labels=self._labels)

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
