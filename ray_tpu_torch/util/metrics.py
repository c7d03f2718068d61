"""Metrics: Counter/Gauge/Histogram + Prometheus text exposition
(``ray_tpu/util/metrics.py``).

Parity target: reference python/ray/util/metrics.py (user-defined
Counter/Gauge/Histogram) + src/ray/stats/metric.h (core metric defs,
OpenCensus -> Prometheus). One process-local registry; the driver
publishes its rendering to the head KV every `metrics_report_period_ms`
(cluster_runtime wires it), which `util.state.cluster_metrics()` reads.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Optional, Tuple

_REGISTRY_LOCK = threading.Lock()
_REGISTRY: Dict[str, "Metric"] = {}


_EMPTY_KEY: Tuple = ()


def _labels_key(labels: Optional[Dict[str, str]]) -> Tuple:
    # No-label counters ride per-task hot paths: skip dict+sort+tuple.
    if not labels:
        return _EMPTY_KEY
    return tuple(sorted(labels.items()))


class Metric:
    kind = "untyped"

    def __init__(self, name: str, description: str = ""):
        self.name = name
        self.description = description
        self._lock = threading.Lock()
        self._values: Dict[Tuple, float] = {}
        with _REGISTRY_LOCK:
            _REGISTRY[name] = self

    @staticmethod
    def _escape_label(v: str) -> str:
        # Prometheus text exposition: backslash, quote, and newline in
        # label values must be escaped — label values are arbitrary
        # user strings (actor names, engine names) and an unescaped
        # quote/comma corrupts every consumer's parse of the line.
        return (str(v).replace("\\", r"\\").replace('"', r'\"')
                .replace("\n", r"\n"))

    def _fmt_labels(self, key: Tuple) -> str:
        if not key:
            return ""
        inner = ",".join(f'{k}="{self._escape_label(v)}"'
                         for k, v in key)
        return "{" + inner + "}"

    def render(self) -> List[str]:
        with self._lock:
            items = list(self._values.items())
        lines = [f"# HELP {self.name} {self.description}",
                 f"# TYPE {self.name} {self.kind}"]
        for key, v in items:
            lines.append(f"{self.name}{self._fmt_labels(key)} {v}")
        return lines

    def items(self) -> List[Tuple[Dict[str, str], float]]:
        """Every (labels, value) pair recorded on this metric — the
        public per-label snapshot (readers must not touch _values)."""
        with self._lock:
            return [(dict(key), v) for key, v in self._values.items()]


class Counter(Metric):
    kind = "counter"

    def inc(self, value: float = 1.0,
            labels: Optional[Dict[str, str]] = None) -> None:
        k = _labels_key(labels)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + value

    def get(self, labels: Optional[Dict[str, str]] = None) -> float:
        with self._lock:
            return self._values.get(_labels_key(labels), 0.0)


class Gauge(Metric):
    kind = "gauge"

    def set(self, value: float,
            labels: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._values[_labels_key(labels)] = float(value)

    def get(self, labels: Optional[Dict[str, str]] = None) -> float:
        with self._lock:
            return self._values.get(_labels_key(labels), 0.0)


class Histogram(Metric):
    kind = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: Optional[List[float]] = None):
        super().__init__(name, description)
        self.boundaries = sorted(boundaries or
                                 [0.001, 0.01, 0.1, 1, 10, 60])
        self._counts: Dict[Tuple, List[int]] = {}
        self._sums: Dict[Tuple, float] = {}
        self._totals: Dict[Tuple, int] = {}

    def observe(self, value: float,
                labels: Optional[Dict[str, str]] = None) -> None:
        k = _labels_key(labels)
        with self._lock:
            counts = self._counts.setdefault(
                k, [0] * (len(self.boundaries) + 1))
            counts[bisect.bisect_left(self.boundaries, value)] += 1
            self._sums[k] = self._sums.get(k, 0.0) + value
            self._totals[k] = self._totals.get(k, 0) + 1

    def render(self) -> List[str]:
        with self._lock:
            items = list(self._counts.items())
            sums, totals = dict(self._sums), dict(self._totals)
        lines = [f"# HELP {self.name} {self.description}",
                 f"# TYPE {self.name} histogram"]
        for key, counts in items:
            cum = 0
            for b, c in zip(self.boundaries, counts):
                cum += c
                le = dict(key, le=str(b))
                lines.append(
                    f"{self.name}_bucket{self._fmt_labels(_labels_key(le))}"
                    f" {cum}")
            lines.append(f"{self.name}_bucket"
                         f"{self._fmt_labels(_labels_key(dict(key, le='+Inf')))}"
                         f" {totals.get(key, 0)}")
            lines.append(f"{self.name}_sum{self._fmt_labels(key)} "
                         f"{sums.get(key, 0.0)}")
            lines.append(f"{self.name}_count{self._fmt_labels(key)} "
                         f"{totals.get(key, 0)}")
        return lines


def prometheus_text() -> str:
    """The whole registry in Prometheus exposition format."""
    with _REGISTRY_LOCK:
        metrics = list(_REGISTRY.values())
    return "\n".join(line for m in metrics for line in m.render()) + "\n"


def has_samples() -> bool:
    """Whether any metric of the registry holds a recorded value."""
    with _REGISTRY_LOCK:
        metrics = list(_REGISTRY.values())
    return any(m._values or getattr(m, "_counts", None) for m in metrics)


def get_metric(name: str) -> Optional[Metric]:
    with _REGISTRY_LOCK:
        return _REGISTRY.get(name)


# ---------------------------------------------------------------- core set

TASKS_SUBMITTED = Counter("rtpu_tasks_submitted_total",
                          "tasks submitted by this process")
TASKS_FINISHED = Counter("rtpu_tasks_finished_total",
                         "task completions observed by this owner")
TASK_EXEC_SECONDS = Histogram("rtpu_task_exec_seconds",
                              "user-code execution time per task")
OBJECTS_PUT = Counter("rtpu_objects_put_total", "ray_tpu.put calls")
PUT_BYTES = Counter("rtpu_put_bytes_total", "bytes written via put")
ACTOR_CALLS = Counter("rtpu_actor_calls_total", "actor method submissions")
# Locality-aware scheduling (owner-side dispatch accounting): a task with
# known input locations counts a hit when it lands on the node holding the
# plurality of its input bytes, a miss otherwise.
SCHEDULER_LOCALITY_HITS = Counter(
    "rtpu_scheduler_locality_hits_total",
    "tasks dispatched to the node holding most of their input bytes")
SCHEDULER_LOCALITY_MISSES = Counter(
    "rtpu_scheduler_locality_misses_total",
    "tasks with known input locations dispatched to a non-holder node")
# Object plane (node-side pull manager).
OBJECT_BYTES_PULLED = Counter(
    "rtpu_object_bytes_pulled_total",
    "bytes fetched from remote nodes by this node's pull manager")
PULLS_COALESCED = Counter(
    "rtpu_pulls_coalesced_total",
    "duplicate concurrent pulls coalesced onto one in-flight transfer")
PULLS_MULTI_SOURCE = Counter(
    "rtpu_pulls_multi_source_total",
    "pulls whose chunks fanned out across multiple holder nodes")
