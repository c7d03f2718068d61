"""SLO admission control: p99-TTFT-budgeted ingress backpressure
(``ray_tpu/serve/_private/slo.py``).

Parity target: the reference proxy's request-queueing + backoff
behavior (python/ray/serve/_private/proxy.py timeout/draining paths)
hardened into an explicit SLO: the ingress tracks a sliding window of
per-deployment TTFT samples and, while the p99 estimate exceeds the
configured budget (``serve_slo_ttft_budget_ms``), parks new arrivals in
a bounded queue instead of piling them onto an already-saturated
replica set. Queue overflow — or a queue wait past
``serve_slo_queue_timeout_s`` — sheds the request with a typed
``DeploymentOverloadedError`` (the HTTP proxy maps it to a 503), so
past saturation p99 of ADMITTED requests stays near the budget and the
overload is visible in a counter instead of as unbounded tail latency.

Recovery: while over budget, up to ``serve_slo_probe_inflight``
requests stay admitted at a time. Without the probe trickle no new TTFT
samples would arrive, the window would never slide past the breach, and
admission would stay closed until the queue timeout — the probes keep
the estimator live so the gate reopens one reconcile of samples after
the backlog drains.

Pure host-side state (no actor/RPC dependencies): unit-tested directly
in tests/test_serve_slo.py, wired into HTTPProxyActor per process.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Deque, Dict, Optional

from ray_tpu_torch.exceptions import RayTpuError
from ray_tpu_torch.serve._private.qos import DEFAULT_TENANT, TenantConfig, WFQQueue
from ray_tpu_torch.util import metrics as _m

ADMITTED_TOTAL = _m.Counter(
    "rtpu_serve_admitted_total",
    "ingress requests admitted past SLO admission control")
QUEUED_TOTAL = _m.Counter(
    "rtpu_serve_queued_total",
    "ingress requests that waited in the admission queue")
SHED_TOTAL = _m.Counter(
    "rtpu_serve_shed_total",
    "ingress requests shed (503) by SLO admission control")
TTFT_P99_MS = _m.Gauge(
    "rtpu_serve_ttft_p99_ms",
    "sliding-window p99 TTFT per deployment at the ingress")


class DeploymentOverloadedError(RayTpuError):
    """The deployment is past its TTFT budget and the admission queue is
    full (or the queued wait timed out): the request was shed, not run.
    HTTP ingress maps this to 503."""


class _DeploymentState:
    __slots__ = ("ttfts", "inflight", "queued", "admitted_total",
                 "queued_total", "shed_total", "wfq")

    def __init__(self, window: int):
        self.ttfts: Deque[float] = collections.deque(maxlen=window)  # ms
        self.inflight = 0
        self.queued = 0
        self.admitted_total = 0
        self.queued_total = 0
        self.shed_total = 0
        # Per-tenant WFQ ordering + token budgets (qos.py); with one
        # (default) tenant and no budgets it degenerates to the FIFO
        # gate this class always was.
        self.wfq = WFQQueue(window=window)


class AdmissionController:
    """Per-process SLO gate; one instance guards one ingress."""

    def __init__(self, *, budget_ms: Optional[float] = None,
                 queue_depth: Optional[int] = None,
                 queue_timeout_s: Optional[float] = None,
                 window: Optional[int] = None,
                 min_samples: Optional[int] = None,
                 probe_inflight: Optional[int] = None):
        from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg

        self.budget_ms = (cfg.serve_slo_ttft_budget_ms
                          if budget_ms is None else budget_ms)
        self.queue_depth = (cfg.serve_slo_queue_depth
                            if queue_depth is None else queue_depth)
        self.queue_timeout_s = (cfg.serve_slo_queue_timeout_s
                                if queue_timeout_s is None
                                else queue_timeout_s)
        self.window = cfg.serve_slo_window if window is None else window
        self.min_samples = (cfg.serve_slo_min_samples
                            if min_samples is None else min_samples)
        self.probe_inflight = (cfg.serve_slo_probe_inflight
                               if probe_inflight is None
                               else probe_inflight)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._deployments: Dict[str, _DeploymentState] = {}
        # Tenant contracts pushed via configure_tenant, applied to every
        # deployment's WFQ (including ones created later).
        self._tenant_cfgs: Dict[str, TenantConfig] = {}
        self._qos_may_block = False

    def _state(self, name: str) -> _DeploymentState:
        st = self._deployments.get(name)
        if st is None:
            st = self._deployments[name] = _DeploymentState(self.window)
            now = time.monotonic()
            for tenant, tcfg in self._tenant_cfgs.items():
                st.wfq.configure(tenant, tcfg, now)
        return st

    @staticmethod
    def _p99(samples: Deque[float]) -> float:
        vals = sorted(samples)
        return vals[min(len(vals) - 1, int(len(vals) * 0.99))]

    @staticmethod
    def _p50(samples: Deque[float]) -> float:
        vals = sorted(samples)
        return vals[len(vals) // 2] if vals else 0.0

    def _admittable(self, st: _DeploymentState) -> bool:
        """Callers hold the lock."""
        if self.budget_ms <= 0:
            return True
        if not st.ttfts or len(st.ttfts) < self.min_samples:
            return True  # cold/empty estimator never gates (an empty
            # window must not reach _p99 even when min_samples == 0)
        if self._p99(st.ttfts) <= self.budget_ms:
            return True
        # Over budget: only the probe trickle gets through.
        return st.inflight < self.probe_inflight

    # ----------------------------------------------------------- gate API

    def configure_tenant(self, tenant: str, *, weight: float = 1.0,
                         priority: int = 0, tokens_per_s: float = 0.0,
                         burst_tokens: float = 0.0) -> None:
        """Push one tenant's QoS contract (applies to every deployment
        this gate guards). Idempotent; reconfiguring adjusts the live
        bucket/weight in place."""
        cfg = TenantConfig(weight=weight, priority=priority,
                           tokens_per_s=tokens_per_s,
                           burst_tokens=burst_tokens)
        with self._cond:
            self._tenant_cfgs[tenant] = cfg
            now = time.monotonic()
            for st in self._deployments.values():
                st.wfq.configure(tenant, cfg, now)
            if tokens_per_s > 0:
                self._qos_may_block = True
            self._cond.notify_all()

    def may_block(self) -> bool:
        """Whether acquire() can park the caller: the asyncio proxy
        keeps the inline fast path only while this is False."""
        if self.budget_ms > 0 or self._qos_may_block:
            return True
        from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg

        return cfg.serve_qos_tokens_per_s > 0

    def _tenant_queue_depth(self) -> int:
        from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg

        return cfg.serve_qos_queue_depth or self.queue_depth

    def _admit_locked(self, st: _DeploymentState, name: str, tk,
                      now: float) -> None:
        tk.admitted = True
        st.wfq.admit(tk, now)
        st.inflight += 1
        st.admitted_total += 1
        ADMITTED_TOTAL.inc(labels={"deployment": name})

    def _drain_locked(self, st: _DeploymentState, name: str,
                      now: float) -> int:
        """Handoff admission (callers hold the lock): while capacity
        remains, admit eligible queue heads IN PLACE — their parked
        threads observe ``tk.admitted`` on wake and return. Without
        this, an open gate with a parked backlog would shed hot
        arrivals (they're not head) while the winners sleep until the
        next notify — admission would stall, then stampede. Returns
        how many tickets were admitted."""
        n = 0
        while self._admittable(st):
            tk = st.wfq.head(now)
            if tk is None:
                break
            self._admit_locked(st, name, tk, now)
            n += 1
        return n

    def acquire(self, name: str, tenant: Optional[str] = None,
                cost: float = 1.0) -> None:
        """Block until admitted; raises DeploymentOverloadedError when
        shed. Every successful acquire must be paired with release().

        ``tenant`` attributes the request for WFQ ordering and token
        budgets (qos.py); ``cost`` is its LLM-token footprint (prompt +
        max_new), the unit the tenant buckets are denominated in.
        Unattributed requests share the default tenant and behave
        exactly like the pre-QoS FIFO gate."""
        tenant = tenant or DEFAULT_TENANT
        with self._cond:
            st = self._state(name)
            now = time.monotonic()
            tk = st.wfq.submit(tenant, cost, now)
            # Handoff drain: earlier heads take capacity first, then —
            # capacity and budget permitting — this arrival (its own
            # head once the backlog admits). Parked winners are woken
            # below.
            if self._drain_locked(st, name, now) > (1 if tk.admitted
                                                    else 0):
                self._cond.notify_all()
            if tk.admitted:
                return
            # Not admittable right now (over budget, behind other
            # waiters, or budget-blocked): bounded per-TENANT queue —
            # one flooding tenant fills only its own line.
            if st.wfq.queued(tenant) - 1 >= self._tenant_queue_depth():
                st.wfq.cancel(tk)
                st.shed_total += 1
                st.wfq.note_shed(tenant, now)
                SHED_TOTAL.inc(labels={"deployment": name})
                raise DeploymentOverloadedError(
                    f"deployment {name!r}: tenant {tenant!r} admission "
                    f"queue ({self._tenant_queue_depth()}) is full")
            st.queued += 1
            st.queued_total += 1
            QUEUED_TOTAL.inc(labels={"deployment": name})
            deadline = time.monotonic() + self.queue_timeout_s
            try:
                while True:
                    now = time.monotonic()
                    remaining = deadline - now
                    if remaining <= 0:
                        st.shed_total += 1
                        st.wfq.note_shed(tenant, now)
                        SHED_TOTAL.inc(labels={"deployment": name})
                        raise DeploymentOverloadedError(
                            f"deployment {name!r}: admission queue wait "
                            f"exceeded {self.queue_timeout_s:.1f}s "
                            f"(tenant {tenant!r} over budget or p99 "
                            f"TTFT over budget)")
                    # A budget-blocked head refills on the clock, not
                    # on a notify: bound the park by the refill ETA.
                    wait = remaining
                    rw = st.wfq.next_refill_wait(now)
                    if rw is not None:
                        wait = min(wait, max(0.001, rw))
                    self._cond.wait(wait)
                    now = time.monotonic()
                    # A notifier may have handed us capacity while we
                    # slept; also self-drain for clock-driven refills
                    # (a budget-blocked head has no notifier).
                    if not tk.admitted:
                        if self._drain_locked(st, name, now) > (
                                1 if tk.admitted else 0):
                            self._cond.notify_all()
                    if tk.admitted:
                        return
            finally:
                st.queued -= 1
                if not tk.admitted:
                    st.wfq.cancel(tk)
                    self._cond.notify_all()

    def release(self, name: str, tenant: Optional[str] = None) -> None:
        with self._cond:
            st = self._deployments.get(name)
            if st is None:
                return
            if st.inflight > 0:
                st.inflight -= 1
            st.wfq.release(tenant or DEFAULT_TENANT)
            self._drain_locked(st, name, time.monotonic())
            self._cond.notify_all()

    def forget(self, name: str) -> None:
        """Drop a deployment's admission state once idle. The ingress
        calls this on the unknown-deployment 404 path — acquire() runs
        before the deployment lookup, so without eviction every scanned
        URL path would leak a window-sized state entry forever."""
        with self._cond:
            st = self._deployments.get(name)
            if st is not None and st.inflight == 0 and st.queued == 0 \
                    and st.wfq.idle():
                st.wfq.close()  # drop its tenant lanes
                del self._deployments[name]

    def record_ttft(self, name: str, ttft_ms: float,
                    tenant: Optional[str] = None) -> None:
        """Feed the estimator (one sample per admitted request, at
        first-token/first-result time)."""
        with self._cond:
            st = self._state(name)
            st.ttfts.append(ttft_ms)
            st.wfq.record_ttft(tenant or DEFAULT_TENANT, ttft_ms,
                               time.monotonic())
            TTFT_P99_MS.set(self._p99(st.ttfts),
                            labels={"deployment": name})
            self._drain_locked(st, name, time.monotonic())
            self._cond.notify_all()

    # ---------------------------------------------------------- inspection

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            out = {}
            for name, st in self._deployments.items():
                out[name] = {
                    "budget_ms": self.budget_ms,
                    "p50_ttft_ms": round(self._p50(st.ttfts), 3),
                    "p99_ttft_ms": (round(self._p99(st.ttfts), 3)
                                    if st.ttfts else 0.0),
                    "samples": len(st.ttfts),
                    "inflight": st.inflight,
                    "queued": st.queued,
                    "admitted_total": st.admitted_total,
                    "queued_total": st.queued_total,
                    "shed_total": st.shed_total,
                    "tenants": st.wfq.snapshot(),
                }
            return out
