"""Per-tenant QoS: weighted fair queueing, token budgets, priorities
(``ray_tpu/serve/_private/qos.py``). Under ``RTPU_DEBUG_RES=1`` every
lazily minted tenant lane is a ``qos_tenant`` entry of the resource
witness, settled when the lane is reaped, pinned by ``configure`` or
dropped with its deployment.

Parity target: the reference Serve proxy has no tenant isolation — one
flooding client saturates the shared admission path for everyone.
This module supplies the ordering policy the SLO gate (slo.py) consults
when it has to park arrivals: requests carry a tenant id, each tenant
has a :class:`TenantConfig` (WFQ weight, strict priority class, token
budget), and the gate admits in

1. PRIORITY order — higher classes strictly first;
2. within a class, WEIGHTED FAIR order — classic WFQ virtual time
   (Demers/Keshav/Shenker '89): each request is stamped with a virtual
   finish tag ``start + cost / weight`` chained per tenant, and the
   eligible request with the smallest tag admits next, so tenants split
   contended capacity in proportion to their weights regardless of
   arrival rates;
3. subject to the tenant's TOKEN BUCKET — ``cost`` is the request's LLM
   token footprint (prompt + max_new_tokens), refilled at
   ``tokens_per_s`` up to ``burst_tokens``. A tenant past its budget is
   ineligible until refill; other tenants are unaffected (their queues
   and budgets are independent), which is the flood-isolation property
   bench.py --serve-scale asserts.

Pure host-side state, no locking (the owning AdmissionController holds
its condition-variable lock around every call) and no RPC surface —
tenant configs are pushed via AdmissionController.configure_tenant /
HTTPProxyActor.configure_qos.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
from typing import Any, Deque, Dict, Optional

from ray_tpu_torch.devtools import res_debug as _resdbg

#: Requests with no tenant attribution share one bucket/queue under
#: this id (single-tenant deployments behave exactly like the pre-QoS
#: FIFO gate: one tenant, equal tags, unlimited budget).
DEFAULT_TENANT = "default"


@dataclasses.dataclass
class TenantConfig:
    """One tenant's service contract at the admission gate."""
    weight: float = 1.0        # WFQ share under contention (> 0)
    priority: int = 0          # strict class: higher admits first
    tokens_per_s: float = 0.0  # budget refill (LLM tokens/s); 0 = unlimited
    burst_tokens: float = 0.0  # bucket cap; 0 derives 4s of refill


class _Ticket:
    """One queued request's place in line. ``admitted`` flips when a
    NOTIFIER hands this ticket capacity directly (handoff admission:
    the gate admits eligible heads in place instead of waking parked
    threads and hoping they re-check before the capacity is gone — a
    wake-lag would otherwise shed hot arrivals against a backlog of
    still-sleeping winners)."""
    __slots__ = ("tenant", "cost", "vtag", "seq", "cancelled", "admitted")

    def __init__(self, tenant: str, cost: float, vtag: float, seq: int):
        self.tenant = tenant
        self.cost = cost
        self.vtag = vtag
        self.seq = seq
        self.cancelled = False
        self.admitted = False


class _Tenant:
    __slots__ = ("cfg", "bucket", "last_refill", "vfinish", "queue",
                 "inflight", "admitted", "shed", "ttfts",
                 "last_active", "pinned")

    def __init__(self, cfg: TenantConfig, now: float, window: int):
        self.cfg = cfg
        self.bucket = self._cap(cfg)
        self.last_refill = now
        self.vfinish = 0.0
        self.queue: Deque[_Ticket] = collections.deque()
        self.inflight = 0
        self.admitted = 0
        self.shed = 0
        # Per-tenant TTFT window: the bench's per-tenant p99 rows and
        # the flood-isolation assertion read these.
        self.ttfts: Deque[float] = collections.deque(maxlen=window)
        # Idle-reap state: lazily-minted lanes (pinned=False) are
        # evicted by WFQQueue.reap_idle once quiet for the TTL, so a
        # tenant-churn workload (a new tenant id per request) can't
        # grow the scheduler without bound. configure() pins.
        self.last_active = now
        self.pinned = False

    @staticmethod
    def _cap(cfg: TenantConfig) -> float:
        if cfg.tokens_per_s <= 0:
            return float("inf")
        if cfg.burst_tokens > 0:
            return cfg.burst_tokens
        return 4.0 * cfg.tokens_per_s

    def refill(self, now: float) -> None:
        if self.cfg.tokens_per_s <= 0:
            self.bucket = float("inf")
            self.last_refill = now
            return
        dt = max(0.0, now - self.last_refill)
        self.bucket = min(self._cap(self.cfg),
                          self.bucket + dt * self.cfg.tokens_per_s)
        self.last_refill = now

    def head(self) -> Optional[_Ticket]:
        q = self.queue
        while q and q[0].cancelled:
            q.popleft()
        return q[0] if q else None


class WFQQueue:
    """Admission ordering for one deployment's tenants.

    The caller (AdmissionController) owns the lock and the clock: every
    method takes ``now`` explicitly so unit tests drive virtual time.
    """

    def __init__(self, window: int = 64,
                 idle_ttl: Optional[float] = None):
        self._window = window
        self._tenants: Dict[str, _Tenant] = {}
        self._vtime = 0.0
        self._seq = itertools.count()
        self._defaults: Optional[TenantConfig] = None
        self._idle_ttl = idle_ttl  # None = read config lazily
        self._last_now = 0.0  # freshest caller clock (for release())

    # -------------------------------------------------------------- config

    def configure(self, tenant: str, cfg: TenantConfig,
                  now: float) -> None:
        t = self._tenants.get(tenant)
        if t is None:
            t = self._tenants[tenant] = _Tenant(cfg, now, self._window)
            t.pinned = True  # operator-installed: never idle-reaped
            return
        if not t.pinned:
            # A lazily-minted lane graduates to operator-owned: it
            # leaves the reap-eligible ledger (qos_tenant counts only
            # lanes that MUST eventually be reaped or released).
            t.pinned = True
            _resdbg.note_release("qos_tenant", (id(self), tenant))
        t.cfg = cfg
        t.bucket = min(t.bucket, _Tenant._cap(cfg))
        t.refill(now)

    def _default_cfg(self) -> TenantConfig:
        if self._defaults is None:
            from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg

            self._defaults = TenantConfig(
                tokens_per_s=cfg.serve_qos_tokens_per_s,
                burst_tokens=cfg.serve_qos_burst_tokens)
        return self._defaults

    def tenant(self, name: str, now: float) -> _Tenant:
        t = self._tenants.get(name)
        if t is None:
            t = self._tenants[name] = _Tenant(self._default_cfg(), now,
                                              self._window)
            # RTPU_DEBUG_RES: every lazily-minted lane must be settled
            # by reap_idle (or pinned by configure) — the tenant-churn
            # leak the res witness's balance assertion covers.
            _resdbg.note_acquire("qos_tenant", key=(id(self), name),
                                 owner=self, note="lazy_tenant")
        self._last_now = max(self._last_now, now)
        t.last_active = now
        return t

    # --------------------------------------------------------------- queue

    def submit(self, tenant: str, cost: float, now: float) -> _Ticket:
        t = self.tenant(tenant, now)
        start = max(self._vtime, t.vfinish)
        vtag = start + cost / max(1e-9, t.cfg.weight)
        t.vfinish = vtag
        tk = _Ticket(tenant, cost, vtag, next(self._seq))
        t.queue.append(tk)
        return tk

    def cancel(self, tk: _Ticket) -> None:
        tk.cancelled = True
        t = self._tenants.get(tk.tenant)
        if t is not None:
            t.head()  # compact cancelled heads eagerly

    def queued(self, tenant: str) -> int:
        t = self._tenants.get(tenant)
        return sum(not tk.cancelled for tk in t.queue) if t else 0

    def _eligible(self, t: _Tenant, tk: _Ticket, now: float) -> bool:
        t.refill(now)
        return t.bucket >= min(tk.cost, _Tenant._cap(t.cfg))

    def reap_idle(self, now: float) -> int:
        """Evict lazily-minted tenant lanes quiet for the idle TTL
        (``serve_qos_tenant_idle_s``; 0 disables). Pinned (configure'd)
        lanes and lanes with queued or inflight work are never touched.
        Called from head() — the admission gate's own cadence bounds
        the map without a dedicated reaper thread. Returns the count
        reaped."""
        self._last_now = max(self._last_now, now)
        ttl = self._idle_ttl
        if ttl is None:
            from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg

            ttl = float(cfg.serve_qos_tenant_idle_s)
        if ttl <= 0:
            return 0
        dead = [name for name, t in self._tenants.items()
                if not t.pinned and not t.queue and t.inflight == 0
                and now - t.last_active > ttl]
        for name in dead:
            del self._tenants[name]
            _resdbg.note_release("qos_tenant", (id(self), name))
        return len(dead)

    def head(self, now: float) -> Optional[_Ticket]:
        """The ticket that should admit next: highest priority class,
        then smallest virtual finish tag, among tenants whose bucket
        covers their head request. None when every queued tenant is
        budget-blocked (or nothing is queued)."""
        self.reap_idle(now)
        best: Optional[_Ticket] = None
        best_t: Optional[_Tenant] = None
        for t in self._tenants.values():
            tk = t.head()
            if tk is None or not self._eligible(t, tk, now):
                continue
            if best is None or (t.cfg.priority, -tk.vtag, -tk.seq) > (
                    best_t.cfg.priority, -best.vtag, -best.seq):
                best, best_t = tk, t
        return best

    def admit(self, tk: _Ticket, now: float) -> None:
        """Charge the admitted ticket: debit its tenant's bucket (an
        unlimited bucket stays infinite) and advance global virtual
        time to its tag so later arrivals can't backdate themselves."""
        t = self.tenant(tk.tenant, now)
        if tk in t.queue:
            t.queue.remove(tk)
        t.refill(now)
        if t.bucket != float("inf"):
            t.bucket = max(0.0, t.bucket - tk.cost)
        self._vtime = max(self._vtime, tk.vtag)
        t.inflight += 1
        t.admitted += 1

    def next_refill_wait(self, now: float) -> Optional[float]:
        """Seconds until the earliest budget-blocked head becomes
        eligible (the gate's bounded condvar wait) — None when no head
        is budget-blocked."""
        wait: Optional[float] = None
        for t in self._tenants.values():
            tk = t.head()
            if tk is None or t.cfg.tokens_per_s <= 0:
                continue
            t.refill(now)
            need = min(tk.cost, _Tenant._cap(t.cfg)) - t.bucket
            if need <= 0:
                return 0.0
            w = need / t.cfg.tokens_per_s
            if wait is None or w < wait:
                wait = w
        return wait

    def release(self, tenant: str) -> None:
        t = self._tenants.get(tenant)
        if t is not None and t.inflight > 0:
            t.inflight -= 1
            # release() takes no clock (callers settle on completion
            # paths without one); the freshest clock any caller passed
            # keeps the idle TTL counted from request COMPLETION, not
            # admission — a long decode must not look like idleness.
            t.last_active = max(t.last_active, self._last_now)

    def record_ttft(self, tenant: str, ttft_ms: float, now: float) -> None:
        self.tenant(tenant, now).ttfts.append(ttft_ms)

    def note_shed(self, tenant: str, now: float) -> None:
        self.tenant(tenant, now).shed += 1

    def close(self) -> None:
        """Settle the witness ledger when the owning deployment state
        is dropped (AdmissionController.forget): every still-live
        lazily-minted lane is released deliberately — teardown is a
        drain, not a leak."""
        for name, t in self._tenants.items():
            if not t.pinned:
                _resdbg.note_release("qos_tenant", (id(self), name))
        self._tenants.clear()

    def idle(self) -> bool:
        return all(not t.queue and not t.inflight
                   for t in self._tenants.values())

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        out: Dict[str, Dict[str, Any]] = {}
        for name, t in self._tenants.items():
            vals = sorted(t.ttfts)
            out[name] = {
                "weight": t.cfg.weight,
                "priority": t.cfg.priority,
                "tokens_per_s": t.cfg.tokens_per_s,
                "bucket": (-1.0 if t.bucket == float("inf")
                           else round(t.bucket, 1)),
                "queued": self.queued(name),
                "inflight": t.inflight,
                "admitted": t.admitted,
                "shed": t.shed,
                "p50_ttft_ms": (round(vals[len(vals) // 2], 3)
                                if vals else 0.0),
                "p99_ttft_ms": (round(vals[min(len(vals) - 1,
                                               int(len(vals) * 0.99))], 3)
                                if vals else 0.0),
            }
        return out
