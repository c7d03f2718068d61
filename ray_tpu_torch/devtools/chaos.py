"""Deterministic, scriptable RPC fault injection.

Parity target: the reference's scripted RPC chaos (reference:
src/ray/rpc/rpc_chaos.h — RAY_testing_rpc_failure's
``method=N:req_prob:resp_prob`` grammar plus the Node/Worker killer
actors in _private/test_utils.py), redesigned as one seeded plan every
process of a cluster parses identically from ``RTPU_CHAOS_PLAN``.

The blind ``rpc_chaos_failure_prob`` coin flip exercises retry paths but
can never *reproduce* a failure: the interesting bugs live at specific
(method, process, nth-call) points — the head dying while the 2nd actor
registration is on the wire, the holder node dying while serving chunk 2
of a pull. A ``FaultPlan`` pins faults to exactly those points.

Plan grammar (``RTPU_CHAOS_PLAN`` env var / ``chaos_plan`` config flag;
worker/head/node processes inherit the env export)::

    plan   := rule [';' rule]...
    rule   := action [':' key '=' value]...
    action := drop_request | drop_response | delay | sever | kill

    keys (all optional):
      method=<glob>   rpc method name, fnmatch glob        (default *)
      role=<glob>     receiving process's role: head, node,
                      worker, driver, client                (default *)
      peer=<glob>     remote peer "ip:port" of the connection (default *;
                      colons inside a value are fine — a ':'-piece with
                      no '=' is folded into the preceding value)
      nth=<n>         fire on the n-th matching call only (1-based,
                      counted per process per rule)
      after=<n>       fire on every matching call after the first n
      count=<k>       fire at most k times (default: 1 when nth is
                      given, else unlimited)
      prob=<p>        fire with probability p per matching call, from
                      the rule's own seeded RNG (reproducible)
      seed=<s>        per-rule RNG seed for prob (default: plan seed)
      secs=<s>        delay duration (delay action only, default 0.2)
      side=<request|response>  which half the fault hits (delay/sever/
                      kill; drop_request/drop_response imply theirs)

Actions, applied at the RECEIVING server's dispatch point (a dropped
request and a request lost in transit are indistinguishable to the
sender):

    drop_request    the request frame is lost before the handler runs
    drop_response   the handler runs; its reply frame is lost
    delay           sleep ``secs`` before the handler / reply
    sever           shutdown() the peer connection (both directions die
                    mid-call; the client sees ConnectionLost)
    kill            SIGKILL the CURRENT process — scope with ``role=``
                    (e.g. ``kill:role=head:method=register_actor:nth=2``
                    takes the head down exactly as the 2nd registration
                    arrives)

Examples::

    # Head dies receiving the 2nd actor registration; a respawned head
    # (fresh process = fresh counters) survives the retry.
    RTPU_CHAOS_PLAN='kill:role=head:method=register_actor:nth=2'

    # The holder node dies serving chunk 2 of an object pull.
    RTPU_CHAOS_PLAN='kill:role=node:method=fetch_object:nth=2'

    # Lose the first two kill_actor acks (the zombie-actor scenario).
    RTPU_CHAOS_PLAN='drop_response:role=worker:method=kill_actor:count=2'

    # Seeded 10% request loss on every idempotent control RPC at the
    # head + 300ms delay on every heartbeat.
    RTPU_CHAOS_PLAN='drop_request:role=head:prob=0.1:seed=7;delay:method=heartbeat:secs=0.3'

Counters are per (process, rule): every process parses the plan at
first use and counts its OWN matching calls, so ``nth`` is deterministic
wherever request routing is (and a respawned process re-arms the plan —
scenario plans use ``nth=2``-style rules so the respawned incarnation
survives its retry traffic).

Zero overhead when off: ``chaos_enabled()`` is one config read; nothing
else is imported into the dispatch path.
"""

from __future__ import annotations

import fnmatch
import os
import random
import signal
import threading
import time
from typing import List, Optional

from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg

ACTIONS = ("drop_request", "drop_response", "delay", "sever", "kill")

#: decide() verdicts consumed by the protocol hook.
DROP = "drop"
SEVER = "sever"


class ChaosPlanError(ValueError):
    """Malformed RTPU_CHAOS_PLAN string."""


class FaultRule:
    __slots__ = ("action", "method", "role", "peer", "nth", "after",
                 "count", "prob", "secs", "side", "_rng", "_matched",
                 "_fired", "_lock")

    def __init__(self, action: str, method: str = "*", role: str = "*",
                 peer: str = "*", nth: Optional[int] = None,
                 after: Optional[int] = None, count: Optional[int] = None,
                 prob: Optional[float] = None, seed: Optional[int] = None,
                 secs: float = 0.2, side: Optional[str] = None):
        if action not in ACTIONS:
            raise ChaosPlanError(
                f"unknown chaos action {action!r} (want one of "
                f"{'/'.join(ACTIONS)})")
        if side not in (None, "request", "response"):
            raise ChaosPlanError(f"bad side={side!r}")
        self.action = action
        self.method = method
        self.role = role
        self.peer = peer
        self.nth = nth
        self.after = after
        if count is None and nth is not None:
            count = 1  # an nth rule is a one-shot unless told otherwise
        self.count = count
        self.prob = prob
        self.secs = secs
        if side is None:
            side = ("response" if action == "drop_response" else "request")
        self.side = side
        self._rng = random.Random(seed if seed is not None else 0)
        self._matched = 0  # matching (role, method, side) events seen
        self._fired = 0
        self._lock = threading.Lock()

    def decide(self, role: str, method: str, side: str,
               peer: str = "") -> bool:
        """Does this rule fire for this event? Advances counters."""
        if side != self.side:
            return False
        if not fnmatch.fnmatchcase(method, self.method):
            return False
        if not fnmatch.fnmatchcase(role or "", self.role):
            return False
        if self.peer != "*" and not fnmatch.fnmatchcase(peer or "",
                                                        self.peer):
            return False
        with self._lock:
            if self.count is not None and self._fired >= self.count:
                return False
            self._matched += 1
            if self.nth is not None and self._matched != self.nth:
                return False
            if self.after is not None and self._matched <= self.after:
                return False
            if self.prob is not None and self._rng.random() >= self.prob:
                return False
            self._fired += 1
            return True

    def __repr__(self):
        keys = []
        for k in ("method", "role", "peer"):
            v = getattr(self, k)
            if v != "*":
                keys.append(f"{k}={v}")
        for k in ("nth", "after", "count", "prob"):
            v = getattr(self, k)
            if v is not None:
                keys.append(f"{k}={v}")
        if self.action == "delay":
            keys.append(f"secs={self.secs}")
        return ":".join([self.action] + keys)


class FaultPlan:
    """An ordered list of FaultRules parsed from the plan string."""

    def __init__(self, rules: List[FaultRule], source: str = ""):
        self.rules = rules
        self.source = source

    @classmethod
    def parse(cls, text: str, default_seed: int = 0) -> "FaultPlan":
        rules: List[FaultRule] = []
        for i, raw in enumerate(t for t in text.split(";") if t.strip()):
            parts = raw.strip().split(":")
            action = parts[0].strip()
            # ':' separates rule parts AND appears inside values
            # (peer=127.0.0.1:9000): a split piece with no '=' belongs
            # to the preceding value.
            merged: List[str] = []
            for p in parts[1:]:
                if "=" not in p and merged:
                    merged[-1] += ":" + p
                else:
                    merged.append(p)
            kw: dict = {}
            for p in merged:
                if "=" not in p:
                    raise ChaosPlanError(
                        f"chaos rule {raw!r}: expected key=value, got "
                        f"{p!r}")
                k, v = p.split("=", 1)
                k = k.strip()
                v = v.strip()
                if k in ("nth", "after", "count", "seed"):
                    kw[k] = int(v)
                elif k in ("prob", "secs"):
                    kw[k] = float(v)
                elif k in ("method", "role", "peer", "side"):
                    kw[k] = v
                else:
                    raise ChaosPlanError(
                        f"chaos rule {raw!r}: unknown key {k!r}")
            # Distinct default seed per rule position: two prob rules
            # must not mirror each other's coin flips.
            kw.setdefault("seed", default_seed * 1000 + i)
            rules.append(FaultRule(action, **kw))
        return cls(rules, source=text)

    def actions_for(self, role: str, method: str, side: str,
                    peer: str = "") -> List[FaultRule]:
        return [r for r in self.rules
                if r.decide(role, method, side, peer)]


# ------------------------------------------------------------- process API

_plan_lock = threading.Lock()
_plan_cache: Optional[FaultPlan] = None
_plan_cache_key: Optional[str] = None


def chaos_enabled() -> bool:
    """One config read — the dispatch fast path's only cost when off."""
    return bool(cfg.chaos_plan) or cfg.rpc_chaos_failure_prob > 0


def current_plan() -> Optional[FaultPlan]:
    """The process's parsed plan (re-parsed when the config string
    changes, so tests can cfg.set a new plan mid-process; counters reset
    with it)."""
    global _plan_cache, _plan_cache_key
    text = cfg.chaos_plan
    if not text:
        if _plan_cache_key is not None:
            # Forget the parsed plan when the flag clears: re-arming the
            # SAME plan string later must start with fresh counters, not
            # the previous run's spent rules.
            with _plan_lock:
                _plan_cache = None
                _plan_cache_key = None
        return None
    if text == _plan_cache_key:
        return _plan_cache
    with _plan_lock:
        if text != _plan_cache_key:
            try:
                _plan_cache = FaultPlan.parse(
                    text, default_seed=cfg.chaos_seed)
            except ChaosPlanError as e:
                # current_plan() runs inside every server's dispatch:
                # raising here would crash EVERY RPC in every process of
                # the cluster with a cryptic error. Report loudly once
                # and run with chaos disabled instead — the scenario
                # then fails its fault assertions, which points at the
                # plan, not at a dead cluster.
                print(f"RTPU_CHAOS: invalid plan {text!r} disabled: {e}",
                      flush=True)
                _plan_cache = None
            _plan_cache_key = text
    return _plan_cache


def _kill_self() -> None:  # monkeypatched by unit tests
    os.kill(os.getpid(), signal.SIGKILL)


def apply(role: str, method: str, side: str, conn=None) -> Optional[str]:
    """Run the plan against one RPC event. Returns DROP when the frame
    should be lost, SEVER when the connection was shut down (the caller
    must stop using it), None to proceed. Side effects (sleep, socket
    shutdown, SIGKILL) happen here."""
    plan = current_plan()
    if plan is None:
        return None
    verdict = None
    for rule in plan.actions_for(role, method, side,
                                 peer=_peer_of(conn)):
        if rule.action == "kill":
            print(f"RTPU_CHAOS: kill ({rule!r}) on {method} [{side}]",
                  flush=True)
            # SIGKILL leaves no trace: dump the flight-recorder ring
            # first so the scenario's post-mortem has the seconds
            # before this death (best-effort; never blocks the kill).
            try:
                from ray_tpu_torch.util import flight_recorder as _flight

                path = _flight.dump_to_file(reason=f"chaos-kill:{method}")
                if path:
                    print(f"RTPU_CHAOS: flight dump {path}", flush=True)
            except Exception as e:  # noqa: BLE001 — never block the kill
                print(f"RTPU_CHAOS: flight dump failed: {e!r}",
                      flush=True)
            _kill_self()
            return DROP  # only reachable under the unit-test monkeypatch
        if rule.action == "delay":
            time.sleep(rule.secs)
        elif rule.action == "sever":
            if conn is not None:
                from ray_tpu_torch.cluster.protocol import _shutdown_socket

                _shutdown_socket(conn.sock)
            verdict = SEVER
        elif rule.action in ("drop_request", "drop_response"):
            if verdict is None:
                verdict = DROP
    return verdict


def _peer_of(conn) -> str:
    if conn is None:
        return ""
    try:
        host, port = conn.sock.getpeername()[:2]
        return f"{host}:{port}"
    except OSError:
        return ""


# --------------------------------------------------------------- scenarios
#
# Scripted multi-step failure scenarios that need ORCHESTRATION, not just
# an injected fault: the rule grammar above breaks one RPC at one point;
# a rolling upgrade is a planned sequence (drain -> snapshot -> port
# handover -> re-converge) whose acceptance criterion is measured on the
# CLIENT side. Drivers live here so tests and smokes run the identical
# scenario.


def run_rolling_upgrade(runtime, request_fn, clients: int = 2,
                        pre_s: float = 0.5, settle_s: float = 1.0) -> dict:
    """Rolling head-upgrade scenario: continuous client load across a
    drain -> sqlite-checkpoint -> old head releases the port -> new
    incarnation binds and serves handover
    (ClusterRuntime.rolling_head_upgrade).

    ``request_fn(i)`` is one client request returning a result or
    raising; it runs in ``clients`` threads before, during, and after
    the swap. Acceptance is ZERO raised requests — elevated latency is
    expected (requests issued in the gap ride their retry loops), a
    failure is not. Returns the upgrade report plus
    requests_ok / request_failures / max_request_s."""
    stop = threading.Event()
    lock = threading.Lock()
    stats = {"ok": 0, "failures": [], "max_s": 0.0}

    def client_loop(ci: int) -> None:
        i = 0
        while not stop.is_set():
            t0 = time.monotonic()
            try:
                request_fn(ci * 1_000_000 + i)
                with lock:
                    stats["ok"] += 1
                    stats["max_s"] = max(stats["max_s"],
                                         time.monotonic() - t0)
            except Exception as e:  # noqa: BLE001 — the scenario verdict
                with lock:
                    stats["failures"].append(repr(e)[:200])
            i += 1

    threads = [threading.Thread(target=client_loop, args=(ci,),
                                daemon=True, name=f"upgrade-load-{ci}")
               for ci in range(clients)]
    for t in threads:
        t.start()
    try:
        time.sleep(pre_s)  # load established before the swap begins
        report = dict(runtime.rolling_head_upgrade())
        time.sleep(settle_s)  # catch straggler failures after the swap
    finally:
        # A failed swap must still stop the load threads: left running
        # they hammer the (possibly torn-down) runtime forever and grow
        # stats['failures'] without bound.
        stop.set()
        for t in threads:
            t.join(timeout=60)
    with lock:
        report["requests_ok"] = stats["ok"]
        report["request_failures"] = list(stats["failures"])
        report["max_request_s"] = round(stats["max_s"], 3)
    return report
