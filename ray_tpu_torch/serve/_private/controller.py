"""Serve controller: the reconciling control plane for deployments
(``ray_tpu/serve/_private/controller.py``).

Parity target: reference python/ray/serve/_private/controller.py
(ServeController :84) + deployment_state.py (DeploymentState.update :2662)
+ autoscaling_state.py (:262): a single named actor owns the target state
(deployment -> config), continuously reconciles running replicas toward
it, polls the replicas' load snapshots, answers routing queries, resizes
a deployment with an ``autoscaling_config`` through its autoscaling policy
(autoscaling_policy.py), and keeps one HTTP proxy a node once
``start_http_proxies`` asked for them. ``shutdown`` returns once its
reconcile thread and the replicas it stops are gone.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

CONTROLLER_NAME = "rtpu-serve-controller"


class ServeController:
    def __init__(self):
        import ray_tpu_torch

        self._ray = ray_tpu_torch
        from ray_tpu_torch.devtools.lock_debug import make_lock, make_rlock

        self._lock = make_rlock("serve.controller._lock")
        # Serializes whole reconcile passes: deploy() and the background
        # loop reconciling the same deployment concurrently would both
        # observe the deficit and double-create replicas.
        self._reconcile_mutex = make_lock("serve.controller._reconcile_mutex")
        # name -> {config..., replicas: [ActorHandle], version}
        self._deployments: Dict[str, Dict[str, Any]] = {}
        # Replica-SET versions + condvar: routers long-poll
        # listen_for_change instead of polling get_replicas on a timer
        # (reference: long_poll.py:204 LongPollHost).
        self._set_versions: Dict[str, int] = {}
        self._set_cond = threading.Condition(self._lock)
        # Replica LOAD snapshots, polled once per reconcile tick and
        # piggybacked on the same long-poll (listen_for_update): the
        # load generation bumps each poll sweep, so every parked router
        # wakes with fresh queue/KV/prefix-hash metrics ~one reconcile
        # period after they were measured — one RPC round of freshness,
        # no extra poll loop anywhere.
        self._load_gens: Dict[str, int] = {}
        # One monotonic clock feeds BOTH version dicts: values are
        # unique across names and time, so delete() can POP a
        # deployment's entries (no per-name leak) without a later
        # redeploy ever re-minting a version a parked router already
        # saw (the != comparator would miss that change forever).
        self._version_clock = 0
        self._shutdown = False
        # node_id -> (proxy actor, address); reconciled to one per node
        # when HTTP is enabled (reference: proxy_state.py ProxyStateManager).
        self._proxies: Dict[str, Any] = {}
        self._http_cfg: Any = None
        # Serializes _ensure_proxies (user RPC vs reconcile loop): two
        # concurrent passes would each spawn a proxy for the same node and
        # the overwritten handle would leak its actor forever.
        self._proxy_mutex = make_lock("serve.controller._proxy_mutex")
        self._wake = threading.Event()  # cuts the reconcile sleep short
        self._loop_thread = threading.Thread(
            target=self._reconcile_loop, daemon=True, name="serve-reconcile")
        self._loop_thread.start()

    def _bump_set(self, name: str) -> None:
        """Callers hold self._lock. Wakes every long-poller."""
        self._version_clock += 1
        self._set_versions[name] = self._version_clock
        # Journal entries index into the replica LIST; a set change
        # renumbers it, so the delta history is void (routers detect
        # the version move and take a full payload anyway).
        d = self._deployments.get(name)
        if d is not None:
            j = d.get("journal")
            if j is not None:
                j.clear()
        self._set_cond.notify_all()

    # ------------------------------------------------------------- deploy

    def deploy(self, name: str, cls, init_args: tuple,
               init_kwargs: Dict[str, Any], config: Dict[str, Any]) -> bool:
        """Create/update a deployment. Blocks until the initial replica set
        is running (reference serve.run semantics)."""
        with self._lock:
            d = self._deployments.get(name)
            if d is None:
                d = self._deployments[name] = {
                    "cls": cls, "init_args": init_args,
                    "init_kwargs": init_kwargs, "config": dict(config),
                    "replicas": [], "version": 0, "last_scale": 0.0,
                    "loads": {}, "policy": None,
                }
            else:
                d.update(cls=cls, init_args=init_args,
                         init_kwargs=init_kwargs, config=dict(config))
                d["version"] += 1
                # Code/config changed: replace the replica set (and
                # drop load state keyed to the old one).
                self._stop_replicas(d["replicas"])
                d["replicas"] = []
                d["loads"] = {}
                d["policy"] = None
                self._bump_set(name)
        self._reconcile_once(name)
        return True

    def delete(self, name: str) -> bool:
        with self._lock:
            d = self._deployments.pop(name, None)
            if d is not None:
                # Pop the version entries too — they were the per-name
                # leak (one int pair per deployment name ever created).
                # Parked long-pollers wake via notify_all, read the
                # default version 0 (!= anything the unique clock ever
                # minted), observe replicas=None, and re-park at 0; a
                # redeploy mints a fresh clock value and wakes them.
                self._set_versions.pop(name, None)
                self._load_gens.pop(name, None)
                self._set_cond.notify_all()
        if d:
            self._stop_replicas(d["replicas"])
        return d is not None

    def shutdown(self) -> bool:
        """Stop every deployment. Returns once the reconcile thread has
        exited and every replica is drained and killed (or its drain timed
        out), so nothing of serve keeps running after it."""
        with self._lock:
            self._shutdown = True
            self._http_cfg = None  # reconcile must not respawn proxies
            deps = list(self._deployments.values())
            names = list(self._deployments)
            self._deployments.clear()
            for n in names:
                self._bump_set(n)
            proxies = list(self._proxies.values())
            self._proxies.clear()
        self._wake.set()
        drains = [t for d in deps for t in self._stop_replicas(d["replicas"])]
        for actor, _addr in proxies:
            try:
                self._ray.get(actor.stop.remote(), timeout=5)
                self._ray.kill(actor)
            except Exception:
                pass
        self._loop_thread.join(timeout=30.0)
        for t in drains:
            t.join(timeout=30.0)
        return True

    def _stop_replicas(self, replicas: List[Any],
                       drain_timeout_s: float = 10.0) -> List[threading.Thread]:
        """Drain then kill (reference: graceful replica shutdown) — an
        immediate kill would fail every in-flight request on the victim.
        Draining runs on background threads so control calls never block
        on slow requests; returns them."""

        def drain_and_kill(r):
            # monotonic, not wall clock: an NTP step during the drain
            # window would stretch or collapse the deadline.
            deadline = time.monotonic() + drain_timeout_s
            while time.monotonic() < deadline:
                try:
                    if self._ray.get(r.queue_len.remote(), timeout=5) == 0:
                        break
                except Exception:
                    break
                time.sleep(0.25)
            try:
                self._ray.kill(r)
            except Exception:
                pass

        threads = [threading.Thread(target=drain_and_kill, args=(r,),
                                    daemon=True, name="serve-drain")
                   for r in replicas]
        for t in threads:
            t.start()
        return threads

    # ---------------------------------------------------------- reconcile

    def _desired_replicas(self, d: Dict[str, Any]) -> int:
        from ray_tpu_torch.serve._private.autoscaling_policy import \
            ServeAutoscalePolicy

        from ray_tpu_torch.core.config import GLOBAL_CONFIG as gcfg

        with self._lock:
            cfg = dict(d["config"])
            replicas = list(d["replicas"])
            loads_map = dict(d["loads"])
            loads_age = time.monotonic() - d.get("loads_mono",
                                                 float("-inf"))
            policy = d["policy"]
        if loads_age > gcfg.serve_snapshot_ttl_s:
            # Sweep has not landed recently (every replica poll failing,
            # e.g. wedged engines): spike-era snapshots frozen in the
            # cache must not keep driving scale decisions — same TTL the
            # router applies. The queue_len fallback below still runs.
            loads_map = {}
        n = cfg.get("num_replicas", 1)
        auto = cfg.get("autoscaling_config")
        if not auto:
            return n
        if not replicas:
            return max(1, auto.get("min_replicas", 1))
        if policy is None:
            # Per-deployment policy state (sustain windows, cooldown);
            # reset on redeploy by deploy() so config changes take.
            policy = ServeAutoscalePolicy(auto)
            with self._lock:
                d["policy"] = policy
        # The snapshot sweep (this same reconcile tick) already holds
        # every replica's load — queue depth, engine waiting, decode
        # utilization. No extra RPC here; replicas the sweep missed
        # contribute None and the policy treats the tick accordingly.
        loads = [loads_map.get(r) for r in replicas]
        if not any(s is not None for s in loads):
            # Snapshot sweep hasn't covered this set yet (first tick
            # after deploy): fall back to a direct queue-length poll so
            # a cold controller still reacts (legacy behavior).
            try:
                lens = self._ray.get(
                    [r.queue_len.remote() for r in replicas], timeout=5)
                loads = [{"queue_depth": q} for q in lens]
            except Exception as e:
                logger.debug("queue_len fallback poll failed: %r", e)
                return len(replicas)
        return policy.desired(len(replicas), loads, time.monotonic())

    def _reconcile_once(self, name: str) -> None:
        with self._reconcile_mutex:
            self._reconcile_once_locked(name)

    def _reconcile_once_locked(self, name: str) -> None:
        from ray_tpu_torch.serve._private.replica import ReplicaActor

        with self._lock:
            d = self._deployments.get(name)
            if d is None:
                return
            version = d["version"]
        # The desired-count computation may RPC the replicas (queue
        # lengths): it must run OUTSIDE the routing lock or every
        # get_replicas/status call stalls behind it each reconcile tick.
        desired = self._desired_replicas(d)
        with self._lock:
            if self._deployments.get(name) is not d \
                    or d["version"] != version:
                return  # redeployed underneath us; next tick handles it
            current = len(d["replicas"])
            cfg = d["config"]
            to_add = desired - current
            # Hysteresis: autoscaling changes at most once per 5s.
            if cfg.get("autoscaling_config") and to_add != 0:
                if time.monotonic() - d["last_scale"] < 5.0:
                    return
                d["last_scale"] = time.monotonic()
            cls, args, kwargs = d["cls"], d["init_args"], d["init_kwargs"]
            res = dict(cfg.get("ray_actor_options", {}))
        if to_add > 0:
            actor_cls = self._ray.remote(ReplicaActor)
            opts = {"num_cpus": res.get("num_cpus", 1)}
            if res.get("resources"):
                opts["resources"] = res["resources"]
            # Headroom beyond user requests: health_check/queue_len control
            # RPCs must never starve behind a saturated request pool (a
            # busy replica would read as dead exactly under load).
            opts["max_concurrency"] = (res.get("max_concurrency")
                                       or cfg.get("max_ongoing_requests", 8)
                                       ) + 4
            new = [actor_cls.options(**opts).remote(cls, args, kwargs)
                   for _ in range(to_add)]
            # Readiness barrier.
            self._ray.get([r.health_check.remote() for r in new],
                          timeout=120)
            with self._lock:
                d2 = self._deployments.get(name)
                if d2 is d:
                    d["replicas"].extend(new)
                    self._bump_set(name)
                else:
                    self._stop_replicas(new)
        elif to_add < 0:
            with self._lock:
                victims = d["replicas"][to_add:]
                del d["replicas"][to_add:]
                self._bump_set(name)
            self._stop_replicas(victims)

    def _reconcile_loop(self) -> None:
        from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg

        while not self._wake.wait(cfg.serve_reconcile_period_s):
            try:
                self._poll_loads()
            except Exception as e:
                logger.debug("load-snapshot sweep failed: %r", e)
            for name in list(self._deployments):
                try:
                    self._reconcile_once(name)
                except Exception:
                    pass
            self._check_replica_health()
            try:
                self._ensure_proxies()
            except Exception:
                pass

    def _poll_loads(self) -> None:
        """One load-snapshot sweep: poll every replica of every
        deployment, cache the results, bump the load generation so
        parked listen_for_update long-polls wake with them. Replicas
        that fail to answer keep no entry — the router falls back to
        pow-2 for them."""
        with self._lock:
            items = [(n, list(d["replicas"]))
                     for n, d in self._deployments.items()]
        changed = []
        for name, replicas in items:
            if not replicas:
                continue
            loads: Dict[Any, Any] = {}
            try:
                snaps = self._ray.get(
                    [r.load_snapshot.remote() for r in replicas],
                    timeout=5)
                loads = dict(zip(replicas, snaps))
            except Exception:
                # Batch gather fails whole on one dead replica: fall
                # back to per-replica harvesting so the rest still
                # report. Submit every RPC up front and drain against
                # ONE shared deadline — a serial 2s-per-replica loop
                # would let a single wedged replica stall the whole
                # reconcile thread ~2s x N and stale out every other
                # deployment's snapshots.
                refs = [(r, r.load_snapshot.remote()) for r in replicas]
                deadline = time.monotonic() + 5.0
                for r, ref in refs:
                    try:
                        loads[r] = self._ray.get(
                            ref, timeout=max(0.1, deadline
                                             - time.monotonic()))
                    except Exception as e:
                        logger.debug("load_snapshot poll failed for a "
                                     "replica of %s: %r", name, e)
            if loads:
                changed.append((name, loads))
        if not changed:
            return
        from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg

        with self._lock:
            for name, loads in changed:
                d = self._deployments.get(name)
                if d is None:
                    continue
                # Keep only entries for replicas still in the set.
                current = set(d["replicas"])
                old_loads = d.get("loads") or {}
                new_loads = {r: s for r, s in loads.items()
                             if r in current}
                d["loads"] = new_loads
                d["loads_mono"] = time.monotonic()
                self._version_clock += 1
                gen = self._load_gens[name] = self._version_clock
                # Delta journal: which replica INDICES actually changed
                # this sweep. Routers long-polling via
                # listen_for_update_delta get only those snapshots —
                # O(touched) fan-out instead of O(replicas) — as long
                # as their known generation is still inside the bounded
                # history.
                touched = frozenset(
                    i for i, r in enumerate(d["replicas"])
                    if new_loads.get(r) != old_loads.get(r))
                j = d.get("journal")
                if j is None or j.maxlen != cfg.serve_snapshot_journal:
                    j = d["journal"] = collections.deque(
                        j or (), maxlen=max(1, cfg.serve_snapshot_journal))
                j.append((gen, touched))
            self._set_cond.notify_all()

    def _check_replica_health(self) -> None:
        """Dead replicas are pruned; reconcile replaces them next tick."""
        with self._lock:
            items = [(n, list(d["replicas"]))
                     for n, d in self._deployments.items()]
        for name, replicas in items:
            dead = []
            for r in replicas:
                try:
                    self._ray.get(r.health_check.remote(), timeout=10)
                except Exception:
                    dead.append(r)
            if dead:
                with self._lock:
                    d = self._deployments.get(name)
                    if d:
                        d["replicas"] = [r for r in d["replicas"]
                                         if r not in dead]
                        self._bump_set(name)
                # Kill pruned replicas: a half-dead process left running
                # would leak its lease/worker forever.
                for r in dead:
                    try:
                        self._ray.kill(r)
                    except Exception:
                        pass

    # ------------------------------------------------------------ routing

    def get_replicas(self, name: str) -> List[Any]:
        with self._lock:
            d = self._deployments.get(name)
            if d is None:
                raise KeyError(f"no deployment named {name!r}")
            return list(d["replicas"])

    def get_replica_set(self, name: str):
        """(set_version, replicas) — the long-poll seed."""
        with self._lock:
            d = self._deployments.get(name)
            if d is None:
                raise KeyError(f"no deployment named {name!r}")
            return self._set_versions.get(name, 0), list(d["replicas"])

    def _loads_for(self, d: Dict[str, Any],
                   replicas: List[Any]) -> List[Any]:
        """Callers hold self._lock. Snapshot list aligned with
        ``replicas`` (None where the sweep has nothing fresh). Each
        snapshot ships ``age_s`` — seconds since this controller's
        sweep landed it, measured on ONE clock — so the router restamps
        freshness onto its own clock instead of trusting the replica
        host's wall time."""
        loads = d["loads"]
        if not loads:
            return [None for _ in replicas]
        age = round(max(0.0, time.monotonic()
                        - d.get("loads_mono", float("-inf"))), 3)
        out: List[Any] = []
        for r in replicas:
            s = loads.get(r)
            if s is not None:
                s = dict(s)
                s["age_s"] = age
            out.append(s)
        return out

    def get_replica_set_with_loads(self, name: str):
        """(set_version, replicas, load_gen, loads) — the scored
        router's seed; ``loads`` aligns with ``replicas``."""
        with self._lock:
            d = self._deployments.get(name)
            if d is None:
                raise KeyError(f"no deployment named {name!r}")
            replicas = list(d["replicas"])
            return (self._set_versions.get(name, 0), replicas,
                    self._load_gens.get(name, 0),
                    self._loads_for(d, replicas))

    def listen_for_change(self, name: str, known_version: int,
                          timeout: float = 30.0):
        """Long-poll: blocks until the replica set's version moves past
        ``known_version`` (or timeout), then returns (version, replicas) —
        replicas is None when the deployment was deleted (reference:
        LongPollHost.listen_for_change, long_poll.py:269). Routers get
        set changes PUSHED within one RPC round instead of discovering
        them on a poll timer."""
        deadline = time.monotonic() + timeout
        with self._set_cond:
            while True:
                d = self._deployments.get(name)
                v = self._set_versions.get(name, 0)
                if v != known_version:
                    return v, (None if d is None else list(d["replicas"]))
                # Version unchanged: PARK — including for a deleted
                # deployment (the caller already saw the deletion at this
                # version; returning early would turn its poll loop into a
                # 1-RPC/s spin until redeploy).
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return v, (None if d is None else list(d["replicas"]))
                self._set_cond.wait(remaining)

    def listen_for_update(self, name: str, known_set_version: int,
                          known_load_gen: int, timeout: float = 30.0):
        """Long-poll for EITHER a replica-set change or a fresh
        load-snapshot sweep: returns (set_version, replicas, load_gen,
        loads) the moment either counter moves past the caller's
        (replicas/loads are None when the deployment was deleted).
        The snapshot sweep runs once per reconcile period, so a parked
        router observes replica load at reconcile-period freshness for
        the cost of one RPC round per period — the metrics PUSH path,
        piggybacked on the set-change channel it already held open."""
        deadline = time.monotonic() + timeout
        with self._set_cond:
            while True:
                d = self._deployments.get(name)
                v = self._set_versions.get(name, 0)
                g = self._load_gens.get(name, 0)
                if v != known_set_version or g != known_load_gen:
                    if d is None:
                        return v, None, g, None
                    replicas = list(d["replicas"])
                    return v, replicas, g, self._loads_for(d, replicas)
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    if d is None:
                        return v, None, g, None
                    replicas = list(d["replicas"])
                    return v, replicas, g, self._loads_for(d, replicas)
                self._set_cond.wait(remaining)

    def _delta_since(self, d: Dict[str, Any],
                     known_load_gen: int) -> Optional[Dict[int, Any]]:
        """Callers hold self._lock. The touched-replica snapshot map
        {index: snapshot} accumulated since ``known_load_gen``, or None
        when the bounded journal no longer covers that generation (the
        caller ships a full payload instead). Coverage requires the
        caller's generation to still BE in the journal — the full/seed
        paths hand out the latest journaled generation, so a router
        that kept up always finds it; one that fell
        serve_snapshot_journal sweeps behind resyncs with one full
        payload. A replica that missed this sweep ships None (the
        router drops its entry and falls back to pow-2, exactly the
        full-payload semantics)."""
        j = d.get("journal")
        if not j:
            return None
        if known_load_gen != j[0][0] \
                and not any(g == known_load_gen for g, _ in j):
            return None
        touched: set = set()
        for g, idxs in j:
            if g > known_load_gen:
                touched.update(idxs)
        loads = d.get("loads") or {}
        replicas = d["replicas"]
        out: Dict[int, Any] = {}
        for i in touched:
            if i >= len(replicas):
                return None  # set raced the journal: full payload
            out[i] = loads.get(replicas[i])
        return out

    def listen_for_update_delta(self, name: str, known_set_version: int,
                                known_load_gen: int,
                                timeout: float = 30.0):
        """listen_for_update's O(touched) twin: same park/wake
        contract, but when ONLY the load generation moved and the
        bounded journal still covers the caller's generation, the
        payload is ``("delta", {replica_index: snapshot}, age_s)`` with
        replicas=None — the router merges the touched entries in place
        instead of re-ingesting the whole set. Set-version changes,
        journal gaps, and deletions degrade to the full shapes:
        ``("full", loads)`` with the replica list, or (v, None, g,
        None) for a deleted deployment."""
        deadline = time.monotonic() + timeout
        with self._set_cond:
            while True:
                d = self._deployments.get(name)
                v = self._set_versions.get(name, 0)
                g = self._load_gens.get(name, 0)
                expired = deadline - time.monotonic() <= 0
                if v != known_set_version or g != known_load_gen \
                        or expired:
                    if d is None:
                        return v, None, g, None
                    if v == known_set_version:
                        delta = self._delta_since(d, known_load_gen)
                        if delta is not None:
                            age = round(max(0.0, time.monotonic()
                                            - d.get("loads_mono",
                                                    float("-inf"))), 3)
                            if age == float("inf"):  # no sweep yet
                                age = 0.0
                            return v, None, g, ("delta", delta, age)
                    replicas = list(d["replicas"])
                    return (v, replicas, g,
                            ("full", self._loads_for(d, replicas)))
                self._set_cond.wait(deadline - time.monotonic())

    # -------------------------------------------------------- HTTP proxies

    def start_http_proxies(self, host: str = "127.0.0.1") -> Dict[str, str]:
        """One proxy actor per alive node (reference: ProxyStateManager,
        proxy_state.py) — reconciled continuously: new nodes get a proxy,
        dead proxies are respawned. Returns {node_id: address}."""
        with self._lock:
            self._http_cfg = host
        self._ensure_proxies()
        with self._lock:
            return {nid: addr for nid, (_a, addr) in self._proxies.items()}

    def list_proxies(self) -> Dict[str, str]:
        with self._lock:
            return {nid: addr for nid, (_a, addr) in self._proxies.items()}

    def _ensure_proxies(self) -> None:
        with self._proxy_mutex:
            self._ensure_proxies_locked()

    def _ensure_proxies_locked(self) -> None:
        with self._lock:
            host = self._http_cfg
        if host is None or self._shutdown:
            return
        from ray_tpu_torch.core.task_spec import NodeAffinitySchedulingStrategy
        from ray_tpu_torch.serve._private.proxy import HTTPProxyActor
        try:
            nodes = [n for n in self._ray.nodes()
                     if n.get("alive", True)]
        except Exception:
            return
        alive_ids = {n["node_id"] for n in nodes}
        with self._lock:
            have = dict(self._proxies)
        # Reap proxies on dead nodes / dead proxy actors.
        for nid, (actor, _addr) in have.items():
            dead = nid not in alive_ids
            if not dead:
                try:
                    self._ray.get(actor.healthy.remote(), timeout=5)
                except Exception:
                    dead = True
            if dead:
                with self._lock:
                    self._proxies.pop(nid, None)
                try:
                    self._ray.kill(actor)
                except Exception:
                    pass
        for nid in alive_ids:
            with self._lock:
                if nid in self._proxies:
                    continue
            try:
                actor = self._ray.remote(HTTPProxyActor).options(
                    num_cpus=0, max_concurrency=8,
                    scheduling_strategy=NodeAffinitySchedulingStrategy(
                        node_id=nid, soft=True)).remote(host, 0)
                addr = self._ray.get(actor.address.remote(), timeout=60)
            except Exception:
                continue
            with self._lock:
                if self._shutdown or self._http_cfg is None:
                    keep = False
                else:
                    keep = True
                    self._proxies[nid] = (actor, addr)
            if not keep:
                try:
                    self._ray.kill(actor)
                except Exception:
                    pass
                return

    def list_deployments(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {
                n: {"num_replicas": len(d["replicas"]),
                    "version": d["version"], "config": dict(d["config"])}
                for n, d in self._deployments.items()
            }

    def status(self, name: str) -> Dict[str, Any]:
        with self._lock:
            d = self._deployments.get(name)
            if d is None:
                raise KeyError(name)
            replicas = list(d["replicas"])
        metrics = []
        for r in replicas:
            try:
                metrics.append(self._ray.get(r.metrics.remote(), timeout=5))
            except Exception:
                metrics.append(None)
        return {"replicas": len(replicas), "metrics": metrics}
