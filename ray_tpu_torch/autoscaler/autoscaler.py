"""Demand-driven autoscaler (``ray_tpu/autoscaler/autoscaler.py``, with
the port's ``util/metrics.py``).

Parity target: the reference autoscaler v2
(reference: python/ray/autoscaler/v2/autoscaler.py:42 Autoscaler.update,
v2/scheduler.py bin-packing over demand, _private/autoscaler.py:171 v1
loop): poll the head for UNMET resource demand + node views, bin-pack the
demand onto the smallest-fitting node types (clamped by max_nodes), and
reap nodes that sat fully idle past idle_timeout. Scale-down drains via
the head so the scheduler stops routing to the node before termination.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import threading
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.autoscaler.node_provider import NodeProvider
from ray_tpu_torch.util import metrics as _m

logger = logging.getLogger(__name__)

STEP_FAILURES = _m.Counter(
    "rtpu_autoscaler_step_failures_total",
    "autoscaler reconcile passes that raised (loop backs off and retries)")


@dataclasses.dataclass
class AutoscalerConfig:
    max_nodes: int = 8
    min_nodes: int = 0
    idle_timeout_s: float = 30.0
    poll_interval_s: float = 2.0
    demand_window_s: float = 20.0
    # Scale-up batches are capped per step (reference upscaling_speed).
    max_launch_per_step: int = 4


class Autoscaler:
    """Drives one provider against one cluster head."""

    def __init__(self, cluster_runtime, provider: NodeProvider,
                 config: Optional[AutoscalerConfig] = None):
        self._rt = cluster_runtime
        self._provider = provider
        self.config = config or AutoscalerConfig()
        self._idle_since: Dict[str, float] = {}
        # Drained from the head but the provider terminate failed: the
        # node is gone from the cluster state, so the main reap loop can
        # never see it again — retried explicitly each pass until the
        # provider call succeeds (else the VM leaks and bills forever).
        self._pending_terminate: set = set()
        self._launched = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # provider ids we created, mapped to cluster node ids once known
        self._managed: Dict[str, Optional[str]] = {}

    # ---------------------------------------------------------------- API

    def start(self) -> "Autoscaler":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="autoscaler")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        # Join the loop (bounded): the Event wakes the wait immediately,
        # so only an in-flight step() holds the thread — letting a live
        # reconcile pass race interpreter teardown is how half-drained
        # nodes leak.
        t = self._thread
        if t is not None and t.is_alive() \
                and t is not threading.current_thread():
            t.join(timeout=10.0)

    def step(self) -> Dict[str, Any]:
        """One reconcile pass; returns what it did (tested directly)."""
        state = self._rt.head.retrying_call(
            "get_demand", self.config.demand_window_s, timeout=10)
        # Snapshot the provider's node map ONCE per step: cloud providers
        # back cluster_node_ids by a cloud list call, and per-pid lookups
        # would be O(machines) API calls per pass.
        mapper = getattr(self._provider, "cluster_node_map", None)
        self._node_map = mapper() if mapper is not None else None
        launched = self._scale_up(state)
        reaped = self._scale_down(state)
        return {"launched": launched, "reaped": reaped}

    # ------------------------------------------------------------- scaling

    def _fits(self, demand: Dict[str, float],
              resources: Dict[str, float]) -> bool:
        return all(resources.get(k, 0.0) >= v
                   for k, v in demand.items()
                   if k != "_labels" and v > 0)

    @staticmethod
    def _labels_match(demand: Dict[str, Any],
                      labels: Dict[str, str]) -> bool:
        """A label-constrained demand (see head node_label picks) only
        counts against capacity that CARRIES those labels — scaling up
        unlabeled nodes for it would loop forever."""
        need = demand.get("_labels") or {}
        return all(labels.get(k) == v for k, v in dict(need).items())

    def _scale_up(self, state) -> List[str]:
        demands = state["unmet"]
        if not demands:
            return []
        # Provider nodes self-register with the head, so each appears both
        # in non_terminated_nodes() and in state["nodes"] once up. Count
        # alive cluster nodes plus provider nodes none of whose hosts are
        # alive in the cluster view (booting, or dead-but-still-billed
        # VMs) — double-counting understates the launch budget; skipping
        # dead VMs overshoots it.
        alive_ids = {n["node_id"] for n in state["nodes"] if n["alive"]}
        n_current = len(alive_ids) + len(
            [pid for pid in self._provider.non_terminated_nodes()
             if not any(cid in alive_ids
                        for cid in self._cluster_ids_of(pid))])
        launched: List[str] = []
        # Bin-pack: demands first absorb EXISTING free capacity, then the
        # smallest node type that fits; one node absorbs several demands.
        # Non-numeric node-type entries (e.g. a GCE provider's
        # machine_type) are config, not capacity.
        types = sorted(
            ((name, {k: float(v) for k, v in res.items()
                     if isinstance(v, (int, float))},
              dict(res.get("_labels", {})))
             for name, res in self._provider.node_types.items()),
            key=lambda kv: sum(kv[1].values()))
        pending_capacity: List[tuple] = [
            (dict(n["available"]), dict(n.get("labels") or {}))
            for n in state["nodes"] if n["alive"]]
        for demand in demands:
            placed = False
            for cap, labels in pending_capacity:
                if self._fits(demand, cap) and self._labels_match(demand,
                                                                  labels):
                    for k, v in demand.items():
                        if k == "_labels":
                            continue
                        cap[k] = cap.get(k, 0.0) - v
                    placed = True
                    break
            if placed:
                continue
            for _name, res, type_labels in types:
                if self._fits(demand, res) and self._labels_match(
                        demand, type_labels):
                    cap = dict(res)
                    for k, v in demand.items():
                        if k == "_labels":
                            continue
                        cap[k] = cap.get(k, 0.0) - v
                    pending_capacity.append((cap, type_labels))
                    launched.append(_name)
                    break
        # max_nodes is a HOST cap and n_current counts hosts: charge each
        # launch its host count (one for a GPU machine; a provider whose
        # node spans hosts says how many), else such nodes overshoot the
        # cap by their host factor.
        host_counter = getattr(self._provider, "node_type_hosts", None)
        host_budget = max(0, self.config.max_nodes - n_current)
        taken: List[str] = []
        hosts_used = 0
        for node_type in launched:
            if len(taken) >= self.config.max_launch_per_step:
                break
            hosts = (host_counter(node_type)
                     if host_counter is not None else 1)
            if hosts_used + hosts > host_budget:
                break
            taken.append(node_type)
            hosts_used += hosts
        for node_type in taken:
            try:
                pid = self._provider.create_node(node_type)
                self._managed[pid] = None
                self._launched += 1
            except Exception as e:
                logger.warning("create_node(%s) failed (rest of this "
                               "step's launches skipped): %r",
                               node_type, e)
                break
        return taken

    def _cluster_ids_of(self, pid: str) -> List[str]:
        """Cluster node ids behind one provider node. LocalNodeProvider
        ids ARE cluster node ids; cloud providers (GCE GPU) map one
        provider id to the cluster nodes its machine registered as (via
        the per-step cluster_node_map snapshot)."""
        node_map = getattr(self, "_node_map", None)
        if node_map is not None:
            return node_map.get(pid, [])
        mapper = getattr(self._provider, "cluster_node_ids", None)
        if mapper is not None:
            return mapper(pid)
        return [pid]

    def _scale_down(self, state) -> List[str]:
        now = time.monotonic()
        reaped: List[str] = []
        reaped_hosts = 0
        by_cluster_id = {n["node_id"]: n for n in state["nodes"]}
        for pid in list(self._pending_terminate):
            # A drained-but-unterminated node's heartbeat re-registers it
            # with the head (the head acked False after the drain), so it
            # may be alive again with fresh work routed to it — re-drain
            # before the terminate retry, never terminate a routable node.
            for cid in self._cluster_ids_of(pid):
                if cid in by_cluster_id and by_cluster_id[cid]["alive"]:
                    try:
                        self._rt.head.retrying_call(
                            "drain_node", cid, timeout=10)
                    except Exception as e:
                        logger.warning("re-drain of %s before terminate "
                                       "retry failed: %r", cid, e)
            try:
                self._provider.terminate_node(pid)
            except Exception:
                continue
            self._pending_terminate.discard(pid)
            self._managed.pop(pid, None)
            self._idle_since.pop(pid, None)
            reaped.append(pid)
            # A re-registered node was alive in THIS snapshot: charge its
            # hosts against the min_nodes floor or the main loop below
            # could reap another node and undershoot min_nodes.
            reaped_hosts += len(
                [cid for cid in self._cluster_ids_of(pid)
                 if cid in by_cluster_id and by_cluster_id[cid]["alive"]])
        alive_total = len([n for n in state["nodes"] if n["alive"]])
        for pid in list(self._managed):
            if pid in self._pending_terminate:
                continue
            nodes = [by_cluster_id.get(cid)
                     for cid in self._cluster_ids_of(pid)]
            nodes = [n for n in nodes if n is not None and n["alive"]]
            if not nodes:
                continue
            # A provider node reaps only when EVERY host behind it sat
            # idle (it terminates whole, never host-by-host).
            idle = all(
                all(abs(n["available"].get(k, 0.0) - v) < 1e-9
                    for k, v in n["resources"].items())
                for n in nodes)
            if not idle:
                self._idle_since.pop(pid, None)
                continue
            t0 = self._idle_since.setdefault(pid, now)
            # min_nodes is a HOST floor: a multi-host provider node
            # removes all its hosts at once, so count hosts, not ids.
            if (now - t0 >= self.config.idle_timeout_s
                    and alive_total - reaped_hosts - len(nodes)
                    >= self.config.min_nodes):
                for n in nodes:
                    try:
                        self._rt.head.retrying_call(
                            "drain_node", n["node_id"], timeout=10)
                    except Exception as e:
                        logger.warning("drain of idle node %s failed "
                                       "(terminating anyway): %r",
                                       n["node_id"], e)
                # Only report the node reaped once the provider actually
                # dropped it. Drain removes the node from the head's
                # state, so a failed terminate afterwards moves the pid to
                # _pending_terminate (retried above) rather than relying
                # on this loop ever seeing the node again.
                try:
                    self._provider.terminate_node(pid)
                except Exception:
                    self._pending_terminate.add(pid)
                    reaped_hosts += len(nodes)
                    continue
                self._managed.pop(pid, None)
                self._idle_since.pop(pid, None)
                reaped.append(pid)
                reaped_hosts += len(nodes)
        return reaped

    # ---------------------------------------------------------------- loop

    def _loop(self) -> None:
        failures = 0
        while not self._stop.wait(
                self.config.poll_interval_s * min(2 ** failures, 16)):
            try:
                self.step()
                failures = 0
            except Exception as e:
                # A dead head or a cloud-API outage must not kill the
                # loop, but it must not be silent either: count it,
                # log it, and back the poll off (up to 16x) so a down
                # head isn't hammered every interval.
                failures += 1
                STEP_FAILURES.inc()
                logger.warning(
                    "autoscaler step failed (%d consecutive, next try "
                    "in %.1fs): %r", failures,
                    self.config.poll_interval_s * min(2 ** failures, 16),
                    e)
