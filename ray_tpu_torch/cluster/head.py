"""Cluster head: control plane (GCS-lite).

Parity target: the reference's GCS server (reference:
src/ray/gcs/gcs_server/gcs_server.h with GcsNodeManager :45-ish,
GcsActorManager gcs_actor_manager.h:324, GcsPlacementGroupManager
gcs_placement_group_manager.h:228, GcsKvManager, GcsHealthCheckManager,
pubsub), re-designed as one threaded RPC service over the framed protocol:

- node registry + resource views (heartbeat-refreshed) + health checks
- cluster-level scheduling: hybrid pack/spread node picking with spillback
  (the node manager can still reject; callers re-pick with an exclude list)
- actor directory + lifecycle state machine (PENDING -> ALIVE -> RESTARTING
  -> DEAD) with head-driven creation so restarts replay the creation spec,
  mirroring GcsActorManager's ownership of the actor state machine
- placement groups: bundle reservation against node resource views
  (STRICT_PACK / PACK / SPREAD / STRICT_SPREAD)
- internal KV + pubsub channels (ACTOR, NODE, LOG) over server->client push

A copy of ``ray_tpu/cluster/head.py`` without ``ray_tpu``'s RPC and
resource witnesses. The head keeps the cluster's
trace ring (spans flushed by every process, bounded by entries and bytes)
and serves its flight-recorder ring.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, List, Optional, Set, Tuple

from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg
from ray_tpu_torch.core.task_spec import pg_key_from_strategy
from ray_tpu_torch.cluster.persistence import HeadStore
from ray_tpu_torch.cluster.protocol import ClientPool, RpcServer, blocking_rpc
from ray_tpu_torch.devtools import res_debug as _resdbg
from ray_tpu_torch.devtools import rpc_debug as _rpcdbg
from ray_tpu_torch.devtools.lock_debug import make_lock, make_rlock
from ray_tpu_torch.util import flight_recorder as _flight
from ray_tpu_torch.util import metrics as _metrics

logger = logging.getLogger(__name__)

#: Spans evicted from the head's trace ring by the byte/entry bounds —
#: silent ring rotation hid exactly the "where did my spans go" question
#: this counter answers.
TRACE_SPANS_DROPPED = _metrics.Counter(
    "rtpu_trace_spans_dropped_total",
    "spans evicted from the head trace ring by the entry/byte bounds")

class _TransientReservationFailure(Exception):
    """A node rejected a bundle after local re-check; retry placement."""


class _DirShard:
    """One oid-hash partition of the head object directory. Each shard
    carries its OWN lock: directory churn (object_batch frames from every
    node/owner) contends on shard locks, never on the scheduler-critical
    head lock — and two frames touching different shards apply fully in
    parallel."""

    __slots__ = ("lock", "object_dir", "node_objects", "object_sizes")

    def __init__(self, idx: int):
        self.lock = make_lock(f"head._dir_shard{idx}")
        self.object_dir: Dict[bytes, Set[str]] = {}
        # node -> resident oids WITHIN this shard (drain/death scrub
        # walks only this node's entries per shard, O(touched)).
        self.node_objects: Dict[str, Set[bytes]] = {}
        self.object_sizes: Dict[bytes, int] = {}


# Actor states (reference: src/ray/design_docs/actor_states.rst)
PENDING = "PENDING_CREATION"
ALIVE = "ALIVE"
RESTARTING = "RESTARTING"
DEAD = "DEAD"


class NodeInfo:
    def __init__(self, node_id: str, address: str, resources: Dict[str, float],
                 labels: Dict[str, str], store_name: str):
        self.node_id = node_id
        self.address = address
        self.total = dict(resources)
        self.available = dict(resources)
        self.labels = dict(labels)
        self.store_name = store_name
        self.alive = True
        self.last_heartbeat = time.monotonic()
        self.sync_version = -1  # versioned resource view (delta sync)
        # Cached max-fraction-used utilization, recomputed whenever
        # `available` changes (heartbeats — O(nodes) writes per second)
        # instead of per scheduling pass (O(nodes * resources) reads per
        # PICK: at 100 nodes the recomputation inside every
        # _score_nodes_ex scan was the head's hottest loop and its
        # longest _lock hold — bench.py --scale measures it).
        self.util = 0.0
        # Position in the head's utilization-bucket index (-1 = not
        # indexed: dead, or replaced by a re-registration). Managed by
        # HeadServer._rebucket under the head lock.
        self.util_bucket = -1
        self.recompute_util()

    def recompute_util(self) -> None:
        us = [1 - self.available.get(k, 0) / t
              for k, t in self.total.items() if t > 0]
        self.util = max(us) if us else 0.0

    def view(self) -> Dict[str, Any]:
        return {"node_id": self.node_id, "address": self.address,
                "alive": self.alive, "resources": dict(self.total),
                "available": dict(self.available), "labels": dict(self.labels),
                "store_name": self.store_name}


class ActorInfo:
    def __init__(self, actor_id: bytes, name: Optional[str], namespace: str,
                 spec_blob: bytes, max_restarts: int, resources: Dict[str, float],
                 max_task_retries: int = 0):
        self.actor_id = actor_id
        self.name = name
        self.namespace = namespace
        self.spec_blob = spec_blob  # serialized (cls, args, kwargs, opts)
        self.max_restarts = max_restarts
        # Replay policy: != 0 opts this actor's CALLS into at-least-once
        # delivery — submitters replay unacked calls against a restarted
        # incarnation instead of failing them (reference semantics:
        # max_task_retries on actor methods). 0 = fail-fast (default).
        self.max_task_retries = max_task_retries
        self.restart_count = 0
        self.resources = resources
        self.state = PENDING
        self.worker_addr: Optional[str] = None
        self.node_id: Optional[str] = None
        self.death_reason = ""
        self.cond = threading.Condition()


class HeadServer:
    """All control-plane state + RPC handlers. One instance per cluster."""

    chaos_role = "head"  # fault-injection scope (devtools/chaos.py)

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 persist_path: Optional[str] = None):
        # Incarnation id: a restarted head is a NEW era. Nodes learn it
        # from register_node's reply and reconcile era-scoped state when
        # it changes — head-granted leases from a dead head's in-flight
        # actor creations are returned instead of leaking (reference:
        # the GCS restart epoch raylets compare on reconnect).
        import uuid as _uuid

        self.incarnation = _uuid.uuid4().hex[:12]
        _flight.set_role("head")
        self._lock = make_rlock("head._lock")
        self._nodes: Dict[str, NodeInfo] = {}
        self._actors: Dict[bytes, ActorInfo] = {}
        self._named: Dict[Tuple[str, str], bytes] = {}
        self._kv: Dict[Tuple[str, bytes], bytes] = {}
        # Object directory, sharded by oid hash (_DirShard): holder sets,
        # per-node reverse index, and sealed sizes (the scheduler scores
        # candidate nodes by locally-resident input BYTES — reference:
        # the GCS object directory the raylet's locality-aware lease
        # policy reads). Directory traffic takes ONLY the touched shards'
        # locks; the merged `_object_dir`/`_node_objects`/`_object_sizes`
        # PROPERTIES below exist for introspection/tests and are O(all
        # objects) per read — never use them on a hot path.
        self._dir_shards = [
            _DirShard(i) for i in range(max(1, int(cfg.object_dir_shards)))]
        # Per-node directory sync cursor: the highest journal seq this
        # head has APPLIED from each node's object_batch stream. The
        # heartbeat compares it against the node's dir_seq and NACKs
        # ("dir_resync", cursor) on a gap, so a node republishes only
        # the journal tail the head actually missed — O(touched), not
        # O(objects on node). Own lock: cursor updates ride the
        # object_batch path, which must not take the scheduler lock.
        self._dir_cursors: Dict[str, int] = {}
        self._dir_cursor_lock = make_lock("head._dir_cursor_lock")
        self._locality_hits = 0
        self._locality_misses = 0
        # Utilization-bucket index over ALIVE nodes (guarded by _lock):
        # bucket i holds nodes with util in [i/NB, (i+1)/NB). The pick
        # hot path walks buckets (descending for pack, ascending for
        # spread) and stops at the FIRST feasible node instead of
        # filter+sort over every node per pick — O(nodes examined), not
        # O(N log N). Maintenance is O(1) per heartbeat (_rebucket);
        # the READ path is gated on cfg.head_index_min_nodes so small
        # clusters keep the byte-identical _score_nodes_ex ranking.
        self._util_buckets: List[Dict[str, NodeInfo]] = [
            {} for _ in range(32)]
        self._pgs: Dict[bytes, Dict[str, Any]] = {}
        self._subscribers: Dict[str, List[Any]] = {}  # channel -> [conn]
        self._job_counter = 1
        self._spread_rr = 0
        # Unmet demand ring (autoscaler signal): resource requests that
        # found no feasible node (reference: autoscaler v2 reads cluster
        # resource state demand the same way).
        import collections as _collections

        self._unmet_demand = _collections.deque(
            maxlen=cfg.head_demand_window_max)
        # Span sink for distributed tracing (util/tracing.py). Entries
        # are (approx_bytes, span): bounded by COUNT and by BYTES —
        # spans carry user attrs, and a count-only bound let one chatty
        # tracer eat arbitrary head memory. No deque maxlen: evictions
        # must be counted (TRACE_SPANS_DROPPED), not silent. Own lock:
        # per-request span flushes from every traced worker/replica
        # (plus trace_tail's O(ring) copies) must not contend with the
        # scheduler-critical self._lock.
        self._trace_lock = make_lock("head._trace_lock")
        self._trace_ring = _collections.deque()
        self._trace_ring_bytes = 0
        # Compiled-DAG channel registry: channel_id -> {addr, owner,
        # alive, ts}. The ONE-TIME negotiation point for cross-node
        # channel edges (reader registers its endpoint, writer looks it
        # up once); steady-state channel traffic never comes back here.
        # Entries for a dead owner flip alive=False (writers blocked on
        # the edge read that as peer death) and are reaped by the
        # register-time cap below.
        self._channels: "_collections.OrderedDict[bytes, dict]" = \
            _collections.OrderedDict()
        # Reverse channel indexes (owner addr / host node -> channel
        # ids): the death/drain scrub flips only the dead entity's
        # registrations instead of walking all _CHANNELS_MAX entries
        # per report. Maintained by register/unregister/evict under
        # _lock; exact-equivalent to the full walk.
        self._channels_by_owner: Dict[str, Set[bytes]] = {}
        self._channels_by_node: Dict[str, Set[bytes]] = {}
        # Owner-routed lease blocks (steady-state head bypass): after the
        # first head-mediated pick for a scheduling key the owner gets a
        # pre-negotiated block (node, count, TTL) and dispatches repeat
        # leases node-direct. The head keeps PLACEMENT POLICY — it picks
        # the node, sets the size/TTL, and revokes on drain/death — while
        # the node keeps ADMISSION (it decrements the block per lease).
        # block_id -> {owner, node_id, node_addr, resources, size,
        # ttl_ms, expires_at}; the two reverse indexes make drain/death
        # revocation O(blocks on that node / owner), never a full walk.
        self._lease_blocks: Dict[str, dict] = {}
        self._node_blocks: Dict[str, Set[str]] = {}
        self._owner_blocks: Dict[str, Set[str]] = {}
        # submitter id -> (monotonic, [(resources, count)]) backlog reports
        self._backlogs: Dict[str, Tuple[float, list]] = {}
        # Cluster-wide task-event ring (reference: GcsTaskManager,
        # gcs_task_manager.h:86): every owner's completed-task events land
        # here so list_tasks from ANY driver covers the whole cluster.
        self._task_events = _collections.deque(
            maxlen=int(cfg.task_events_buffer_size))
        self._pool = ClientPool()
        # Bounded executor for node fan-outs (lease census), built on
        # first use under self._lock (see _fanout_pool).
        self._census_pool = None
        # actor_id -> re-register deadline for actors recovered ALIVE
        # from the durable tables (see _sweep_alive_watch).
        self._alive_watch: Dict[bytes, float] = {}
        # True while a rolling upgrade drains this head (prepare_upgrade):
        # health sweeps stop declaring nodes dead — the successor, not
        # this era, owns liveness decisions from here on.
        self._draining = False
        # Durable tables (reference: gcs_table_storage.h). None = memory
        # only. Loaded BEFORE serving so a restarted head answers from the
        # recovered state; nodes re-register on their first heartbeat NACK.
        self._store = HeadStore(persist_path) if persist_path else None
        if self._store is not None:
            self._load_persisted()
        self._server = RpcServer(self, host, port).start()
        self.address = self._server.address
        self._stop = threading.Event()
        self._health_thread = _resdbg.track_thread(threading.Thread(
            target=self._health_loop, daemon=True, name="head-health"),
            owner=self)
        self._health_thread.start()

    # -------------------------------------------------------- persistence

    def _load_persisted(self) -> None:
        self._kv = dict(self._store.kv_load())
        self._job_counter = self._store.get_meta("job_counter", 1)
        for pg_id, state in self._store.load_pgs():
            self._pgs[pg_id] = state
        to_recover: List[ActorInfo] = []
        for actor_id, st in self._store.load_actors():
            info = ActorInfo(actor_id, st["name"], st["namespace"],
                             st["spec_blob"], st["max_restarts"],
                             st["resources"],
                             max_task_retries=st.get("max_task_retries", 0))
            info.strategy = st.get("strategy")
            info.runtime_env = st.get("runtime_env")
            info.restart_count = st.get("restart_count", 0)
            info.state = st.get("state", PENDING)
            info.worker_addr = st.get("worker_addr")
            info.node_id = st.get("node_id")
            info.death_reason = st.get("death_reason", "")
            self._actors[actor_id] = info
            if info.name is not None and info.state != DEAD:
                self._named[(info.namespace, info.name)] = actor_id
            # Creation/restart was in flight when the head died: re-drive
            # it (worker-side create_actor is idempotent, so an actor that
            # actually landed before the crash just re-registers ALIVE).
            if info.state in (PENDING, RESTARTING):
                to_recover.append(info)
            elif info.state == ALIVE and info.node_id is not None:
                # Recovered-ALIVE watch: the host node may have died WITH
                # the old head (no worker_dead_at report will ever
                # arrive, and the health loop can't flag a node it never
                # knew). If the node doesn't re-register within the
                # grace window, the actor is declared dead and re-driven
                # through its max_restarts policy — the all-holders-dead
                # recovery path.
                self._alive_watch[actor_id] = (
                    time.monotonic() + cfg.head_restart_actor_grace_s)
        for info in to_recover:
            threading.Thread(target=self._restart_actor, args=(info,),
                             daemon=True).start()

    def _sweep_alive_watch(self) -> None:
        """Health-loop pass over actors recovered ALIVE from sqlite: an
        actor whose host node re-registered is confirmed (dropped from
        the watch); one whose node never came back within the grace
        window died with the old era — re-drive it."""
        if not self._alive_watch:
            return
        now = time.monotonic()
        victims: List[ActorInfo] = []
        with self._lock:
            for actor_id, deadline in list(self._alive_watch.items()):
                info = self._actors.get(actor_id)
                if info is None or info.state != ALIVE:
                    self._alive_watch.pop(actor_id, None)
                    continue
                n = self._nodes.get(info.node_id)
                if n is not None and n.alive:
                    self._alive_watch.pop(actor_id, None)
                    continue
                if now >= deadline:
                    self._alive_watch.pop(actor_id, None)
                    victims.append(info)
        for info in victims:
            self._actor_died(
                info, "host node never re-registered after head restart",
                try_restart=True)

    def _persist_actor(self, info: ActorInfo) -> None:
        if self._store is None:
            return
        self._store.save_actor(info.actor_id, {
            "name": info.name, "namespace": info.namespace,
            "spec_blob": info.spec_blob, "max_restarts": info.max_restarts,
            "max_task_retries": info.max_task_retries,
            "restart_count": info.restart_count,
            "resources": info.resources,
            "state": info.state, "worker_addr": info.worker_addr,
            "node_id": info.node_id, "death_reason": info.death_reason,
            "strategy": getattr(info, "strategy", None),
            "runtime_env": getattr(info, "runtime_env", None),
        })

    def shutdown(self) -> None:
        self._stop.set()
        # _stop wakes the health loop's wait(): join so no sweep runs
        # against a server/store that is being torn down below.
        self._health_thread.join(timeout=2.0)
        if self._census_pool is not None:
            self._census_pool.shutdown(wait=False)
        self._server.stop()
        self._pool.close_all()
        if self._store is not None:
            self._store.close()
        # RTPU_DEBUG_RES: the health sweep must be gone after the join
        # above (reports, never raises; witness off = one env read).
        _resdbg.check_balanced("head.shutdown", kinds=("thread",),
                               owner=self)

    # ------------------------------------------------------------- publish

    def _publish(self, channel: str, payload: Any) -> None:
        with self._lock:
            subs = list(self._subscribers.get(channel, ()))
        for conn in subs:
            try:
                conn.notify("pubsub", channel, payload)
            except Exception:
                pass

    def rpc_subscribe(self, conn, channel: str):
        with self._lock:
            subs = self._subscribers.setdefault(channel, [])
            if conn not in subs:  # idempotent: resubscribes must not dup
                subs.append(conn)
        return True

    def rpc_unsubscribe(self, conn, channel: str):
        with self._lock:
            subs = self._subscribers.get(channel)
            if subs and conn in subs:
                subs.remove(conn)
        return True

    def on_peer_disconnect(self, conn) -> None:
        with self._lock:
            for subs in self._subscribers.values():
                if conn in subs:
                    subs.remove(conn)

    # ------------------------------------------------------------- nodes

    def _rebucket(self, n: NodeInfo) -> None:
        """Move a node to the util bucket matching its current state
        (dead -> out of the index entirely). Caller holds self._lock.
        O(1): two dict ops when the bucket changed, none when it
        didn't — heartbeats mostly oscillate within one bucket."""
        nb = len(self._util_buckets)
        want = min(nb - 1, int(n.util * nb)) if n.alive else -1
        if want == n.util_bucket:
            return
        if n.util_bucket >= 0:
            self._util_buckets[n.util_bucket].pop(n.node_id, None)
        if want >= 0:
            self._util_buckets[want][n.node_id] = n
        n.util_bucket = want

    def rpc_register_node(self, conn, node_id: str, address: str,
                          resources: Dict[str, float], labels: Dict[str, str],
                          store_name: str):
        with self._lock:
            old = self._nodes.get(node_id)
            if old is not None:
                # Re-registration replaces the NodeInfo object: the old
                # one must leave the bucket index or picks would keep
                # scoring a phantom.
                old.alive = False
                self._rebucket(old)
            self._nodes[node_id] = NodeInfo(node_id, address, resources,
                                            labels, store_name)
            self._rebucket(self._nodes[node_id])
        # Fresh registration starts the directory sync from cursor 0: a
        # node re-registering after a HEAD restart sees the gap on its
        # next heartbeat ("dir_resync", 0) and republishes; a node
        # PROCESS restart (dir_seq reset to 0) must not inherit the old
        # process's cursor and skip its rehydration.
        with self._dir_cursor_lock:
            self._dir_cursors.pop(node_id, None)
        self._publish("NODE", {"event": "added", "node_id": node_id})
        # Truthy for legacy callers; nodes compare it across re-registers
        # to detect a head restart (era change -> republish holder sets,
        # reconcile head-era leases).
        return self.incarnation

    def rpc_heartbeat(self, conn, node_id: str, available: Dict[str, float],
                      version: Optional[int] = None,
                      is_delta: bool = False,
                      dir_seq: Optional[int] = None):
        """Versioned resource sync (reference: ray_syncer's versioned
        NodeState views, common/ray_syncer/ray_syncer.h:83): a delta
        carries only the resources whose availability CHANGED since the
        last acked version. Version gaps (head restart, lost beat) NACK
        with "resync" and the node's next beat is a full snapshot.

        ``dir_seq`` piggybacks the node's directory-journal position: a
        gap against this head's applied cursor acks
        ("dir_resync", cursor) — the node replays only the journal tail
        past the cursor (or a full snapshot if its journal no longer
        reaches back that far). The ack still counts as True for the
        resource versioning above; replayed entries are idempotent, so a
        beat racing in-flight object_batch frames costs a redundant
        tail, never a wrong directory."""
        with self._lock:
            n = self._nodes.get(node_id)
            if n is None:
                return False
            n.last_heartbeat = time.monotonic()
            if is_delta:
                if version is None or version != n.sync_version + 1:
                    return "resync"
                if available:
                    n.available.update(available)
                    n.recompute_util()
            else:
                n.available = dict(available)
                n.recompute_util()
            if version is not None:
                n.sync_version = version
            if not n.alive:
                n.alive = True  # node recovered
            self._rebucket(n)
        if dir_seq is not None:
            with self._dir_cursor_lock:
                cur = self._dir_cursors.get(node_id, 0)
            if cur < dir_seq:
                return ("dir_resync", cur)
        return True

    @staticmethod
    def _sanitize_span(span) -> Tuple[int, dict]:
        """(approx_bytes, span) with oversized attr values truncated.
        Spans carry user ``args``: a multi-MB attribute must cost the
        ring its true size — and get clipped — not ride in under an
        entry-count bound."""
        cap = int(cfg.trace_attr_max_bytes)
        cost = 96
        attrs = span.get("attrs")
        if attrs:
            for k, v in list(attrs.items()):
                if isinstance(v, (int, float, bool)) or v is None:
                    cost += len(k) + 16
                    continue
                s = v if isinstance(v, str) else repr(v)
                if len(s) > cap:
                    s = s[:cap] + "...[truncated]"
                    attrs[k] = s
                cost += len(k) + len(s)
        cost += len(span.get("name", ""))
        return cost, span

    def rpc_trace_spans(self, conn, spans):
        """Span sink (reference: trace export to the collector): every
        process flushes finished spans here; bounded by entry count AND
        bytes, evictions counted into rtpu_trace_spans_dropped_total."""
        entries = [self._sanitize_span(s) for s in spans]
        dropped = 0
        with self._trace_lock:
            for cost, span in entries:
                self._trace_ring.append((cost, span))
                self._trace_ring_bytes += cost
            max_n = int(cfg.trace_ring_size)
            max_b = int(cfg.trace_ring_max_bytes)
            while self._trace_ring and (
                    len(self._trace_ring) > max_n
                    or self._trace_ring_bytes > max_b):
                old_cost, _old = self._trace_ring.popleft()
                self._trace_ring_bytes -= old_cost
                dropped += 1
        if dropped:
            TRACE_SPANS_DROPPED.inc(dropped)
        return True

    def rpc_get_trace(self, conn, trace_id: str):
        with self._trace_lock:
            return [s for _c, s in self._trace_ring
                    if s.get("trace_id") == trace_id]

    def rpc_trace_tail(self, conn, limit: int = 5000):
        """Most-recent spans regardless of trace id (trace_dump + bench
        breakdown aggregation read this)."""
        with self._trace_lock:
            n = len(self._trace_ring)
            return [s for _c, s in list(self._trace_ring)[max(0, n - int(limit)):]]

    def rpc_trace_stats(self, conn):
        with self._trace_lock:
            return {"spans": len(self._trace_ring),
                    "bytes": self._trace_ring_bytes,
                    "dropped_total": TRACE_SPANS_DROPPED.get()}

    def rpc_clock_probe(self, conn):
        """Wall-clock probe: nodes (and trace_dump) estimate per-process
        clock offsets as head_time - (t_send + rtt/2)."""
        return time.time()

    def rpc_dump_flight(self, conn):
        """The head's flight-recorder ring (util/flight_recorder.py)."""
        return _flight.dump_payload(clock_offset_s=0.0)

    def rpc_publish(self, conn, channel: str, payload: Any):
        """Worker-side publishers (reference: per-worker publishers in
        src/ray/pubsub/ — any process may publish; the head fans out to
        channel subscribers)."""
        self._publish(channel, payload)
        return True

    def rpc_drain_node(self, conn, node_id: str):
        """Graceful removal (autoscaler downscale)."""
        with self._lock:
            n = self._nodes.pop(node_id, None)
            if n is not None:
                n.alive = False
                self._rebucket(n)
            # Its object copies leave with it: scrub directory entries
            # (same cleanup as node death) so pullers don't dial a
            # drained node and the locality scorer doesn't credit it.
            self._scrub_node_objects(node_id)
            self._scrub_channels(node_id=node_id)
            doomed = self._pop_blocks(node_id=node_id)
        # Notify the node: a draining node is still alive and would
        # otherwise keep admitting owner-direct leases against its blocks
        # until TTL — owners must fall back to a head pick immediately.
        self._notify_blocks_revoked(doomed)
        if n is not None:
            self._publish("NODE", {"event": "removed", "node_id": node_id})
        return True

    def _shard_for(self, oid: bytes) -> _DirShard:
        import zlib

        return self._dir_shards[zlib.crc32(oid) % len(self._dir_shards)]

    # Merged directory views (introspection / tests / state API): one
    # materialized dict per read, O(all objects). Production paths go
    # through _shard_for and touch only the implicated shards.
    @property
    def _object_dir(self) -> Dict[bytes, Set[str]]:
        out: Dict[bytes, Set[str]] = {}
        for sh in self._dir_shards:
            with sh.lock:
                out.update(sh.object_dir)
        return out

    @property
    def _node_objects(self) -> Dict[str, Set[bytes]]:
        out: Dict[str, Set[bytes]] = {}
        for sh in self._dir_shards:
            with sh.lock:
                for nid, oids in sh.node_objects.items():
                    out.setdefault(nid, set()).update(oids)
        return out

    @property
    def _object_sizes(self) -> Dict[bytes, int]:
        out: Dict[bytes, int] = {}
        for sh in self._dir_shards:
            with sh.lock:
                out.update(sh.object_sizes)
        return out

    def _scrub_node_objects(self, node_id: str) -> None:
        """Drop one node's directory entries via the per-shard reverse
        index — O(shards + objects on that node), never a full-table
        walk. Takes only shard locks (safe with or without self._lock:
        shard locks are leaves)."""
        for sh in self._dir_shards:
            with sh.lock:
                for oid in sh.node_objects.pop(node_id, ()):
                    locs = sh.object_dir.get(oid)
                    if locs is None:
                        continue
                    locs.discard(node_id)
                    if not locs:
                        del sh.object_dir[oid]
                        sh.object_sizes.pop(oid, None)
        with self._dir_cursor_lock:
            self._dir_cursors.pop(node_id, None)

    def rpc_list_nodes(self, conn):
        with self._lock:
            return [n.view() for n in self._nodes.values()]

    def rpc_cluster_resources(self, conn):
        with self._lock:
            total: Dict[str, float] = {}
            avail: Dict[str, float] = {}
            for n in self._nodes.values():
                if not n.alive:
                    continue
                for k, v in n.total.items():
                    total[k] = total.get(k, 0) + v
                for k, v in n.available.items():
                    avail[k] = avail.get(k, 0) + v
            return total, avail

    def _health_loop(self) -> None:
        period = cfg.health_check_period_ms / 1000.0
        threshold = cfg.health_check_failure_threshold * period
        while not self._stop.wait(period):
            if self._draining:
                continue  # upgrade handover: the successor judges liveness
            now = time.monotonic()
            dead_nodes = []
            with self._lock:
                for n in self._nodes.values():
                    if n.alive and now - n.last_heartbeat > threshold:
                        n.alive = False
                        self._rebucket(n)
                        dead_nodes.append(n.node_id)
            for node_id in dead_nodes:
                _flight.record("node_dead", node=node_id[:12])
                self._publish("NODE", {"event": "dead", "node_id": node_id})
                self._on_node_dead(node_id)
            self._sweep_alive_watch()
            self._sweep_expired_blocks()

    def _on_node_dead(self, node_id: str) -> None:
        with self._lock:
            victims = [a for a in self._actors.values()
                       if a.node_id == node_id and a.state == ALIVE]
            # Object copies died with the node: a stale directory entry
            # would make owners believe lost objects are still available
            # (blocking lineage recovery) and make pullers dial a corpse.
            self._scrub_node_objects(node_id)
            # Channel endpoints hosted on the node died with it: flip
            # them so blocked writers see peer death, not a blind stall.
            self._scrub_channels(node_id=node_id)
            # Its lease blocks died with it too — scrub, no notify (there
            # is nothing to dial). Owners dispatching against the dead
            # block hit ConnectionLost and fall back to a head pick.
            self._pop_blocks(node_id=node_id)
        for a in victims:
            self._actor_died(a, f"node {node_id} died", try_restart=True)

    # ------------------------------------------------------------- scheduling

    def _feasible_nodes(self, resources: Dict[str, float],
                        exclude: Set[str]) -> List[NodeInfo]:
        """Alive, not excluded, demand fits current availability."""
        with self._lock:
            return [n for n in self._nodes.values()
                    if n.alive and n.node_id not in exclude
                    and all(n.available.get(k, 0) >= v
                            for k, v in resources.items() if v > 0)]

    def _score_nodes(self, resources: Dict[str, float],
                     exclude: Set[str]) -> List[NodeInfo]:
        return self._score_nodes_ex(resources, exclude)[0]

    def _score_nodes_ex(self, resources: Dict[str, float],
                        exclude: Set[str]) -> Tuple[List[NodeInfo], bool]:
        """Hybrid policy (reference: raylet/scheduling/policy/
        hybrid_scheduling_policy.cc): prefer packing onto already-used
        feasible nodes until utilization crosses `scheduler_spread_threshold`,
        then prefer the least-utilized feasible node. Returns
        (ranked_nodes, saturated): saturated means nothing fits RIGHT NOW
        and the ranking fell back to total capacity (autoscaler demand)."""
        with self._lock:
            feasible = []
            for n in self._nodes.values():
                if not n.alive or n.node_id in exclude:
                    continue
                if all(n.available.get(k, 0) >= v
                       for k, v in resources.items() if v > 0):
                    feasible.append(n)
            if not feasible:
                # Saturated-but-feasible fallback: pick by TOTAL capacity so
                # the lease request queues at the node (which blocks until
                # resources free — reference: tasks queue at the raylet)
                # instead of the submitter churning pick_node every 50ms.
                by_total = [n for n in self._nodes.values()
                            if n.alive and n.node_id not in exclude
                            and all(n.total.get(k, 0) >= v
                                    for k, v in resources.items() if v > 0)]
                by_total.sort(key=lambda n: (n.util, n.node_id))
                return by_total, True

            thresh = cfg.scheduler_spread_threshold
            below = [n for n in feasible if n.util < thresh]
            if below:
                # Pack: highest-utilization node still under threshold.
                below.sort(key=lambda n: (-n.util, n.node_id))
                return below, False
            feasible.sort(key=lambda n: (n.util, n.node_id))
            return feasible, False

    def _pick_first_fit(self, resources: Dict[str, float],
                        exclude: Set[str]):
        """Indexed pick for the default (no-strategy) path: walk the
        util buckets in the hybrid policy's preference order and stop at
        the FIRST feasible node — highest-feasible-under-threshold
        bucket (pack), lowest-feasible bucket (spread), lowest
        total-fit bucket (saturated fallback). Preference is resolved at
        BUCKET granularity (1/nb util): within a bucket, insertion
        order wins rather than an exact util sort — all members are
        within one bucket width of each other, and a per-pick
        sorted(bucket) at 1000 idle nodes (everyone in bucket 0) was
        itself the O(N) scan this index exists to remove. The pack
        dynamics are preserved: the picked node's util rises, the
        heartbeat rebuckets it upward, and the higher bucket stays
        preferred. Caller holds self._lock. Returns
        (node_or_None, saturated)."""
        def fits(n, pool):
            return (n.node_id not in exclude
                    and all(pool(n).get(k, 0) >= v
                            for k, v in resources.items() if v > 0))

        thresh = cfg.scheduler_spread_threshold
        nb = len(self._util_buckets)
        # Pack: feasible node in the highest bucket with util < thresh.
        for bi in range(min(nb - 1, int(thresh * nb)), -1, -1):
            for n in self._util_buckets[bi].values():
                if n.util < thresh and fits(n, lambda n: n.available):
                    return n, False
        # Spread: least-util feasible (every feasible node is >= thresh
        # here, or pack would have returned it).
        for bucket in self._util_buckets:
            for n in bucket.values():
                if fits(n, lambda n: n.available):
                    return n, False
        # Saturated: lowest-bucket node whose TOTAL capacity fits, so
        # the lease request queues there instead of the submitter
        # churning.
        for bucket in self._util_buckets:
            for n in bucket.values():
                if fits(n, lambda n: n.total):
                    return n, True
        return None, False

    def rpc_pick_node(self, conn, resources: Dict[str, float],
                      strategy: Optional[Dict[str, Any]] = None,
                      exclude: Optional[List[str]] = None,
                      demand_key: Optional[Any] = None,
                      input_objects: Optional[List[bytes]] = None):
        """Returns (node_id, address, store_name) or None (infeasible now).

        ``demand_key`` identifies the REQUESTING ENTITY (actor id, sched
        key) for the unmet-demand ring: N distinct requesters of one shape
        must register as N demands, while one requester retrying must
        register as one (see rpc_get_demand).

        ``input_objects`` is the locality hint: ids of the task's input
        objects. Feasible nodes are scored by locally-resident input
        bytes (object directory x sealed sizes) and the best holder wins
        — unless its utilization already crossed
        `scheduler_locality_spill_threshold`, in which case the hybrid
        pack/spread ranking decides (spillback: locality must never
        starve a task behind a loaded holder)."""
        exclude_set = set(exclude or ())
        strategy = strategy or {}
        kind = strategy.get("kind")
        with self._lock:
            if kind == "node_affinity":
                n = self._nodes.get(strategy["node_id"])
                if n and n.alive:
                    return n.node_id, n.address, n.store_name
                if not strategy.get("soft", False):
                    return None
            elif kind == "placement_group":
                pg = self._pgs.get(strategy["pg_id"])
                if pg is None:
                    return None
                idx = strategy.get("bundle_index", -1)
                nodes = ([pg["bundle_nodes"][idx]] if idx >= 0
                         else list(dict.fromkeys(pg["bundle_nodes"])))
                for node_id in nodes:
                    n = self._nodes.get(node_id)
                    if n and n.alive and node_id not in exclude_set:
                        return n.node_id, n.address, n.store_name
                return None
            elif kind == "node_label":
                # Label policy (reference: NodeLabelSchedulingStrategy,
                # scheduling_strategies.py:135 + the node-label policy in
                # raylet/scheduling/policy/): HARD labels filter, SOFT
                # labels rank, then most-available-first so multi-host
                # slices spread rather than insertion-order pack. A
                # momentarily-FULL matching node still gets picked by
                # TOTAL capacity (the lease QUEUES at the node — same
                # no-churn design as the other branches).
                hard = dict(strategy.get("hard") or ())
                soft = dict(strategy.get("soft") or ())
                matching = [n for n in self._nodes.values()
                            if n.alive and n.node_id not in exclude_set
                            and all(n.labels.get(k) == v
                                    for k, v in hard.items())]
                candidates = [n for n in matching
                              if all(n.available.get(k, 0.0) >= v
                                     for k, v in resources.items())]
                if not candidates:
                    candidates = [n for n in matching
                                  if all(n.total.get(k, 0.0) >= v
                                         for k, v in resources.items())]
                if not candidates:
                    # Carry the label constraint with the demand — the
                    # autoscaler must not scale up nodes that can never
                    # match it. Tuple form: demand shapes are HASHED by
                    # the dedup in rpc_get_demand (a dict would raise).
                    demand = dict(resources)
                    if hard:
                        demand["_labels"] = tuple(sorted(hard.items()))
                    self._unmet_demand.append(
                        (time.monotonic(), demand, demand_key))
                    return None

                def rank(n):
                    soft_hits = sum(1 for k, v in soft.items()
                                    if n.labels.get(k) == v)
                    free = sum(n.available.get(k, 0.0)
                               for k in resources)
                    return (-soft_hits, -free, n.node_id)

                n = min(candidates, key=rank)
                return n.node_id, n.address, n.store_name
            elif kind == "spread":
                # True round-robin: the head's availability view lags
                # heartbeats, so utilization-ranking alone would send a
                # burst of spread tasks to one node.
                # Raw feasibility, NOT _score_nodes: the hybrid policy's
                # pack-threshold filter drops feasible-but-utilized nodes,
                # which would pin SPREAD tasks to the emptiest node. A
                # fully-saturated cluster falls through to _score_nodes'
                # by-total fallback so the lease request QUEUES at a node
                # instead of the submitter churning pick_node.
                feasible = self._feasible_nodes(resources, exclude_set)
                feasible.sort(key=lambda n: n.node_id)
                if not feasible:
                    feasible = self._score_nodes(resources, exclude_set)
                if feasible:
                    n = feasible[self._spread_rr % len(feasible)]
                    self._spread_rr += 1
                    return n.node_id, n.address, n.store_name
                return None
        ranked = None
        with self._lock:
            if len(self._nodes) >= cfg.head_index_min_nodes:
                # Large cluster: the bucket index answers the hybrid
                # choice without ranking every node; a hinted pick then
                # re-ranks only the HOLDER set in _apply_locality, so
                # the whole pick is O(buckets + holders), not O(N).
                n, saturated = self._pick_first_fit(resources,
                                                    exclude_set)
                if n is None or saturated:
                    self._unmet_demand.append(
                        (time.monotonic(), dict(resources),
                         demand_key))
                if n is None:
                    return None
                if not input_objects:
                    return n.node_id, n.address, n.store_name
                ranked = [n]
        if ranked is None:
            ranked, saturated = self._score_nodes_ex(resources,
                                                     exclude_set)
            if not ranked:
                self._unmet_demand.append(
                    (time.monotonic(), dict(resources), demand_key))
                return None
            if saturated:
                # Demand exceeds current capacity (autoscaler signal).
                self._unmet_demand.append(
                    (time.monotonic(), dict(resources), demand_key))
        n = ranked[0]
        if input_objects:
            # In the saturated fallback the lease QUEUES at the picked
            # node anyway — queueing at the HOLDER is exactly what
            # locality wants (the utilization spill-check is meaningless
            # there: the view reads ~full everywhere; the lease queue
            # timeout + exclude/retry is the spillback instead).
            n = self._apply_locality(ranked, input_objects, resources,
                                     exclude_set, relax_spill=saturated)
        return n.node_id, n.address, n.store_name

    def rpc_pick_nodes(self, conn, requests):
        """Batched pick_node: one frame places a whole dispatch round's
        lease requests (per-request frames + dispatch overhead at the head
        were a multi-submitter bottleneck). Each request is the pick_node
        argument tuple; the reply is the per-request pick list."""
        return [self.rpc_pick_node(conn, *req) for req in requests]

    def _apply_locality(self, ranked: List[NodeInfo],
                        input_objects: List[bytes],
                        resources: Dict[str, float],
                        exclude: Set[str],
                        relax_spill: bool = False) -> NodeInfo:
        """Re-rank candidate nodes by locally-resident input bytes; ties
        (including the zero-bytes case) keep the hybrid ordering.

        Candidates are ALL alive nodes whose TOTAL capacity fits the
        demand, not just `ranked`: the pack branch ranks only
        under-threshold nodes, and a holder that is momentarily FULL is
        still the right pick — the lease request QUEUES there for
        `scheduler_locality_wait_ms` and only then spills back (waiting
        out one task beats migrating the input bytes)."""
        local_bytes: Dict[str, int] = {}
        for oid in input_objects:
            sh = self._shard_for(oid)
            with sh.lock:
                holders = sh.object_dir.get(oid)
                if not holders:
                    continue
                size = sh.object_sizes.get(oid, 1)
                for nid in holders:
                    local_bytes[nid] = local_bytes.get(nid, 0) + size
        if not local_bytes:
            return ranked[0]
        with self._lock:
            indexed = len(self._nodes) >= cfg.head_index_min_nodes
            if indexed:
                # O(holders) fast path: only a node that actually HOLDS
                # input bytes can beat ranked[0], so the candidate scan
                # is the holder set, not the whole cluster.
                order = {n.node_id: i for i, n in enumerate(ranked)}
                far = len(ranked)
                candidates = [
                    n for n in (self._nodes.get(nid)
                                for nid in local_bytes)
                    if n is not None and n.alive
                    and n.node_id not in exclude
                    and all(n.total.get(k, 0) >= v
                            for k, v in resources.items() if v > 0)]
                if not candidates:
                    return ranked[0]
                best = max(candidates,
                           key=lambda n: (local_bytes[n.node_id],
                                          -order.get(n.node_id, far),
                                          n.node_id))
            else:
                candidates = list(ranked)
                seen = {n.node_id for n in candidates}
                for n in self._nodes.values():
                    if (n.node_id not in seen and n.alive
                            and n.node_id not in exclude
                            and all(n.total.get(k, 0) >= v
                                    for k, v in resources.items()
                                    if v > 0)):
                        candidates.append(n)
        if not indexed:
            if len(candidates) < 2:
                return ranked[0]
            order = {n.node_id: i for i, n in enumerate(candidates)}
            best = max(candidates,
                       key=lambda n: (local_bytes.get(n.node_id, 0),
                                      -order[n.node_id]))
            if local_bytes.get(best.node_id, 0) <= 0:
                return ranked[0]
        # Lazy: the feasibility probe is only needed for the spill check
        # (most hinted picks return before here). `best` is already
        # alive and not excluded (candidate filters above), so probing
        # ITS availability directly replaces the full _feasible_nodes
        # scan — O(resources), not O(N), per pick.
        if (best is not ranked[0] and not relax_spill
                and all(best.available.get(k, 0) >= v
                        for k, v in resources.items() if v > 0)
                and best.util
                >= cfg.scheduler_locality_spill_threshold):
            # Spillback: the holder has capacity RIGHT NOW yet is loaded
            # past the threshold; keep the hybrid choice. A view-full
            # holder is NOT spilled here — its lease request queues
            # briefly at the node and spills via decline+exclude instead.
            with self._lock:
                self._locality_misses += 1
            return ranked[0]
        with self._lock:
            self._locality_hits += 1
        return best

    # -------------------------------------------------------- lease blocks

    def _grant_block(self, block_id: str, owner_addr: str,
                     resources: Dict[str, float],
                     strategy: Optional[Dict[str, Any]],
                     locality_hint: Optional[List[bytes]],
                     prefer_node: Optional[str]):
        """Pick a node, install the block THERE first (the admitting side
        must hold it before the owner dispatches against it), then record
        it in the head tables. Idempotent on block_id: a retried grant
        returns the SAME (node_id, node_addr, size, ttl_ms) tuple —
        double-granting would double the admission budget."""
        if not cfg.lease_block_enabled:
            return None
        with self._lock:
            ent = self._lease_blocks.get(block_id)
            if ent is not None:
                return (ent["node_id"], ent["node_addr"],
                        ent["size"], ent["ttl_ms"])
        picked = None
        if prefer_node:
            # Renewal affinity: keep the key's tasks on the node that
            # already hosts its leases/workers if it still fits by TOTAL
            # capacity (a momentarily-busy node still admits — the lease
            # queues there like any saturated pick).
            with self._lock:
                n = self._nodes.get(prefer_node)
                if (n is not None and n.alive
                        and all(n.total.get(k, 0) >= v
                                for k, v in resources.items() if v > 0)):
                    picked = (n.node_id, n.address, n.store_name)
        if picked is None:
            picked = self.rpc_pick_node(None, resources, strategy, None,
                                        ("lease_block", owner_addr),
                                        locality_hint)
        if picked is None:
            return None
        node_id, node_addr, _store = picked
        size = int(cfg.lease_block_size)
        ttl_ms = int(cfg.lease_block_ttl_ms)
        try:
            ok = self._pool.get(node_addr).retrying_call(
                "lease_block_install", block_id, owner_addr,
                dict(resources), size, ttl_ms,
                timeout=cfg.rpc_control_timeout_s)
        except Exception as e:
            logger.debug("lease block %s install at %s failed: %r",
                         block_id[:12], node_addr, e)
            ok = False
        if not ok:
            return None
        with self._lock:
            n = self._nodes.get(node_id)
            if n is None or not n.alive:
                # Node died/drained between pick and install: the install
                # either never landed or will die with the node — don't
                # record a block the death path can no longer see.
                node_gone = True
            else:
                node_gone = False
                self._lease_blocks[block_id] = {
                    "owner": owner_addr, "node_id": node_id,
                    "node_addr": node_addr, "resources": dict(resources),
                    "size": size, "ttl_ms": ttl_ms,
                    "expires_at": time.monotonic() + ttl_ms / 1000.0}
                self._node_blocks.setdefault(node_id, set()).add(block_id)
                self._owner_blocks.setdefault(owner_addr, set()).add(block_id)
        if node_gone:
            try:
                self._pool.get(node_addr).retrying_call(
                    "lease_block_revoke", block_id, timeout=2)
            except Exception:  # rtpu-lint: disable=swallowed-exception — best-effort: the node is dead or dying; its TTL sweep releases the block
                pass
            return None
        _flight.record("lease_block_grant", block=block_id[:12],
                       node=node_id[:12])
        return (node_id, node_addr, size, ttl_ms)

    def rpc_lease_block_grant(self, conn, block_id: str, owner_addr: str,
                              resources: Dict[str, float],
                              strategy: Optional[Dict[str, Any]] = None,
                              locality_hint: Optional[List[bytes]] = None):
        """First grant for a scheduling key. Returns (node_id, node_addr,
        size, ttl_ms) or None (infeasible / blocks disabled) — None means
        the owner stays on the per-lease pick_node path."""
        return self._grant_block(block_id, owner_addr, resources, strategy,
                                 locality_hint, prefer_node=None)

    def rpc_lease_block_renew(self, conn, block_id: str, owner_addr: str,
                              resources: Dict[str, float],
                              prev_node_id: Optional[str] = None,
                              strategy: Optional[Dict[str, Any]] = None):
        """Low-water renewal: a NEW block_id per renewal (the memo keys on
        it), preferring the previous node so a hot key's placement stays
        sticky while the head retains the option to move it."""
        return self._grant_block(block_id, owner_addr, resources, strategy,
                                 None, prefer_node=prev_node_id)

    def rpc_lease_block_revoke(self, conn, block_id: str):
        """Owner-initiated release (shutdown, key went idle). Idempotent:
        revoking an unknown/already-revoked block is True."""
        self._revoke_blocks([block_id], notify=True)
        return True

    def _pop_blocks(self, *, node_id: Optional[str] = None,
                    owner: Optional[str] = None) -> List[Tuple[str, str]]:
        """Drop every block on a node / owned by an owner from the head
        tables via the reverse indexes — O(blocks implicated), never a
        full-table walk. Caller holds self._lock; returns
        (block_id, node_addr) pairs for out-of-lock node notification."""
        if node_id is not None:
            ids = self._node_blocks.pop(node_id, set())
        else:
            ids = self._owner_blocks.pop(owner, set())
        out: List[Tuple[str, str]] = []
        for bid in ids:
            ent = self._lease_blocks.pop(bid, None)
            if ent is None:
                continue
            out.append((bid, ent["node_addr"]))
            if node_id is not None:
                ob = self._owner_blocks.get(ent["owner"])
                if ob is not None:
                    ob.discard(bid)
                    if not ob:
                        del self._owner_blocks[ent["owner"]]
            else:
                nb = self._node_blocks.get(ent["node_id"])
                if nb is not None:
                    nb.discard(bid)
                    if not nb:
                        del self._node_blocks[ent["node_id"]]
        return out

    def _notify_blocks_revoked(self, targets: List[Tuple[str, str]]) -> None:
        """Best-effort node notification for already-scrubbed blocks (the
        node's TTL sweep is the backstop for a lost notify). One TOTAL
        deadline across the fan-out: N unreachable nodes must not
        serialize N control timeouts inside a death/drain report."""
        deadline = time.monotonic() + cfg.rpc_control_timeout_s
        for bid, addr in targets:
            left = deadline - time.monotonic()
            if left <= 0:
                break  # the nodes' TTL sweeps reclaim the rest
            try:
                self._pool.get(addr).retrying_call("lease_block_revoke",
                                                   bid,
                                                   timeout=min(2.0, left))
            except Exception:  # rtpu-lint: disable=swallowed-exception — best-effort: an unreachable node expires the block by TTL
                pass

    def _revoke_blocks(self, block_ids: List[str], notify: bool) -> None:
        """Tear down blocks by id: scrub head tables, then (if the node
        is presumed alive) tell it to stop admitting. Notification is
        best-effort — the node's TTL sweep is the backstop."""
        targets: List[Tuple[str, str]] = []
        with self._lock:
            for bid in block_ids:
                ent = self._lease_blocks.pop(bid, None)
                if ent is None:
                    continue
                nb = self._node_blocks.get(ent["node_id"])
                if nb is not None:
                    nb.discard(bid)
                    if not nb:
                        del self._node_blocks[ent["node_id"]]
                ob = self._owner_blocks.get(ent["owner"])
                if ob is not None:
                    ob.discard(bid)
                    if not ob:
                        del self._owner_blocks[ent["owner"]]
                if notify:
                    targets.append((bid, ent["node_addr"]))
        self._notify_blocks_revoked(targets)

    def _sweep_expired_blocks(self) -> None:
        """Health-lap backstop: drop head-side records for blocks past
        their TTL (the node refuses + releases them independently, so no
        notify — this only keeps the head tables O(live blocks))."""
        now = time.monotonic()
        with self._lock:
            expired = [bid for bid, ent in self._lease_blocks.items()
                       if now > ent["expires_at"]]
        if expired:
            self._revoke_blocks(expired, notify=False)

    # ------------------------------------------------------------- actors

    @blocking_rpc
    def rpc_register_actor(self, conn, actor_id: bytes, name: Optional[str],
                           namespace: str, spec_blob: bytes, max_restarts: int,
                           resources: Dict[str, float],
                           get_if_exists: bool = False,
                           strategy: Optional[Dict[str, Any]] = None,
                           runtime_env: Optional[Dict[str, Any]] = None,
                           max_task_retries: int = 0):
        """Register + schedule + create. Returns ("created", None) /
        ("exists", actor_id) / raises on name conflict or placement failure.
        Idempotent on actor_id: a retried registration (lost reply) must not
        double-create."""
        with self._lock:
            if actor_id in self._actors:
                return "created", None  # duplicate request; creation underway
            if name is not None:
                key = (namespace, name)
                existing = self._named.get(key)
                if existing is not None:
                    if get_if_exists:
                        return "exists", existing
                    raise ValueError(f"actor name '{name}' already taken")
                self._named[(namespace, name)] = actor_id
            info = ActorInfo(actor_id, name, namespace, spec_blob,
                             max_restarts, resources,
                             max_task_retries=max_task_retries)
            info.strategy = strategy
            info.runtime_env = runtime_env
            self._actors[actor_id] = info
        self._persist_actor(info)
        try:
            self._create_actor_on_some_node(info)
        except BaseException:
            with self._lock:
                self._actors.pop(actor_id, None)
                if name is not None:
                    self._named.pop((namespace, name), None)
            if self._store is not None:
                self._store.delete_actor(actor_id)
            raise
        return "created", None

    def _create_actor_on_some_node(self, info: ActorInfo) -> None:
        """Head-driven creation (mirrors GcsActorScheduler): lease a worker,
        push the creation spec, wait for registration."""
        exclude: Set[str] = set()
        # Generous: under load, worker spawn can eat a full lease-pop
        # timeout per attempt, and an actor creation failing spuriously is
        # far worse than it arriving late.
        deadline = time.monotonic() + cfg.lease_timeout_ms / 1000.0 * 6
        while True:
            picked = self.rpc_pick_node(None, info.resources,
                                        getattr(info, "strategy", None),
                                        list(exclude),
                                        demand_key=info.actor_id)
            if picked is None:
                if time.monotonic() > deadline:
                    with self._lock:
                        view = {n.node_id[:8]: dict(n.available)
                                for n in self._nodes.values() if n.alive}
                    raise RuntimeError(
                        f"no feasible node for actor (resources="
                        f"{info.resources}, strategy="
                        f"{getattr(info, 'strategy', None)}, "
                        f"availability={view})")
                # A denial may be transient (leases lingering): retry the
                # full node set after a pause rather than excluding forever.
                exclude.clear()
                time.sleep(0.05)
                continue
            node_id, node_addr, _ = picked
            import uuid as _uuid

            # PG-placed actors must debit their BUNDLE's reservation, not
            # the node's main pool — otherwise every such actor costs its
            # resources twice (once at PG reserve, once at lease) and
            # starves the rest of the cluster. bundle_index -1 is resolved
            # to a concrete bundle by the node.
            pg = pg_key_from_strategy(getattr(info, "strategy", None))
            # Client timeout must exceed the node's own worker-pop timeout:
            # giving up first abandons a lease the node is about to grant —
            # a permanent resource leak (nobody knows the lease id). The
            # req_id makes retries return the SAME grant.
            try:
                # The dial is inside the try: a node that died but is not
                # yet marked dead (a joined driver's node, just gone)
                # refuses it, and is skipped like a node that denies.
                node = self._pool.get(node_addr)
                # Era-tagged lessee: if this head dies between the grant
                # and create_actor, nobody would ever return the lease —
                # the node reconciles "head:<old-era>" leases away when
                # it re-registers with the restarted head.
                lease = node.retrying_call(
                    "request_lease", info.resources, True, pg,
                    _uuid.uuid4().hex, f"head:{self.incarnation}",
                    getattr(info, "runtime_env", None),
                    timeout=cfg.lease_timeout_ms / 1000.0 + 10)
            except Exception:
                exclude.add(node_id)
                continue
            if lease is None:
                exclude.add(node_id)
                continue
            if isinstance(lease, dict) and "env_error" in lease:
                # Permanent env failure: actor creation fails with the
                # install error instead of cycling spillbacks.
                raise RuntimeError(
                    f"actor runtime_env setup failed: "
                    f"{lease['env_error']}")
            worker_addr, lease_id = lease
            worker = self._pool.get(worker_addr)
            try:
                # Worker-side create_actor is idempotent (hosted check).
                worker.retrying_call("create_actor", info.actor_id,
                                     info.spec_blob, lease_id,
                                     timeout=cfg.lease_grant_push_timeout_s)
            except BaseException:
                try:
                    node.retrying_call("return_lease", lease_id,
                                       timeout=cfg.rpc_control_timeout_s)
                except Exception:
                    pass
                raise
            with self._lock:
                info.state = ALIVE
                info.worker_addr = worker_addr
                info.node_id = node_id
            self._persist_actor(info)
            with info.cond:
                info.cond.notify_all()
            self._publish("ACTOR", {"actor_id": info.actor_id,
                                    "state": ALIVE,
                                    "address": worker_addr})
            return

    @blocking_rpc
    def rpc_wait_actor_address(self, conn, actor_id: bytes,
                               timeout: float = 30.0):
        """Blocks until the actor is ALIVE (returns address) or DEAD
        (returns ("DEAD", reason))."""
        info = self._actors.get(actor_id)
        if info is None:
            return "DEAD", "unknown actor"
        deadline = time.monotonic() + timeout
        with info.cond:
            while info.state not in (ALIVE, DEAD):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return "PENDING", None
                info.cond.wait(remaining)
        if info.state == ALIVE:
            return "ALIVE", info.worker_addr
        return "DEAD", info.death_reason

    def rpc_actor_died(self, conn, actor_id: bytes, reason: str):
        info = self._actors.get(actor_id)
        if info is not None and info.state != DEAD:
            self._actor_died(info, reason, try_restart=True)
        return True

    def _actor_died(self, info: ActorInfo, reason: str,
                    try_restart: bool) -> None:
        restart = try_restart and info.restart_count < info.max_restarts
        _flight.record("actor_died", actor=info.actor_id.hex()[:12],
                       reason=reason[:120], restart=restart)
        with self._lock:
            info.state = RESTARTING if restart else DEAD
            info.worker_addr = None
            info.death_reason = reason
            if not restart and info.name is not None:
                self._named.pop((info.namespace, info.name), None)
        self._persist_actor(info)
        self._publish("ACTOR", {"actor_id": info.actor_id, "state": info.state,
                                "reason": reason})
        if restart:
            info.restart_count += 1
            threading.Thread(target=self._restart_actor, args=(info,),
                             daemon=True).start()
        else:
            with info.cond:
                info.cond.notify_all()

    def _restart_actor(self, info: ActorInfo) -> None:
        try:
            self._create_actor_on_some_node(info)
        except BaseException as e:  # noqa: BLE001
            with self._lock:
                info.state = DEAD
                info.death_reason = f"restart failed: {e!r}"
                if info.name is not None:
                    self._named.pop((info.namespace, info.name), None)
            self._persist_actor(info)
            with info.cond:
                info.cond.notify_all()
            self._publish("ACTOR", {"actor_id": info.actor_id, "state": DEAD,
                                    "reason": info.death_reason})

    def rpc_worker_dead_at(self, conn, worker_addr: Optional[str]):
        """Node manager reports a dead worker process by address: fail (or
        restart) any actors that lived there."""
        if not worker_addr:
            return True
        with self._lock:
            victims = [a for a in self._actors.values()
                       if a.worker_addr == worker_addr and a.state == ALIVE]
            self._scrub_channels(owner=worker_addr)
            # Blocks OWNED by the dead process are admission budget nobody
            # will ever spend: release them at the nodes now so the lease
            # census drains to zero without waiting out the TTL.
            doomed = self._pop_blocks(owner=worker_addr)
        self._notify_blocks_revoked(doomed)
        for a in victims:
            self._actor_died(a, "worker process died", try_restart=True)
        return True

    # ------------------------------------------------------ channel registry

    _CHANNELS_MAX = 8192

    def rpc_channel_register(self, conn, channel_id: bytes, addr: str,
                             owner: str = "", node_id: str = "") -> bool:
        """Compiled-DAG channel negotiation: the READER endpoint of a
        cross-node edge registers its dialable address once; writers
        resolve it via channel_lookup and then never come back.
        Idempotent: re-registering the same channel overwrites (a
        respawned reader re-announces itself)."""
        with self._lock:
            old = self._channels.get(channel_id)
            if old is not None:
                self._channel_index_drop(channel_id, old)
            self._channels[channel_id] = ent = {
                "addr": addr, "owner": owner, "node_id": node_id,
                "alive": True, "ts": time.time()}
            self._channel_index_add(channel_id, ent)
            self._channels.move_to_end(channel_id)
            while len(self._channels) > self._CHANNELS_MAX:
                cid, evicted = self._channels.popitem(last=False)
                self._channel_index_drop(cid, evicted)
        _flight.record("channel_register", ch=channel_id.hex()[:12],
                       addr=addr)
        return True

    def _channel_index_add(self, cid: bytes, ent: dict) -> None:
        self._channels_by_owner.setdefault(
            ent.get("owner", ""), set()).add(cid)
        self._channels_by_node.setdefault(
            ent.get("node_id", ""), set()).add(cid)

    def _channel_index_drop(self, cid: bytes, ent: dict) -> None:
        for idx, key in ((self._channels_by_owner, ent.get("owner", "")),
                         (self._channels_by_node,
                          ent.get("node_id", ""))):
            s = idx.get(key)
            if s is not None:
                s.discard(cid)
                if not s:
                    del idx[key]

    def rpc_channel_lookup(self, conn, channel_id: bytes):
        """Endpoint + liveness for one channel (None = never
        registered / unregistered). ``alive=False`` means the owning
        worker died with the registration still standing — a blocked
        writer should treat the edge as closed, not slow."""
        with self._lock:
            ent = self._channels.get(channel_id)
            return dict(ent) if ent is not None else None

    def rpc_channel_unregister(self, conn, channel_id: bytes) -> bool:
        """Graceful reader teardown. Idempotent — unregistering an
        unknown channel is True (the state 'not registered' holds)."""
        with self._lock:
            ent = self._channels.pop(channel_id, None)
            if ent is not None:
                self._channel_index_drop(channel_id, ent)
        return True

    def _scrub_channels(self, owner: Optional[str] = None,
                        node_id: Optional[str] = None) -> None:
        """Death-report integration (callers hold self._lock): flip
        registrations owned by a dead worker/node to alive=False so
        writers blocked mid-transfer learn the peer died instead of
        timing out blind. Entries stay (bounded by the register cap)
        so lookup can still ANSWER with the death verdict. The reverse
        indexes bound the walk to the dead entity's own registrations
        (one death report used to sweep all _CHANNELS_MAX entries)."""
        cids: Set[bytes] = set()
        if owner is not None:
            cids |= self._channels_by_owner.get(owner, set())
        if node_id is not None:
            cids |= self._channels_by_node.get(node_id, set())
        for cid in cids:
            ent = self._channels.get(cid)
            if ent is not None:
                ent["alive"] = False

    @blocking_rpc
    def rpc_kill_actor(self, conn, actor_id: bytes, no_restart: bool = True):
        info = self._actors.get(actor_id)
        if info is None:
            return False
        if no_restart:
            info.max_restarts = info.restart_count  # disable further restarts
        addr = info.worker_addr
        if addr:
            try:
                # Acked: a chaos-dropped kill would leave a zombie actor
                # holding its lease while the head reports DEAD.
                self._pool.get(addr).retrying_call("kill_actor", actor_id,
                                                   timeout=5)
            except Exception:
                pass
        self._actor_died(info, "killed via ray_tpu_torch.kill", try_restart=not no_restart)
        return True

    def rpc_get_named_actor(self, conn, name: str, namespace: str):
        with self._lock:
            aid = self._named.get((namespace, name))
            if aid is None:
                return None
            info = self._actors[aid]
            return aid, info.spec_blob

    def rpc_get_actor_info(self, conn, actor_id: bytes):
        info = self._actors.get(actor_id)
        if info is None:
            return None
        # at_least_once: submitters consult this at conn-loss time — a
        # restartable actor whose calls opted in (max_task_retries != 0)
        # gets its unacked calls REPLAYED against the next incarnation
        # instead of failed. BOTH knobs gate it: max_restarts alone must
        # keep the legacy fail-fast call semantics (a poison call would
        # kill every incarnation), and max_task_retries without restarts
        # has no incarnation to replay against. restarts doubles as the
        # incarnation number the replay targets.
        return {"state": info.state, "address": info.worker_addr,
                "name": info.name, "restarts": info.restart_count,
                "max_restarts": info.max_restarts,
                "max_task_retries": info.max_task_retries,
                "at_least_once": (info.max_restarts > 0
                                  and info.max_task_retries != 0),
                "reason": info.death_reason}

    def rpc_list_actors(self, conn):
        with self._lock:
            return [{"actor_id": a.actor_id.hex(), "name": a.name,
                     "state": a.state, "node_id": a.node_id,
                     "dead": a.state == DEAD}
                    for a in self._actors.values()]

    # ------------------------------------------------------------- objects

    # NOTE: every in-tree production sender rides the batched
    # ``object_batch`` stream (owner outbox -> node _head_object_batch);
    # the two single-object handlers below remain as the unit-test
    # seeding seam (test_pull_manager/test_chaos pre-load directory
    # state through them) and for wire compatibility. A NEW direct
    # notify of either from an outbox-owning module is a
    # direct-notify-bypasses-outbox lint finding.
    @staticmethod
    def _apply_dir_entries(sh: "_DirShard", node_id: str, entries) -> None:
        """Apply one shard's slice of a directory batch. Caller holds
        sh.lock. Idempotent per entry (set add/discard): a dir_resync
        replay overlapping frames still in flight converges."""
        node_set = sh.node_objects.setdefault(node_id, set())
        for kind, oid, size in entries:
            if kind == "add":
                sh.object_dir.setdefault(oid, set()).add(node_id)
                node_set.add(oid)
                if size:
                    sh.object_sizes[oid] = int(size)
            else:
                locs = sh.object_dir.get(oid)
                if locs:
                    locs.discard(node_id)
                    if not locs:
                        del sh.object_dir[oid]
                        sh.object_sizes.pop(oid, None)
                node_set.discard(oid)

    def rpc_object_added(self, conn, oid: bytes, node_id: str,
                         size: Optional[int] = None):
        sh = self._shard_for(oid)
        with sh.lock:
            self._apply_dir_entries(sh, node_id, [("add", oid, size)])
        return True

    def rpc_object_removed(self, conn, oid: bytes, node_id: str):
        sh = self._shard_for(oid)
        with sh.lock:
            self._apply_dir_entries(sh, node_id, [("rm", oid, None)])
        return True

    def rpc_object_batch(self, conn, node_id: str, entries,
                         cursor: Optional[int] = None,
                         snapshot: bool = False):
        """Batched directory updates from one owner/node: entries are
        ("add", oid, size) / ("rm", oid, None) in submission order,
        grouped by shard so a burst takes each touched shard's lock once
        — and NEVER the scheduler lock. ``cursor`` is the node's journal
        seq after this frame (advances the per-node sync cursor the
        heartbeat audits); ``snapshot`` means the frame is a full mirror
        republish — the node's previous entries are scrubbed first so a
        post-restart rehydration can't resurrect departed objects."""
        if _rpcdbg.enabled():
            # RTPU_DEBUG_RPC: assert the node's directory stream arrived
            # in order (strips the sequence stamp).
            entries = _rpcdbg.check_outbox("head", entries)
        if snapshot:
            with self._dir_cursor_lock:
                self._dir_cursors.pop(node_id, None)
            self._scrub_node_objects(node_id)
        by_shard: Dict[int, list] = {}
        nshards = len(self._dir_shards)
        import zlib

        for e in entries:
            by_shard.setdefault(zlib.crc32(e[1]) % nshards, []).append(e)
        for idx, es in by_shard.items():
            sh = self._dir_shards[idx]
            with sh.lock:
                self._apply_dir_entries(sh, node_id, es)
        if cursor is not None:
            with self._dir_cursor_lock:
                if cursor > self._dir_cursors.get(node_id, 0):
                    self._dir_cursors[node_id] = cursor
        return True

    def rpc_object_locations(self, conn, oid: bytes,
                             requester_node_id: Optional[str] = None):
        """Holder list for an object, NEAREST-FIRST relative to the
        requester: holders sharing the requester's "zone" label sort
        ahead of cross-zone ones (the simulated-DCN distance signal), so
        a puller's first fetch attempt goes to the cheapest copy."""
        sh = self._shard_for(oid)
        with sh.lock:
            holders = list(sh.object_dir.get(oid, ()))
        with self._lock:
            # Filter BEFORE sorting: a drained/unknown node id lingering
            # in the directory must not crash the lookup.
            node_ids = [nid for nid in holders
                        if nid in self._nodes and self._nodes[nid].alive]
            req = self._nodes.get(requester_node_id) \
                if requester_node_id else None
            req_zone = req.labels.get("zone") if req is not None else None

            def dist(nid: str) -> Tuple:
                n = self._nodes[nid]
                same_zone = (req_zone is not None
                             and n.labels.get("zone") == req_zone)
                return (0 if same_zone else 1, nid)

            node_ids.sort(key=dist)
            return [(nid, self._nodes[nid].address) for nid in node_ids]

    def rpc_scheduler_stats(self, conn):
        """Locality accounting for the head's pick decisions (the owner
        dispatch keeps its own counters; this one covers spillbacks)."""
        objects = 0
        obj_bytes = 0
        for sh in self._dir_shards:
            with sh.lock:
                objects += len(sh.object_dir)
                obj_bytes += sum(sh.object_sizes.values())
        with self._lock:
            return {"locality_hits": self._locality_hits,
                    "locality_misses": self._locality_misses,
                    "objects_tracked": objects,
                    "object_bytes_tracked": obj_bytes,
                    "lease_blocks": len(self._lease_blocks),
                    "head_incarnation": self.incarnation}

    def _fanout_pool(self):
        """Lazily-built bounded executor for node fan-outs (census).
        One thread PER NODE per census call scaled as O(N) thread
        creations per leak check — at 100 nodes that alone dominated
        census wall time; a persistent pool amortizes it. Flat 32
        workers (ThreadPoolExecutor only spawns threads on demand, so
        a small cluster pays for what it uses and a grown one is not
        frozen at its boot-time size); built under self._lock so
        concurrent first censuses can't each build — and leak — one."""
        with self._lock:
            pool = self._census_pool
            if pool is None:
                from concurrent.futures import ThreadPoolExecutor

                pool = self._census_pool = ThreadPoolExecutor(
                    max_workers=32, thread_name_prefix="head-fanout")
        return pool

    @blocking_rpc
    def rpc_cluster_leases(self, conn):
        """Cluster-wide open-lease census: fan out to every alive node's
        list_leases (the chaos bench's leak detector — after a scenario
        drains, every lease must be returned and every node's available
        must equal its total). The per-node calls run CONCURRENTLY on
        the persistent fan-out pool so total census time is bounded by
        one control-RPC timeout (not N of them) without paying N thread
        creations per census."""
        with self._lock:
            nodes = [(n.node_id, n.address) for n in self._nodes.values()
                     if n.alive]
        results: Dict[str, Any] = {}
        results_lock = threading.Lock()

        def census_one(node_id: str, address: str) -> None:
            try:
                leases, avail = self._pool.get(address).call(
                    "list_leases", timeout=cfg.rpc_control_timeout_s)
                entry = {"leases": leases, "available": avail}
            except Exception as e:  # noqa: BLE001 — census is best-effort
                entry = {"error": f"unreachable: {e!r}"}
            with results_lock:
                results[node_id] = entry

        pool = self._fanout_pool()
        futures = [pool.submit(census_one, *na) for na in nodes]
        deadline = time.monotonic() + cfg.rpc_control_timeout_s + 2.0
        for f in futures:
            try:
                f.result(timeout=max(0.1, deadline - time.monotonic()))
            except Exception:  # rtpu-lint: disable=swallowed-exception — census_one recorded its own outcome; this is only the deadline wait
                pass
        # Snapshot under the lock: a straggler may still write results
        # after the deadline, and the reply must not be mutated while it
        # serializes.
        with results_lock:
            out = dict(results)
        for node_id, _addr in nodes:
            out.setdefault(node_id, {"error": "census timed out"})
        return out

    # ------------------------------------------------------------- KV

    def rpc_kv_put(self, conn, ns: str, key: bytes, value: bytes,
                   overwrite: bool = True):
        with self._lock:
            k = (ns, key)
            if not overwrite and k in self._kv:
                # Idempotent under re-delivery: a RETRY of the put that
                # already landed (same value) acks True; only a genuine
                # conflict (different value, someone else won) is False.
                return self._kv[k] == value
            self._kv[k] = value
        if self._store is not None:
            self._store.kv_put(ns, key, value)
        return True

    def rpc_kv_get(self, conn, ns: str, key: bytes):
        with self._lock:
            return self._kv.get((ns, key))

    def rpc_kv_del(self, conn, ns: str, key: bytes):
        with self._lock:
            existed = self._kv.pop((ns, key), None) is not None
        if self._store is not None:
            self._store.kv_del(ns, key)
        return existed

    def rpc_kv_keys(self, conn, ns: str, prefix: bytes = b""):
        with self._lock:
            return [k for (n, k) in self._kv if n == ns and k.startswith(prefix)]

    # ------------------------------------------------------------- PGs

    @blocking_rpc
    def rpc_create_pg(self, conn, pg_id: bytes, bundles: List[Dict[str, float]],
                      strategy: str, name: str):
        """Reserve bundle resources on nodes. 2-phase-lite: reservation
        happens against the head's resource view and is pushed to node
        managers (prepare+commit in one RPC; they re-check locally).
        Idempotent on pg_id: a retried create returns once the original
        attempt lands (or re-runs placement if it failed)."""
        with self._lock:
            if pg_id in self._pgs:
                return True  # duplicate request (reply was lost)
            if not hasattr(self, "_pgs_creating"):
                self._pgs_creating = {}
            ev = self._pgs_creating.get(pg_id)
            am_creator = ev is None
            if am_creator:
                ev = self._pgs_creating[pg_id] = threading.Event()
        if not am_creator:
            # A concurrent duplicate: wait for the original attempt, and
            # surface ITS failure as an error (not a silent False the
            # caller would mistake for success).
            ev.wait(cfg.lease_timeout_ms / 1000.0 * 3 + 5)
            with self._lock:
                if pg_id in self._pgs:
                    return True
            raise RuntimeError("placement group creation failed")
        try:
            return self._create_pg_inner(pg_id, bundles, strategy, name)
        finally:
            ev.set()
            with self._lock:
                self._pgs_creating.pop(pg_id, None)

    def _create_pg_inner(self, pg_id: bytes, bundles: List[Dict[str, float]],
                         strategy: str, name: str):
        deadline = time.monotonic() + cfg.lease_timeout_ms / 1000.0 * 3
        while True:
            with self._lock:
                nodes = [n for n in self._nodes.values() if n.alive]
                placement = _place_bundles(bundles, strategy, nodes)
            # Every bundle whose reservation was SENT, answered or not: a
            # call that raised (its reply lost) may have reserved on the
            # node, and the node releases an absent bundle as a no-op.
            attempted = []
            if placement is not None:
                try:
                    for idx, (bundle, node) in enumerate(
                            zip(bundles, placement)):
                        attempted.append((node, idx, bundle))
                        ok = self._pool.get(node.address).retrying_call(
                            "reserve_bundle", pg_id, idx, bundle,
                            timeout=cfg.rpc_state_timeout_s)
                        if not ok:
                            raise _TransientReservationFailure()
                    break  # all bundles reserved
                except BaseException as e:
                    for node, idx, bundle in attempted:
                        try:
                            self._pool.get(node.address).retrying_call(
                                "release_bundle", pg_id, idx,
                                timeout=cfg.rpc_control_timeout_s)
                        except Exception:
                            pass
                    if not isinstance(e, _TransientReservationFailure):
                        raise
            # Transiently infeasible (lingering leases show as used in the
            # heartbeat view, or a node re-checked and rejected): retry.
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"placement group infeasible: {strategy} {bundles}")
            time.sleep(cfg.pg_bundle_retry_sleep_s)
        with self._lock:
            self._pgs[pg_id] = {"bundles": bundles, "strategy": strategy,
                                "name": name,
                                "bundle_nodes": [n.node_id for n in placement],
                                "state": "CREATED"}
        if self._store is not None:
            self._store.save_pg(pg_id, self._pgs[pg_id])
        return True

    @blocking_rpc
    def rpc_remove_pg(self, conn, pg_id: bytes):
        # blocking: the release fan-out below joins threads for up to a
        # control-timeout window — inline on the reader thread it would
        # head-of-line-block every other RPC from the same peer.
        with self._lock:
            pg = self._pgs.pop(pg_id, None)
        if self._store is not None:
            self._store.delete_pg(pg_id)
        if pg is None:
            # Already removed (re-delivered request): same ack as the
            # first delivery — the bundles are gone either way.
            return True
        # Concurrent release fan-out with a total join deadline: a
        # serial per-node loop paying a full control timeout per
        # MID-DEATH node would outrun the caller's own deadline. Each
        # release still rides retrying_call — a transiently dropped
        # release on an ALIVE
        # node would otherwise leak the bundle's reserved resources
        # forever (only node DEATH reconciles bundles) — and a thread
        # outliving the join keeps retrying in the background so the
        # release eventually lands even when the handler has answered.
        targets = []
        for idx, node_id in enumerate(pg["bundle_nodes"]):
            with self._lock:
                n = self._nodes.get(node_id)
            if n is not None:
                targets.append((idx, n.address))

        def release_one(idx: int, address: str) -> None:
            try:
                self._pool.get(address).retrying_call(
                    "release_bundle", pg_id, idx,
                    timeout=cfg.rpc_control_timeout_s)
            except Exception as e:  # noqa: BLE001 — best-effort; death
                logger.debug("release_bundle %d of pg %s at %s failed: "
                             "%r", idx, pg_id.hex()[:8], address, e)

        threads = [threading.Thread(target=release_one, args=t,
                                    daemon=True, name="pg-release")
                   for t in targets]
        for t in threads:
            t.start()
        deadline = time.monotonic() + cfg.rpc_control_timeout_s + 2.0
        for t in threads:
            t.join(timeout=max(0.1, deadline - time.monotonic()))
        return True

    def rpc_pg_table(self, conn):
        with self._lock:
            return {pg_id.hex(): dict(v) for pg_id, v in self._pgs.items()}

    def rpc_pg_ready(self, conn, pg_id: bytes):
        with self._lock:
            return pg_id in self._pgs

    # ------------------------------------------------------------- misc

    def rpc_report_task_events(self, conn, owner_addr: str,
                               events: list) -> bool:
        """Owners flush completed-task events here every backlog sweep
        (reference: TaskEventBuffer -> GcsTaskManager.AddTaskEventData)."""
        with self._lock:
            for e in events:
                e["owner"] = owner_addr
                self._task_events.append(e)
        return True

    def rpc_list_task_events(self, conn, limit: int = 100) -> list:
        """Most-recent-first cluster task events (state API backend)."""
        with self._lock:
            out = list(self._task_events)
        out.reverse()
        return out[:max(0, int(limit))]

    def rpc_report_backlog(self, conn, submitter_id: str, entries: list):
        """Periodic per-submitter queued-task backlog (autoscaler demand;
        reference: backlog_size on lease requests)."""
        with self._lock:
            if entries:
                self._backlogs[submitter_id] = (time.monotonic(), entries)
            else:
                self._backlogs.pop(submitter_id, None)
        return True

    def rpc_get_demand(self, conn, window_s: float = 30.0):
        """Autoscaler poll: recent unmet resource demands (pick failures
        + live queued backlogs) + node views."""
        cutoff = time.monotonic() - window_s
        with self._lock:
            # Backlog reports carry true queued counts per shape — they
            # are authoritative. The failed-pick ring records EVERY retry
            # (one infeasible requester picks repeatedly), so it collapses
            # to one entry per (requester, shape) — N concurrent actor
            # creations of one shape stay N demands, one retrying actor
            # stays one — and only for shapes the backlog doesn't already
            # cover (raw ring entries would over-launch per retry).
            demands = []
            backlog_shapes = set()
            for sid, (t, entries) in list(self._backlogs.items()):
                if t < cutoff:
                    self._backlogs.pop(sid, None)
                    continue
                for resources, count in entries:
                    backlog_shapes.add(tuple(sorted(resources.items())))
                    demands.extend([dict(resources)] * int(count))
            ring: dict = {}
            for t, d, key in self._unmet_demand:
                if t >= cutoff:
                    shape = tuple(sorted(d.items()))
                    ring[(key, shape)] = (shape, d)
            demands.extend(dict(d) for shape, d in ring.values()
                           if shape not in backlog_shapes)
            nodes = [n.view() for n in self._nodes.values()]
        return {"unmet": demands, "nodes": nodes}

    def rpc_new_job_id(self, conn):
        with self._lock:
            self._job_counter += 1
            n = self._job_counter
        if self._store is not None:
            self._store.set_meta("job_counter", n)
        return n

    # ---------------------------------------------------------- upgrade

    @blocking_rpc
    def rpc_prepare_upgrade(self, conn):
        """Rolling-upgrade drain + snapshot flush (step 1 of
        ``ClusterRuntime.rolling_head_upgrade``): stop this era's health
        verdicts (the successor owns liveness from here), wait out in-flight actor
        creations so no creation spec is mid-push when the port changes
        hands, then checkpoint the sqlite WAL so the successor's first
        read sees every durable row without replaying the log.

        Idempotent: a re-delivered prepare re-checkpoints and returns the
        same summary — draining twice is draining."""
        self._draining = True
        deadline = time.monotonic() + cfg.head_upgrade_drain_timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                in_flight = [a for a in self._actors.values()
                             if a.state in (PENDING, RESTARTING)]
            if not in_flight:
                break
            time.sleep(0.1)
        flushed = False
        if self._store is not None:
            self._store.checkpoint()
            flushed = True
        with self._lock:
            summary = {"incarnation": self.incarnation,
                       "actors": len(self._actors),
                       "nodes": len(self._nodes),
                       "pgs": len(self._pgs),
                       "kv_keys": len(self._kv),
                       "flushed": flushed}
        _flight.record("head_drain", **{k: v for k, v in summary.items()
                                        if k != "incarnation"})
        return summary

    def rpc_resume_serving(self, conn):
        """Abort a drain (upgrade rolled back): re-enable health sweeps."""
        self._draining = False
        return True

    def rpc_ping(self, conn):
        return "pong"


def _place_bundles(bundles: List[Dict[str, float]], strategy: str,
                   nodes: List[NodeInfo]) -> Optional[List[NodeInfo]]:
    """Bundle placement policies (reference: raylet/scheduling/policy/
    bundle_scheduling_policy.cc)."""
    avail = {n.node_id: dict(n.available) for n in nodes}
    by_id = {n.node_id: n for n in nodes}

    def fits(node_id: str, bundle: Dict[str, float]) -> bool:
        a = avail[node_id]
        return all(a.get(k, 0) >= v for k, v in bundle.items() if v > 0)

    def take(node_id: str, bundle: Dict[str, float]) -> None:
        a = avail[node_id]
        for k, v in bundle.items():
            a[k] = a.get(k, 0) - v

    if strategy == "STRICT_PACK":
        for n in nodes:
            snapshot = dict(avail[n.node_id])
            ok = True
            for b in bundles:
                if fits(n.node_id, b):
                    take(n.node_id, b)
                else:
                    ok = False
                    break
            if ok:
                return [n] * len(bundles)
            avail[n.node_id] = snapshot
        return None
    if strategy == "STRICT_SPREAD":
        if len(bundles) > len(nodes):
            return None
        placement, used = [], set()
        for b in bundles:
            cand = [n for n in nodes
                    if n.node_id not in used and fits(n.node_id, b)]
            if not cand:
                return None
            cand.sort(key=lambda n: n.node_id)
            placement.append(cand[0])
            used.add(cand[0].node_id)
            take(cand[0].node_id, b)
        return placement
    # PACK (soft) / SPREAD (soft): greedy with preference.
    placement = []
    for b in bundles:
        cand = [n for n in nodes if fits(n.node_id, b)]
        if not cand:
            return None
        if strategy == "SPREAD":
            counts = {n.node_id: 0 for n in nodes}
            for p in placement:
                counts[p.node_id] += 1
            cand.sort(key=lambda n: (counts[n.node_id], n.node_id))
        else:  # PACK
            counts = {n.node_id: 0 for n in nodes}
            for p in placement:
                counts[p.node_id] += 1
            cand.sort(key=lambda n: (-counts[n.node_id], n.node_id))
        placement.append(cand[0])
        take(cand[0].node_id, b)
    return placement
