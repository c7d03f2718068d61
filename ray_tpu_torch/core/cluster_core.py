"""Shared cluster-mode runtime core: embedded in the driver AND every worker.

Parity target: the reference's CoreWorker (reference:
src/ray/core_worker/core_worker.h:166 — SubmitTask :853, CreateActor :878,
SubmitActorTask :935, Put :466, Get :642, Wait :682 — plus
transport/normal_task_submitter.h:74 lease-based submission with lease reuse,
transport/actor_task_submitter.h:75 ordered per-actor queues, and the
ownership model of reference_count.h). Re-designed over the framed RPC plane:

- every process runs an RPC server: it is the OWNER endpoint for objects it
  creates (serves gets, receives task_done pushes) and, for workers, the
  task-execution endpoint
- normal tasks: head picks a node (hybrid policy + spillback), the node
  leases a worker, the task is pushed DIRECTLY to the worker; leases are
  cached per scheduling key and reused while tasks are in flight (the
  OnWorkerIdle pattern), released after an idle linger
- small results ride the task_done push (owner memory store); large results
  are sealed into the executing node's shm store and pulled on demand
- actor calls go direct to the actor's worker with sequence numbers; on
  connection loss the submitter consults the head: RESTARTING -> wait and
  resubmit pending calls to the new address, DEAD -> fail with
  ActorDiedError
"""

from __future__ import annotations

import itertools
import logging
import queue
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch.core import runtime_context
from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg
from ray_tpu_torch.core.ids import (ActorID, JobID, NodeID, ObjectID,
                              PlacementGroupID, TaskID, WorkerID)
from ray_tpu_torch.core.memory_store import MemoryStore, PlasmaStub
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.refcount import ReferenceCounter
from ray_tpu_torch.core.serialization import SERIALIZER, capture_exception
from ray_tpu_torch.core.shm_store import ShmObjectExistsError, ShmStore
from ray_tpu_torch.core.task_spec import PlacementGroupSpec, pg_key_from_strategy
from ray_tpu_torch.cluster.protocol import (ClientPool, ConnectionLost, RpcClient,
                                      RpcServer, blocking_rpc)
from ray_tpu_torch.devtools import res_debug as _resdbg
from ray_tpu_torch.devtools import rpc_debug as _rpcdbg
from ray_tpu_torch.devtools.lock_debug import make_lock
from ray_tpu_torch.exceptions import (ActorDiedError, GetTimeoutError, TaskError,
                                WorkerCrashedError)
from ray_tpu_torch.core.lineage import LineageRecord as _LineageRecord
from ray_tpu_torch.util import metrics as _metrics
from ray_tpu_torch.util import timeline as _timeline

logger = logging.getLogger(__name__)


class _SubmitTemplate:
    """Constant-per-function submission state (see make_submit_template)."""

    __slots__ = ("func", "num_returns", "resources", "strategy", "name",
                 "sched_key", "spread", "effective_retries", "runtime_env",
                 "env_hash", "spec_proto", "streaming")

    def __init__(self, func, num_returns, resources, strategy, name,
                 sched_key, spread, effective_retries, runtime_env,
                 env_hash, spec_proto, streaming=False):
        self.func = func
        self.num_returns = num_returns
        self.resources = resources
        self.strategy = strategy
        self.name = name
        self.sched_key = sched_key
        self.spread = spread
        self.effective_retries = effective_retries
        self.runtime_env = runtime_env
        self.env_hash = env_hash
        self.spec_proto = spec_proto
        self.streaming = streaming


class _Lease:
    __slots__ = ("worker_addr", "lease_id", "node_addr", "node_id",
                 "inflight", "release_at", "broken")

    def __init__(self, worker_addr: str, lease_id: str, node_addr: str,
                 node_id: Optional[str] = None):
        self.worker_addr = worker_addr
        self.lease_id = lease_id
        self.node_addr = node_addr
        # Which node granted this lease: the dispatch-side locality match
        # pairs queued tasks with leases on their inputs' holder node.
        self.node_id = node_id
        self.inflight = 0
        # A lease is born with a linger deadline: a grant that lands AFTER
        # the queue drained (slow worker spawn raced the burst) must still be
        # returned to its node — release_at=0 here used to mean "never",
        # permanently leaking the lease's CPUs and starving the cluster.
        self.release_at = time.monotonic() + cfg.lease_linger_ms / 1000.0
        self.broken = False


class _LeaseBlock:
    """Owner-held admission budget for one scheduling key: the head
    pre-negotiated `size` lease admissions at one node, so dispatch for
    this key goes node-direct (no pick_node round trip) until the budget
    or TTL runs out. Guarded by ClusterCore._lease_lock."""

    __slots__ = ("block_id", "node_id", "node_addr", "remaining", "size",
                 "expires_at", "renewing")

    def __init__(self, block_id: str, node_id: str, node_addr: str,
                 size: int, ttl_ms: int):
        self.block_id = block_id
        self.node_id = node_id
        self.node_addr = node_addr
        self.remaining = int(size)
        self.size = int(size)
        self.expires_at = time.monotonic() + ttl_ms / 1000.0
        # True while a low-water renewal is in flight (one renewer at a
        # time; the flag rides the BLOCK so a replaced block can't leave
        # a stale "renewing" latch on the key).
        self.renewing = False


class _InflightTask:
    __slots__ = ("spec_blob", "return_ids", "worker_addr", "retries_left",
                 "sched_key", "resources", "strategy", "name", "sys_retries",
                 "runtime_env", "streaming", "arg_ids", "enqueued_at",
                 "pref_node", "trace_ctx", "submit_t")

    def __init__(self, spec_blob, return_ids, worker_addr, retries_left,
                 sched_key, resources, strategy, name, runtime_env=None,
                 streaming=False):
        self.spec_blob = spec_blob
        self.return_ids = return_ids
        self.worker_addr = worker_addr
        self.retries_left = retries_left
        self.sched_key = sched_key
        self.resources = resources
        self.strategy = strategy
        self.name = name
        self.sys_retries = None  # lazily set from config on first failure
        self.runtime_env = runtime_env  # validated dict or None
        self.streaming = streaming
        # ObjectIDs passed as args: the locality signal — lease requests
        # ship them as the pick_node hint, and dispatch pairs the task
        # with a lease on the node holding most of their bytes.
        self.arg_ids: List[ObjectID] = []
        self.enqueued_at = 0.0  # stamped by _enqueue_task (defer aging)
        # Memoized _preferred_node result (False = not yet resolved):
        # the dispatch match consults it per lease per round, and the
        # answer only depends on arg_ids + the slow-changing locality
        # cache. Re-resolved while unknown (locations may arrive late).
        self.pref_node: Any = False
        # Distributed tracing: the submitter's wire span context (None
        # when tracing is off — the dispatcher-side span emits are gated
        # on it, so the untraced hot path allocates nothing) and the
        # wall-clock submit time the dispatch span starts from.
        self.trace_ctx: Optional[Dict[str, str]] = None
        self.submit_t = 0.0


class _StreamState:
    """Owner-side record of one streaming-generator task (reference: the
    streaming-generator ref bookkeeping in task_manager.h:212)."""

    __slots__ = ("received", "consumed", "total", "error", "cv")

    def __init__(self):
        self.received = 0          # items delivered so far (contiguous)
        self.consumed = 0          # items handed to the consumer
        self.total = None          # set at stream end
        self.error = None          # terminal error (raised at consume point)
        self.cv = threading.Condition()


class ObjectRefGenerator:
    """Iterator over a streaming task's yielded refs, in yield order.
    Each __next__ blocks until the next item's object has ARRIVED at the
    owner (the ref is immediately gettable). Dropping the generator
    without draining it cancels the stream: the producer stops and
    undelivered items are released."""

    def __init__(self, core: "ClusterCore", task_id: TaskID):
        self._core = core
        self._task_id = task_id
        self._index = 0
        self._exhausted = False

    def __iter__(self):
        return self

    def __next__(self) -> ObjectRef:
        try:
            ref = self._core._next_stream_ref(
                self._task_id, self._index,
                timeout=cfg.streaming_item_timeout_s)
        except StopIteration:
            self._exhausted = True
            raise
        self._index += 1
        return ref

    def task_id(self) -> TaskID:
        return self._task_id

    def close(self) -> None:
        if not self._exhausted:
            self._exhausted = True
            try:
                self._core._abandon_stream(self._task_id)
            except Exception:
                pass

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class _KeyQueue:
    """Per-scheduling-key submission state: pending tasks + leased workers."""

    __slots__ = ("key", "queue", "leases", "dispatcher_running",
                 "pending_lease_requests", "wake", "lease_fail_deadline",
                 "lease_backoff", "next_lease_attempt", "avg_task_s",
                 "block", "block_pending")

    def __init__(self, key: tuple):
        import collections

        self.key = key
        self.queue = collections.deque()
        self.leases: List[_Lease] = []
        self.dispatcher_running = False
        self.pending_lease_requests = 0
        self.wake = threading.Event()
        self.lease_fail_deadline = None
        # Owner-routed lease block for this key (steady-state head
        # bypass): None until the first head-mediated grant succeeds and
        # the background block negotiation lands. block_pending latches
        # while a grant request is in flight (one per key).
        self.block: Optional[_LeaseBlock] = None
        self.block_pending = False
        # Declined-lease backoff: a saturated cluster must not cost a
        # pick_node RPC + requester thread every 50ms per scheduling key.
        self.lease_backoff = 0.0
        self.next_lease_attempt = 0.0
        # EWMA of observed execution seconds for this key: decides
        # whether dispatch pipelines (short tasks) or holds one-per-lease
        # (long tasks). None until the first completion reports.
        self.avg_task_s = None


class _ActorConn:
    """Submitter-side state for one remote actor.

    Ordering contract (reference: sequential_actor_submit_queue.h): calls
    from one submitter execute in submission order. Seq numbers are assigned
    synchronously in submit_actor_task, and ONE sender thread per actor
    drains the outbound queue in seq order over a single TCP connection —
    frame order on the socket IS execution-submission order on the worker."""

    __slots__ = ("actor_id", "address", "next_seq", "outbound", "unacked",
                 "pending", "lock", "sender_running", "dead", "death_reason",
                 "loss_handling", "incarnation", "replays")

    def __init__(self, actor_id: ActorID):
        import collections

        self.actor_id = actor_id
        self.address: Optional[str] = None
        self.next_seq = 0
        self.outbound = collections.deque()  # (seq, task_id_bytes, blob, rids)
        self.unacked = collections.deque()   # [seq, tid, blob, waiter, tries, deadline]
        self.pending: Dict[int, tuple] = {}  # seq -> (tid, blob, return_ids)
        self.lock = make_lock("cluster_core.actor_conn.lock")
        self.sender_running = False
        self.dead = False
        self.death_reason = ""
        # True while ONE conn-loss handler owns this conn's recovery
        # (concurrent loss reports — sender inline + pool on_close
        # threads — must not double-replay or double-fail).
        self.loss_handling = False
        # Last head-reported restart count this submitter replayed
        # against; purely observational (the worker's per-caller seq
        # horizon is what makes a cross-incarnation replay safe).
        self.incarnation = 0
        # seq -> cross-incarnation replay count (entries leave with
        # pending): a poison call stops after max_task_retries replays
        # instead of riding every future incarnation.
        self.replays: Dict[int, int] = {}

    def min_pending(self) -> int:
        """Smallest seq still awaiting completion — the ordered-execution
        horizon shipped with every push (see worker _OrderState)."""
        with self.lock:
            return min(self.pending) if self.pending else self.next_seq


class ClusterCore:
    """Runtime-interface implementation for cluster mode."""

    is_cluster = True

    def __init__(self, head_addr: str, node_addr: str, node_id: str,
                 store_name: str, job_id: JobID, is_driver: bool = True):
        self.job_id = job_id
        self.node_id = node_id
        self.worker_id = WorkerID.from_random()
        self.is_driver = is_driver
        self.head_addr = head_addr
        self.node_addr = node_addr

        self.memory_store = MemoryStore()
        self.refcount = ReferenceCounter(
            on_release=self._release_object,
            on_borrow_release=self._release_borrow)
        self.store = ShmStore.open(store_name)
        self._driver_task_id = TaskID.for_driver(job_id)
        self._nil_actor = ActorID.nil_for_job(job_id)
        self._put_counter = itertools.count(1)

        self._pool = ClientPool()
        self.head = RpcClient(head_addr)
        self.node = RpcClient(node_addr)
        # Fault-injection scope (devtools/chaos.py): chaos-plan rules
        # target this process's RPC server by role.
        self.chaos_role = "driver" if is_driver else "worker"
        from ray_tpu_torch.util import flight_recorder as _fl

        _fl.set_role(self.chaos_role, node_id=node_id)
        self._server = RpcServer(self).start()
        self.owner_addr = self._server.address

        self._key_queues: Dict[tuple, _KeyQueue] = {}
        self._lease_lock = make_lock("cluster_core._lease_lock")
        # Steady-state dispatch accounting (bench.py --scale reads this):
        # head_picks counts pick_node/pick_nodes FRAMES, block_dispatches
        # counts leases admitted node-direct against a block,
        # block_fallbacks counts block attempts that fell back to the
        # head path. Guarded by _lease_lock.
        self.dispatch_stats: Dict[str, int] = {
            "head_picks": 0, "block_grants": 0,
            "block_dispatches": 0, "block_fallbacks": 0}
        # Owner-side object locality cache: oid bytes -> (node_id, size).
        # Populated for free from task completions ("in_store" results
        # carry the sealing node) and local plasma puts; consulted by the
        # dispatch-side locality match and shipped as pick_node hints
        # (reference: the owner's LocalityData feeding the lease policy).
        import collections as _coll

        self._obj_locality: "_coll.OrderedDict" = _coll.OrderedDict()
        self._obj_loc_lock = make_lock("cluster_core._obj_loc_lock")
        self._inflight: Dict[bytes, _InflightTask] = {}  # task_id -> info
        self._inflight_lock = make_lock("cluster_core._inflight_lock")
        # task_id -> ObjectIDs passed as args: each holds a submitted-task
        # ref until the task reaches a TERMINAL state (done or failed), so
        # the caller dropping its local ObjectRef right after `.remote(ref)`
        # cannot free an argument out from under the executing worker
        # (reference: ReferenceCounter's submitted_task_ref_count).
        self._submitted_args: Dict[bytes, List[ObjectID]] = {}
        # Dependency resolution: tasks whose owned arguments are still
        # being computed wait here, not on a worker. Their last argument's
        # arrival hands them to the resolver thread, which enqueues them
        # (never from the delivering thread, which may hold _lease_lock).
        self._resolved_q: "queue.SimpleQueue" = queue.SimpleQueue()
        # task_id -> (info, pending arg ids, their get_async callback) for
        # every task still waiting on an argument; ``cancel`` takes a task
        # out of here and fails it at once.
        self._dep_waiting: Dict[bytes, tuple] = {}
        self._dep_lock = make_lock("cluster_core._dep_lock")
        self._resolver_started = False
        self._resolver_lock = make_lock("cluster_core._resolver_lock")
        # task_id -> _StreamState for in-flight streaming generators.
        self._streams: Dict[bytes, _StreamState] = {}
        self._streams_lock = make_lock("cluster_core._streams_lock")
        # (expiry, oid) transfer pins for owned refs serialized outbound;
        # swept by the push-ack loop.
        import collections as _collections

        self._transfer_pins: "_collections.deque" = _collections.deque()
        # Completed-task events awaiting the periodic flush to the head.
        self._task_event_outbox: "_collections.deque" = _collections.deque(
            maxlen=cfg.task_event_outbox_max)
        # Lineage-based recovery: creating-task specs per owned object
        # (reference: task_manager.h:265 ResubmitTask).
        from ray_tpu_torch.core.lineage import LineageStore

        self.lineage = LineageStore(cfg.max_lineage_bytes)
        self._recovering: Dict[bytes, float] = {}  # task_id -> last attempt
        self._recover_lock = make_lock("cluster_core._recover_lock")
        # Observability: recent completions ring (util.state.list_tasks).
        self._recent_tasks: "_collections.deque" = _collections.deque(
            maxlen=cfg.recent_tasks_ring)
        self._actors: Dict[ActorID, _ActorConn] = {}
        self._actors_lock = make_lock("cluster_core._actors_lock")
        # Bounded memo of RETIRED actors (dead conns dropped from
        # _actors — which otherwise grew one _ActorConn per actor ever
        # called, for the life of the driver): actor_id -> death
        # reason, so a late call on a retired actor still fails fast
        # with the real cause. Same shape/cap as the node's
        # return-lease memo.
        self._dead_actor_reasons: "_collections.OrderedDict" = \
            _collections.OrderedDict()
        self._actor_classes: Dict[ActorID, Any] = {}
        self._pgs: Dict[PlacementGroupID, PlacementGroupSpec] = {}
        # Cancelled task ids: consulted at (re)dispatch so a cancel issued
        # while the task was in flight sticks across worker-crash
        # re-enqueues. FIFO-bounded.
        import collections as _c

        self._cancelled: set = set()
        self._cancelled_order: "_c.deque" = _c.deque()
        self._shutdown_flag = False
        if cfg.metrics_report_period_ms > 0:
            threading.Thread(target=self._metrics_report_loop, daemon=True,
                             name="metrics-report").start()
        # Push-ack tracking: every push_task is an acked call collected off
        # the dispatch hot path; unacked pushes are retried (worker-side
        # task-id dedup makes retries exactly-once per worker).
        import collections

        self._push_acks = collections.deque()
        self._push_ack_event = threading.Event()
        self._borrow_buf: Dict[str, list] = {}
        self._borrow_buf_lock = make_lock("cluster_core._borrow_buf_lock")
        #: oid bytes -> owner addr for refs this process BORROWS; consulted
        #: when the borrowed ref goes out of scope so the owner can be
        #: told to drop us from its borrower set (the release half of the
        #: borrow protocol).
        self._borrowed_owners: Dict[bytes, str] = {}
        #: owner_addr -> (retry-not-before deadline, consecutive failures);
        #: keeps a dead owner from being retried inline on every ref
        #: deserialization (flushes go through the periodic sweep instead).
        self._borrow_flush_backoff: Dict[str, tuple] = {}
        # key -> generation: a re-borrow after release bumps the gen, so
        # the FIFO trim below only forgets an entry if it is still the
        # CURRENT one (a stale trim must not delete a live re-borrow's
        # tracking and silently skip its owner-side release).
        self._borrows_sent: Dict[bytes, int] = {}
        self._borrows_sent_order = _collections.deque()  # (key, gen)
        self._borrow_gen = itertools.count(1)
        # Function table (reference: _private/function_manager.py exports a
        # function ONCE to the GCS function table; tasks carry only its
        # digest). Pickling the function per submit was the tasks_async
        # bottleneck: a by-value cloudpickle both sides of every task.
        import weakref

        self._fn_exports: "weakref.WeakKeyDictionary" = (
            weakref.WeakKeyDictionary())
        self._fn_exports_lock = make_lock("cluster_core._fn_exports_lock")
        # digest -> fn, LRU-bounded: unique-lambda loops must not grow it
        # without bound; an evicted digest re-fetches from the head KV.
        import collections

        self._fn_cache: "collections.OrderedDict" = collections.OrderedDict()
        self._fn_cache_max = 4096
        # Dedicated cache lock: _fn_exports_lock spans a head kv_put RPC in
        # _export_function; cache mutation must never wait on network I/O.
        self._fn_cache_lock = make_lock("cluster_core._fn_cache_lock")
        # Object-directory notify outbox: per-put/per-release head frames
        # coalesce into one object_batch frame per flush window — N
        # concurrent writers were paying N head frames (+ head dispatch +
        # lock) per object, which serialized multi-client put throughput.
        self._obj_notify_outbox: "_collections.deque" = _collections.deque()
        self._obj_notify_event = threading.Event()
        # Single-flusher guard: shutdown's last-gasp flush racing the
        # daemon's would split an ordered add/rm pair across two frames
        # whose send order is unconstrained.
        self._obj_notify_flush_lock = make_lock("cluster_core._obj_notify_flush_lock")
        threading.Thread(target=self._obj_notify_loop, daemon=True,
                         name="obj-notify").start()
        threading.Thread(target=self._push_ack_loop, daemon=True,
                         name="push-acks").start()
        self._lease_reaper = _resdbg.track_thread(threading.Thread(
            target=self._lease_reaper_loop, daemon=True,
            name="lease-reaper"), owner=self)
        self._lease_reaper.start()

    # ------------------------------------------------------------------ refs

    def _blocked_scope(self):
        """Context manager: while a WORKER task blocks in get()/wait(), its
        lease's resources are handed back to the node so nested tasks can
        schedule (reference: CoreWorker's NotifyDirectCallTaskBlocked —
        without it, N blocked parents over N CPUs deadlock their children).
        No-op on drivers and outside task context."""
        import contextlib

        @contextlib.contextmanager
        def scope():
            active = (not self.is_driver and runtime_context
                      .current_worker_context().get("task_id") is not None)
            if active:
                try:
                    self.node.notify("worker_blocked", self.owner_addr)
                except Exception:
                    active = False
            # Worker-side execution slot: a blocked task yields its slot so
            # the next pipelined task can run (mirrors the node-side
            # resource release above; WorkerRuntime installs the hooks).
            hook = getattr(self, "_on_task_blocked", None) if active else None
            if hook is not None:
                hook()
            try:
                yield
            finally:
                if hook is not None:
                    self._on_task_unblocked()
                if active:
                    try:
                        self.node.notify("worker_unblocked", self.owner_addr)
                    except Exception:
                        pass

        return scope()

    def resolve_record(self, rec) -> Any:
        if rec.is_exception:
            raise rec.value
        if rec.in_plasma:
            return self._read_plasma(rec.value.object_id, timeout=None)
        return rec.value

    def register_ready_callback(self, oid: ObjectID, cb: Callable) -> None:
        self.memory_store.get_async(oid, cb)

    def on_ref_deserialized(self, oid: ObjectID, owner_addr: Optional[str]) -> None:
        # Borrow registration: tell the owner we hold a reference. Buffered
        # and flushed as one frame per owner (an object containing 10k refs
        # must not cost 10k notify syscalls per get); the owner-side
        # transfer pin covers the sub-second flush latency.
        if owner_addr and owner_addr != self.owner_addr:
            key = oid.binary()
            flush = None
            with self._borrow_buf_lock:
                if key in self._borrows_sent:
                    return  # owner already knows; re-gets of the same
                            # ref-bearing object must not re-notify
                gen = next(self._borrow_gen)
                self._borrows_sent[key] = gen
                self._borrows_sent_order.append((key, gen))
                self._borrowed_owners[key] = owner_addr
                while len(self._borrows_sent_order) > 200_000:
                    old, old_gen = self._borrows_sent_order.popleft()
                    if self._borrows_sent.get(old) == old_gen:
                        self._borrows_sent.pop(old, None)
                        self._borrowed_owners.pop(old, None)
                self._borrow_buf.setdefault(owner_addr, []).append(key)
                if (len(self._borrow_buf[owner_addr])
                        >= cfg.borrow_flush_batch_size
                        and not self._in_borrow_backoff(owner_addr)):
                    flush = self._borrow_buf.pop(owner_addr)
            if flush is not None:
                self._flush_borrows(owner_addr, flush)

    def _release_borrow(self, oid: ObjectID) -> None:
        """A borrowed ref went out of scope locally: tell the owner to
        drop this process from the object's borrower set (the release
        half of the borrow protocol — without it the owner pins every
        borrowed object until this process exits). Best-effort: a lost
        removal pins until then, never frees early."""
        key = oid.binary()
        with self._borrow_buf_lock:
            # Re-borrow race: a concurrent deserialization may have
            # re-acquired this oid AND dedup-skipped re-registration
            # (our maps were still populated). In that case the existing
            # registration is exactly right — keep it and send nothing,
            # or the owner would drop us while a live ref exists here.
            if self.refcount.is_in_scope(oid):
                return
            owner = self._borrowed_owners.pop(key, None)
            # Forget the dedup entry: a future re-borrow of the same
            # object must RE-register (the owner just dropped us).
            self._borrows_sent.pop(key, None)
            if owner is not None:
                buf = self._borrow_buf.get(owner)
                if buf is not None and key in buf:
                    # The registration never left this process: cancel it
                    # locally; the owner was never told.
                    buf.remove(key)
                    return
        if owner is None or self._shutdown_flag:
            return
        # Respect the per-owner backoff the registration path maintains:
        # releases to a DEAD owner must not pay an inline TCP connect
        # attempt per ref from refcount hot paths. While backed off the
        # removal is skipped (same best-effort contract: pins until this
        # process exits, never frees early).
        if self._in_borrow_backoff(owner):
            return
        try:
            self._pool.get(owner).notify("remove_borrower", key,
                                         self.owner_addr)
        except Exception:
            _prev, fails = self._borrow_flush_backoff.get(owner, (0, 0))
            fails = min(fails + 1, 10)
            self._borrow_flush_backoff[owner] = (
                time.monotonic() + min(60.0, 2.0 ** fails), fails)

    def _in_borrow_backoff(self, owner_addr: str) -> bool:
        ent = self._borrow_flush_backoff.get(owner_addr)
        return ent is not None and time.monotonic() < ent[0]

    def _flush_borrows(self, owner_addr: str, oid_blobs: list) -> None:
        try:
            self._pool.get(owner_addr).notify(
                "add_borrowers", oid_blobs, self.owner_addr)
            self._borrow_flush_backoff.pop(owner_addr, None)
        except Exception:
            # A dropped notify must not permanently skip registration (the
            # key is already in _borrows_sent, so nothing would ever retry
            # and the owner could free an object we still hold once the
            # transfer pin expires). Re-enqueue so the next sweep retries —
            # with exponential backoff and a bounded buffer, so a dead
            # owner costs neither inline RPC stalls nor unbounded memory.
            _prev, fails = self._borrow_flush_backoff.get(owner_addr, (0, 0))
            fails = min(fails + 1, 10)
            self._borrow_flush_backoff[owner_addr] = (
                time.monotonic() + min(60.0, 2.0 ** fails), fails)
            with self._borrow_buf_lock:
                buf = self._borrow_buf.setdefault(owner_addr, [])
                buf.extend(oid_blobs)
                cap = cfg.borrow_buffer_max
                if len(buf) > cap:
                    # Dropped keys must leave _borrows_sent too, else a
                    # later deserialization of the same ref would be
                    # dedup-skipped and the borrow never registered —
                    # and _borrowed_owners, else the dropped (never
                    # delivered) registration leaks its owner mapping
                    # and later sends a spurious removal.
                    for k in buf[:-cap]:
                        self._borrows_sent.pop(k, None)
                        self._borrowed_owners.pop(k, None)
                    del buf[:-cap]

    def _flush_all_borrows(self) -> None:
        with self._borrow_buf_lock:
            bufs = {a: b for a, b in self._borrow_buf.items()
                    if not self._in_borrow_backoff(a)}
            for a in bufs:
                del self._borrow_buf[a]
        for owner_addr, oid_blobs in bufs.items():
            self._flush_borrows(owner_addr, oid_blobs)

    def pin_for_transfer(self, oid: ObjectID,
                         owner_addr: Optional[str]) -> None:
        """Owner-side: an owned ref is being serialized into an outbound
        message. Hold a local ref for `transfer_pin_ttl_s` so the value
        survives until the receiver's add_borrower registration lands
        (simplified form of the reference's in-flight borrow accounting;
        the TTL bounds the leak if the message or registration is lost)."""
        if owner_addr is not None and owner_addr != self.owner_addr:
            return
        self.refcount.add_local_ref(oid)
        self._transfer_pins.append(
            (time.monotonic() + cfg.transfer_pin_ttl_s, oid))

    def _sweep_transfer_pins(self) -> None:
        if self._borrow_buf:
            self._flush_all_borrows()
        now = time.monotonic()
        while self._transfer_pins and self._transfer_pins[0][0] <= now:
            _, oid = self._transfer_pins.popleft()
            self.refcount.remove_local_ref(oid)
        # Finalizer-queued decrements apply here even when the process is
        # otherwise idle (ObjectRef.__del__ can only enqueue).
        self.refcount.flush_deferred()

    # ---------------------------------------------- object notify batching

    def _queue_object_notify(self, kind: str, oid_bytes: bytes,
                             size=None) -> None:
        """Queue an object_added/object_removed for the batched flush.
        Order within the outbox is preserved, so an add followed by a
        remove of the same object lands in the right order at the head."""
        self._obj_notify_outbox.append((kind, oid_bytes, size))
        self._obj_notify_event.set()

    def _obj_notify_loop(self) -> None:
        window = cfg.object_notify_flush_ms / 1000.0
        while not self._shutdown_flag:
            self._obj_notify_event.wait(0.5)
            # Clear BEFORE the emptiness check: an append that raced the
            # previous flush re-set the event with an already-drained
            # outbox, and clearing only on the non-empty path would turn
            # this loop into a busy spin. An append after this clear
            # re-sets the event, so nothing is lost.
            self._obj_notify_event.clear()
            if not self._obj_notify_outbox:
                continue
            if window > 0:
                time.sleep(window)  # coalesce the burst behind one frame
            self._flush_object_notifies()

    def _flush_object_notifies(self) -> None:
        # One flusher at a time: drain AND send under the lock so two
        # racing flushes can't send an oid's add and rm out of order.
        with self._obj_notify_flush_lock:
            outbox = self._obj_notify_outbox
            while outbox:
                batch = []
                while outbox and len(batch) < 4096:
                    try:
                        batch.append(outbox.popleft())
                    except IndexError:
                        break
                if not batch:
                    return
                try:
                    # Via the LOCAL node manager, not the head directly:
                    # the node mirrors its own holder set from these
                    # frames and forwards them, so a restarted head can
                    # be rehydrated by the node (see NodeManager.
                    # _on_head_reregistered). Same best-effort contract.
                    if _rpcdbg.enabled():
                        # RTPU_DEBUG_RPC: per-sender sequence stamp so
                        # the node can assert no frame reordering /
                        # re-delivery (add/rm inversion witness).
                        batch = _rpcdbg.stamp_outbox(self.owner_addr,
                                                     batch)
                    self.node.notify("object_batch", batch)
                except Exception:
                    return  # best-effort, like the old per-object notifies

    # ------------------------------------------------------ object locality

    def _note_object_location(self, oid_bytes: bytes, node_id: Optional[str],
                              size) -> None:
        if not node_id:
            return
        with self._obj_loc_lock:
            self._obj_locality[oid_bytes] = (node_id, int(size or 0))
            self._obj_locality.move_to_end(oid_bytes)
            while len(self._obj_locality) > cfg.object_locality_cache_max:
                self._obj_locality.popitem(last=False)

    def _preferred_node(self, info: "_InflightTask") -> Optional[str]:
        """The node holding the plurality of this task's input bytes per
        the local locality cache; None when no input location is known.
        Memoized on the task once resolved (a None answer is retried —
        completions may land locations after the first dispatch look)."""
        arg_ids = info.arg_ids
        if not arg_ids:
            return None
        if info.pref_node is not False:
            return info.pref_node
        best_node = None
        best_bytes = 0
        per_node: Dict[str, int] = {}
        with self._obj_loc_lock:
            for oid in arg_ids:
                ent = self._obj_locality.get(oid.binary())
                if ent is None:
                    continue
                node_id, size = ent
                b = per_node.get(node_id, 0) + (size or 1)
                per_node[node_id] = b
                if b > best_bytes:
                    best_node, best_bytes = node_id, b
        if best_node is not None:
            info.pref_node = best_node
        return best_node

    def _release_object(self, oid: ObjectID) -> None:
        memory_only = self.memory_store.delete([oid])
        if memory_only:
            # Small inlined result: it never touched the shm store — skip
            # the C delete + spill-unlink syscalls (per-task-return hot
            # path; the shm attempt was ~1/4 of release cost).
            return
        with self._obj_loc_lock:
            self._obj_locality.pop(oid.binary(), None)
        if self.store.delete(oid):
            _resdbg.note_event("store_delete")
            self._queue_object_notify("rm", oid.binary())

    # ------------------------------------------------------------------ put/get

    def put(self, value: Any, _owner=None, inline_ok: bool = True
            ) -> ObjectRef:
        """``inline_ok=False`` forces the shm store even for small
        values: inlined objects live in the OWNER's memory store and die
        with it, while store-backed objects survive on the node — the
        contract long-lived data-plane producers (streaming Dataset
        operator actors) need so their outputs outlive the actor."""
        oid = ObjectID.for_put(self.current_task_id(), next(self._put_counter))
        self.refcount.add_owned_object(oid)
        if isinstance(value, TaskError):
            self.memory_store.put(oid, value, is_exception=True)
            return ObjectRef(oid, self.owner_addr)
        header, buffers = SERIALIZER.serialize(value)
        total = SERIALIZER.encode_total_size(header, buffers)
        if inline_ok and total <= cfg.object_store_inline_max_bytes:
            self.memory_store.put(oid, value)
        else:
            self._put_plasma(oid, header, buffers)
            self.memory_store.put(oid, PlasmaStub(oid))
            self._note_object_location(oid.binary(), self.node_id, total)
        _metrics.OBJECTS_PUT.inc()
        _metrics.PUT_BYTES.inc(total)
        return ObjectRef(oid, self.owner_addr)

    def _put_plasma(self, oid: ObjectID, header: bytes, buffers) -> None:
        total = SERIALIZER.encode_total_size(header, buffers)
        deadline = time.monotonic() + cfg.put_create_retry_deadline_s
        takeover_at = time.monotonic() + 5.0
        while True:
            try:
                mv = self.store.create_buffer(oid, total)
                break
            except ShmObjectExistsError:
                # A concurrent writer (a re-routed duplicate execution on
                # another worker) holds the slot. Returning immediately
                # here minted GHOST objects: if that writer later ABORTS
                # (store pressure, crash), its unsealed copy vanishes
                # while our completion already told the owner "in_store".
                # Wait for the other copy to SEAL; if it disappears
                # instead, take over and write it ourselves.
                buf = self.store.get(oid, timeout_ms=200)
                if buf is not None:
                    buf.release()
                    return  # sealed by the other writer — done
                if not self.store.contains(oid):
                    if time.monotonic() > takeover_at:
                        # Unsealed for seconds: if the slot is a PENDING
                        # placeholder, its creator died mid-create (a
                        # live create's pending window is milliseconds)
                        # and nothing else can ever clear it. Reclaim
                        # touches only pending slots — a live writer
                        # mid-write keeps its buffer and we keep waiting.
                        self.store.reclaim_pending(oid)
                        takeover_at = time.monotonic() + 5.0
                    continue  # aborted/reclaimed: retry the create
                if time.monotonic() > deadline:
                    raise
        try:
            SERIALIZER.encode_into(mv, header, buffers)
        except BaseException:
            self.store.abort(oid)
            raise
        self.store.seal(oid)
        _resdbg.note_event("store_seal")
        self._queue_object_notify("add", oid.binary(), total)

    def _read_plasma(self, oid: ObjectID, timeout: Optional[float],
                     owner: Optional[str] = None) -> Any:
        buf = self.store.get(oid, timeout_ms=0)
        if buf is None:
            # Not local: ask the node manager to pull it here. Short pull
            # rounds (idempotent) rather than one long blocking RPC, so a
            # chaos-dropped request costs seconds, not the whole timeout.
            deadline = time.monotonic() + (timeout if timeout is not None
                                           else 600.0)
            ok = False
            failed_pulls = 0
            pull_trace = None
            if cfg.tracing_enabled:
                # Parent the node-side pull to the requesting task's span.
                from ray_tpu_torch.util import tracing as _tr

                pull_trace = _tr.current()
            with self._blocked_scope():
                while not ok and time.monotonic() < deadline:
                    try:
                        ok = bool(self.node.call("pull_object", oid.binary(),
                                                 5000, pull_trace,
                                                 timeout=8))
                    except ConnectionLost:
                        # Dead socket fails instantly — back off + reconnect
                        # or this loop becomes a hot spin for the full
                        # deadline.
                        time.sleep(0.2)
                        try:
                            self.node.reconnect()
                        except OSError:
                            pass
                        ok = False
                    except TimeoutError:
                        ok = False
                    if not ok and self.store.contains(oid):
                        ok = True
                    if not ok:
                        failed_pulls += 1
                        if failed_pulls >= 2:
                            # Every copy is likely gone (node death):
                            # lineage recovery — owner resubmits the
                            # creating task; borrowers ask the owner to.
                            self._request_recovery(oid, owner)
            if not ok:
                raise GetTimeoutError(f"object {oid.hex()} unavailable")
            buf = self.store.get(oid, timeout_ms=5000)
            while buf is None and time.monotonic() < deadline:
                # Present a moment ago but the read missed: a restore from
                # spill can fail transiently while concurrent readers pin
                # the arena (out-of-core exchanges run at exactly this
                # pressure). Back off briefly and retry within the
                # deadline instead of failing the task.
                time.sleep(cfg.object_poll_interval_s)
                buf = self.store.get(oid, timeout_ms=5000)
            if buf is None:
                raise GetTimeoutError(f"object {oid.hex()} unavailable")
        # Zero-copy decode: views are taken over memoryview(buf), whose
        # exporter is the PinnedBuffer itself — every deserialized numpy
        # array transitively keeps the pin alive, so LRU eviction can never
        # reuse the arena block under live user data. The pin drops when the
        # last view is garbage-collected (PinnedBuffer.__buffer__).
        try:
            view = memoryview(buf)
        except TypeError:
            # Python < 3.12 has no PEP 688 __buffer__ hook, so PinnedBuffer
            # cannot export: decode from a COPY and release the pin now.
            # Correctness over zero-copy — without an exporter tie, LRU
            # eviction could reuse the arena under live views.
            data = bytes(buf.buffer)
            buf.release()
            return SERIALIZER.decode(memoryview(data))
        return SERIALIZER.decode(view)

    def get(self, refs, timeout: Optional[float] = None):
        single = isinstance(refs, ObjectRef)
        ref_list = [refs] if single else list(refs)
        for r in ref_list:
            if not isinstance(r, ObjectRef):
                raise TypeError(f"get() expects ObjectRef, got {type(r).__name__}")
        # Batch fast path: every ref owned locally -> ONE memory-store wait
        # for the whole list (per-ref lock/scope round-trips dominated
        # large fan-in gets).
        if len(ref_list) > 1 and all(
                r.owner_address is None or r.owner_address == self.owner_addr
                for r in ref_list):
            oids = [r.id() for r in ref_list]
            try:
                recs = self.memory_store.get(oids, 0)
            except GetTimeoutError:
                with self._blocked_scope():
                    recs = self.memory_store.get(oids, timeout)
            return [self.resolve_record(rec) for rec in recs]
        out = []
        deadline = None if timeout is None else time.monotonic() + timeout
        for r in ref_list:
            remaining = (None if deadline is None
                         else max(0.0, deadline - time.monotonic()))
            out.append(self._get_one(r, remaining))
        return out[0] if single else out

    def _get_one(self, ref: ObjectRef, timeout: Optional[float]) -> Any:
        oid = ref.id()
        owner = ref.owner_address
        if owner is None or owner == self.owner_addr:
            if self.memory_store.contains(oid):  # fast path: no RPCs
                recs = self.memory_store.get([oid], 0)
            else:
                with self._blocked_scope():
                    recs = self.memory_store.get([oid], timeout)
            return self.resolve_record(recs[0])
        # Borrowed ref: if the bytes are already in the local shm store (or
        # pullable), prefer that; else ask the owner. Short poll rounds: a
        # chaos-dropped request/reply is retried instead of failing the get.
        if self.store.contains(oid):
            return self._read_plasma(oid, timeout)
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        with self._blocked_scope():
            return self._get_borrowed(ref, oid, owner, deadline, timeout)

    def _get_borrowed(self, ref: ObjectRef, oid: ObjectID, owner: str,
                      deadline: Optional[float],
                      timeout: Optional[float]) -> Any:
        while True:
            t = 10.0 if deadline is None else min(
                10.0, deadline - time.monotonic())
            if t <= 0:
                raise GetTimeoutError(f"timed out waiting for {oid.hex()}")
            try:
                kind, payload = self._pool.get(owner).call(
                    "get_object", oid.binary(), t, timeout=t + 5)
            except ConnectionLost:
                raise WorkerCrashedError(
                    f"owner of {oid.hex()} died") from None
            except TimeoutError:
                continue  # dropped in transit; owner-side get is idempotent
            if kind == "timeout":
                continue  # not ready yet; loop until our own deadline
            break
        if kind == "value":
            return SERIALIZER.decode(payload)
        if kind == "error":
            raise payload
        if kind == "in_store":
            return self._read_plasma(oid, timeout, owner=owner)
        raise RuntimeError(f"unexpected get_object reply {kind}")

    def wait(self, refs: List[ObjectRef], num_returns: int = 1,
             timeout: Optional[float] = None, fetch_local: bool = True):
        """Event-driven wait: owned refs register memory-store callbacks;
        borrowed refs long-poll their owner (one `wait_object` RPC per ref,
        not a poll-per-tick storm — the reference's Wait is likewise
        subscription-based, core_worker.h:682)."""
        # ONE pass extracts ids, checks uniqueness, and detects borrowed
        # refs (this runs per call in pop-1-of-1k wait loops — every extra
        # pass over `refs` multiplies into O(n^2) drain cost; fusing the
        # id/uniqueness/ownership passes measurably moves the
        # wait_1k_refs benchmark row).
        my_addr = self.owner_addr
        oids = []
        seen: set = set()
        all_owned = True
        hits: List[int] = []  # indices of already-ready refs (fast path)
        objs = self.memory_store.objects_view()
        need = num_returns
        for i, r in enumerate(refs):
            oid = r._id
            oids.append(oid)
            if oid in seen:
                raise ValueError("wait() requires unique object refs")
            seen.add(oid)
            oa = r._owner_addr
            if oa is not None and oa != my_addr:
                all_owned = False
            elif len(hits) < need and oid in objs:
                # Readiness probe rides the same pass (dict membership is
                # GIL-atomic; values are never read here).
                hits.append(i)
        # Fast path: enough refs already resolved locally -> C-speed list
        # partition, zero callback registration/removal churn.
        if all_owned and len(hits) >= need:
            not_ready = list(refs)
            ready = [not_ready.pop(i) for i in reversed(hits)]
            ready.reverse()
            return ready, not_ready
        if all_owned:
            # All-local waits ride the store's condvar directly (the
            # put_batch wakeup) — zero per-ref callback churn.
            with self._blocked_scope():
                ready_now = self.memory_store.wait(
                    oids, num_returns, timeout)
            ready, not_ready = [], []
            n_ready = 0
            for r, oid in zip(refs, oids):
                if oid in ready_now and n_ready < num_returns:
                    ready.append(r)
                    n_ready += 1
                else:
                    not_ready.append(r)
            return ready, not_ready
        deadline = None if timeout is None else time.monotonic() + timeout
        cv = threading.Condition()
        ready_ids: set = set()
        waiting = True

        def mark(oid: ObjectID) -> None:
            with cv:
                ready_ids.add(oid)
                cv.notify_all()

        registered: List[Tuple[ObjectID, Any]] = []
        remote_by_owner: Dict[str, List[ObjectID]] = {}
        for r in refs:
            oid = r.id()
            if r.owner_address in (None, self.owner_addr):
                cb = lambda rec, o=oid: mark(o)  # noqa: E731
                self.memory_store.get_async(oid, cb)
                registered.append((oid, cb))
            elif self.store.contains(oid):
                mark(oid)
            else:
                remote_by_owner.setdefault(r.owner_address, []).append(oid)
        for owner, oids in remote_by_owner.items():
            # One long-poll thread per OWNER covering all its refs (not one
            # per ref): a wait over 1k refs costs O(owners) RPCs per poll.
            threading.Thread(
                target=self._wait_remote_loop,
                args=(owner, oids, deadline, mark, lambda: waiting),
                daemon=True, name="wait-remote").start()
        try:
            with self._blocked_scope(), cv:
                while len(ready_ids) < num_returns:
                    remaining = (None if deadline is None
                                 else deadline - time.monotonic())
                    if remaining is not None and remaining <= 0:
                        break
                    cv.wait(remaining)
                snapshot = set(ready_ids)
        finally:
            waiting = False
            for oid, cb in registered:
                self.memory_store.remove_callback(oid, cb)
        ready, not_ready = [], []
        for r in refs:
            (ready if r.id() in snapshot and len(ready) < num_returns
             else not_ready).append(r)
        return ready, not_ready

    def _wait_remote_loop(self, owner: str, oids: List[ObjectID],
                          deadline: Optional[float], mark,
                          still_waiting) -> None:
        pending = set(oids)
        while still_waiting() and pending:
            for oid in [o for o in pending if self.store.contains(o)]:
                mark(oid)
                pending.discard(oid)
            if not pending:
                return
            remaining = (None if deadline is None
                         else deadline - time.monotonic())
            if remaining is not None and remaining <= 0:
                return
            # Short poll chunks keep orphaned threads (wait() returned early)
            # from pinning an owner-side handler thread for long.
            poll = 5.0 if remaining is None else min(remaining, 5.0)
            try:
                ready = self._pool.get(owner).call(
                    "wait_objects", [o.binary() for o in pending], poll,
                    timeout=poll + 5)
                for ob in ready:
                    oid = ObjectID(ob)
                    mark(oid)
                    pending.discard(oid)
            except Exception:
                time.sleep(cfg.object_poll_interval_s)

    # --------------------------------------------------------- recovery

    def _request_recovery(self, oid: ObjectID, owner: Optional[str]) -> None:
        """Trigger re-creation of a lost object: locally if we own it,
        else by asking the owner (which has the lineage)."""
        if owner is None or owner == self.owner_addr:
            self._maybe_recover_object(oid)
            return
        try:
            self._pool.get(owner).notify("recover_object", oid.binary())
        except Exception:
            pass

    def rpc_recover_object(self, conn, oid_bytes: bytes):
        """Borrower-initiated recovery request for an object I own."""
        self._maybe_recover_object(ObjectID(oid_bytes))
        return True

    def _maybe_recover_object(self, oid: ObjectID, _depth: int = 0) -> bool:
        """Resubmit the creating task of a lost owned object (transitively
        for its lost arguments). Rate-limited per task; returns True if a
        resubmission happened or is already underway."""
        if _depth > 16:
            return False
        found = self.lineage.for_object(oid)
        if found is None:
            return False
        # Confirm the object is actually LOST (no live location) before
        # re-executing: transient pull failures against a slow-but-alive
        # holder must not duplicate a side-effecting task.
        if _depth == 0 and self._object_available(oid):
            return False
        task_key, rec = found
        now = time.monotonic()
        with self._recover_lock:
            last = self._recovering.get(task_key, 0.0)
            if now - last < 30.0:
                return True  # a recovery attempt is already in flight
            self._recovering[task_key] = now
            # Bounded memory: drop stale entries opportunistically.
            if len(self._recovering) > cfg.recovering_ids_max:
                cutoff = now - 300.0
                self._recovering = {k: v for k, v in
                                    self._recovering.items() if v > cutoff}
        # Recursive step: re-create lost owned args FIRST, so the
        # resubmitted task's fetches can succeed (reference:
        # object_recovery_manager.h pinning-or-reconstruct walk).
        for arg in rec.arg_ids:
            if not self._object_available(arg):
                self._maybe_recover_object(arg, _depth + 1)
        # Fresh task id: worker-side exactly-once dedup must not swallow
        # the resubmission (the original id may have executed anywhere).
        spec = SERIALIZER.decode(rec.spec_blob)
        new_task_id = TaskID.for_task(ActorID.nil_for_job(self.job_id))
        spec["task_id"] = new_task_id.binary()
        new_blob = SERIALIZER.encode(spec)
        info = _InflightTask(new_blob, rec.return_ids, None, 0,
                             rec.sched_key, rec.resources, rec.strategy,
                             rec.name + "[recovery]",
                             getattr(rec, "runtime_env", None))
        info.arg_ids = list(rec.arg_ids)
        # Re-point the lineage mapping at the new spec so a SECOND loss
        # recovers from the resubmitted task, and re-protect the args.
        from ray_tpu_torch.core.lineage import LineageRecord

        self.lineage.record(new_task_id.binary(), LineageRecord(
            new_blob, rec.sched_key, rec.resources, rec.strategy, rec.name,
            rec.return_ids, rec.arg_ids,
            runtime_env=getattr(rec, "runtime_env", None)))
        for arg in rec.arg_ids:
            self.refcount.add_submitted_task_ref(arg)
        with self._inflight_lock:
            self._submitted_args[new_task_id.binary()] = list(rec.arg_ids)
        self._enqueue_task(new_task_id.binary(), info)
        return True

    def _object_available(self, oid: ObjectID) -> bool:
        """Is an owned object's value still reachable somewhere?"""
        if self.store.contains(oid):
            return True
        if self.memory_store.contains(oid):
            recs = self.memory_store.get([oid], 0)
            if not recs[0].in_plasma:
                return True  # inline value lives in the owner itself
            try:
                locs = self.head.call("object_locations", oid.binary(),
                                      timeout=5)
            except Exception:
                return True  # can't tell; assume fine (pull will retry)
            return bool(locs)
        return False

    # -------------------------------------------------------------- owner RPC

    @blocking_rpc
    def rpc_get_object(self, conn, oid_bytes: bytes, timeout: float):
        """Serve a get() for an object I own. timeout=0 is a non-blocking
        readiness probe; only timeout=None blocks indefinitely."""
        oid = ObjectID(oid_bytes)
        try:
            recs = self.memory_store.get(
                [oid], None if timeout is None else timeout)
        except GetTimeoutError:
            return "timeout", None
        rec = recs[0]
        if rec.is_exception:
            return "error", rec.value
        if rec.in_plasma:
            return "in_store", None
        return "value", SERIALIZER.encode(rec.value)

    @blocking_rpc
    def rpc_wait_object(self, conn, oid_bytes: bytes, timeout: float):
        """Long-poll readiness probe for an object I own (serves remote
        wait()); never ships the value."""
        try:
            self.memory_store.get([ObjectID(oid_bytes)], timeout)
            return True
        except GetTimeoutError:
            return False

    @blocking_rpc
    def rpc_wait_objects(self, conn, oid_bytes_list: List[bytes],
                         timeout: float):
        """Batched long-poll: returns the (possibly empty) subset of the
        given owned objects that are ready, blocking until at least one is
        or the timeout lapses."""
        oids = [ObjectID(b) for b in oid_bytes_list]
        ready = self.memory_store.wait(oids, 1, timeout, return_all=True)
        return [o.binary() for o in ready]

    def rpc_add_borrowers(self, conn, oid_blobs: list, borrower: str):
        for oid_bytes in oid_blobs:
            self.refcount.add_borrower(ObjectID(oid_bytes), borrower)
        return True

    def rpc_remove_borrower(self, conn, oid_bytes: bytes, borrower: str):
        self.refcount.remove_borrower(ObjectID(oid_bytes), borrower)
        return True

    def _register_submitted_args(self, task_id_bytes: bytes, args,
                                 kwargs) -> List[ObjectID]:
        oids: List[ObjectID] = []
        _scan_object_refs((args, kwargs), oids)
        if not oids:
            return oids
        for oid in oids:
            self.refcount.add_submitted_task_ref(oid)
        with self._inflight_lock:
            self._submitted_args[task_id_bytes] = oids
        return oids

    def _release_submitted_args(self, task_id_bytes: bytes) -> None:
        with self._inflight_lock:
            oids = self._submitted_args.pop(task_id_bytes, None)
        for oid in oids or ():
            self.refcount.remove_submitted_task_ref(oid)

    def _complete_task(self, task_id_bytes: bytes,
                       results: List[Tuple[bytes, str, Any]],
                       span, puts: list) -> None:
        """Shared completion bookkeeping; value deliveries are appended to
        ``puts`` so batched completions land in ONE memory-store pass."""
        with self._inflight_lock:
            info = self._inflight.pop(task_id_bytes, None)
        self._release_submitted_args(task_id_bytes)
        status = ("error" if any(k == "error" for _o, k, _p in results)
                  else "ok")
        if span is not None:
            t0, t1, name = span
            _timeline.record_event(name, "task", t0, t1,
                                   args={"task_id": task_id_bytes.hex()[:12],
                                         "status": status})
            _metrics.TASKS_FINISHED.inc()
            _metrics.TASK_EXEC_SECONDS.observe(max(0.0, t1 - t0))
            event = {
                "task_id": task_id_bytes.hex(), "name": name,
                "duration_s": round(t1 - t0, 6), "status": status,
                "end_ts": t1}
            self._recent_tasks.append(event)
            # Cluster-wide visibility: events flush to the head in the
            # periodic sweep (reference: TaskEventBuffer -> GcsTaskManager,
            # gcs_task_manager.h:86 — list_tasks from ANY driver must see
            # EVERY owner's tasks, not just its own).
            self._task_event_outbox.append(event)
        for oid_bytes, kind, payload in results:
            oid = ObjectID(oid_bytes)
            if kind == "value":
                puts.append((oid, SERIALIZER.decode(payload), False))
            elif kind == "error":
                puts.append((oid, payload, True))
            else:
                # "in_store" payloads carry (node_id, size) of the sealed
                # copy: free locality data for downstream scheduling.
                if isinstance(payload, (tuple, list)) and len(payload) == 2:
                    self._note_object_location(oid_bytes, payload[0],
                                               payload[1])
                puts.append((oid, PlasmaStub(oid), False))
        if info is not None:
            self._lease_task_finished(
                info.sched_key, info.worker_addr,
                max(0.0, span[1] - span[0]) if span is not None else None)

    def rpc_task_done(self, conn, task_id_bytes: bytes,
                      results: List[Tuple[bytes, str, Any]],
                      span: Optional[Tuple[float, float, str]] = None):
        """Completion push from the executing worker.
        results: [(oid_bytes, kind, payload)] kind in value|error|in_store;
        span: (exec_start, exec_end, name) for timeline/metrics."""
        puts: list = []
        self._complete_task(task_id_bytes, results, span, puts)
        self.memory_store.put_batch(puts)
        return True

    def rpc_batch_done(self, conn_ctx, entries):
        """Batched completion sink: each entry is ("task"|"actor", args)
        routed to the idempotent per-completion handlers. Records per-entry
        event stats under the routed method name so state.rpc_event_stats()
        accounting stays identical to the unbatched path."""
        from ray_tpu_torch.cluster import protocol

        stats_on = protocol._stats_on()
        puts: list = []
        notifies: list = []
        try:
            for kind, payload in entries:
                method = "actor_call_done" if kind == "actor" else "task_done"
                t0 = time.monotonic() if stats_on else 0.0
                ok = True
                try:
                    if kind == "actor":
                        (actor_id_bytes, seq, task_id_bytes,
                         results, span) = payload
                        aconn = self._actor_conn(ActorID(actor_id_bytes))
                        with aconn.lock:
                            aconn.pending.pop(seq, None)
                        self._complete_task(task_id_bytes, results, span,
                                            puts)
                    elif kind == "stream":
                        self._handle_stream_item(payload[0], payload[1],
                                                 payload[2], puts,
                                                 notifies)
                    elif kind == "stream_end":
                        self._handle_stream_end(payload[0], payload[1],
                                                payload[2], payload[3],
                                                puts, notifies)
                    else:
                        self._complete_task(payload[0], payload[1],
                                            payload[2] if len(payload) > 2
                                            else None, puts)
                except Exception:
                    ok = False
                    raise
                finally:
                    if stats_on:
                        protocol._record_event_stat(
                            method, time.monotonic() - t0, ok)
        finally:
            # A poison entry must not discard the completed entries'
            # results: their inflight/lease bookkeeping already ran, and
            # dropping the values would strand their owners in get().
            self.memory_store.put_batch(puts)
            # Stream consumers wake only after their objects are gettable.
            self._fire_stream_notifies(notifies)
        return True

    def rpc_ping(self, conn):
        return "pong"

    def rpc_clock_probe(self, conn):
        return time.time()

    def _metrics_report_loop(self) -> None:
        """Publish this process's metric registry to the head KV every
        ``metrics_report_period_ms`` (reference: per-node metrics agents
        pushing to Prometheus). A registry with no sample yet, or
        unchanged since the last publish, is not sent."""
        from ray_tpu_torch.util import metrics as _m

        period = cfg.metrics_report_period_ms / 1000.0
        last = None
        while not self._shutdown_flag:
            time.sleep(period)
            if not _m.has_samples():
                continue
            text = _m.prometheus_text()
            if text == last:
                continue
            try:
                self.publish_metrics(text)
                last = text
            except Exception:
                pass

    def publish_metrics(self, text: Optional[str] = None) -> None:
        """Write this process's registry (``text``, default: rendered
        now) to the head KV: the driver as ``metrics/<node>``, as
        ``ray_tpu``'s does; a worker as ``metrics/<node>/<pid>``, so a
        replica's engine counters reach the head too."""
        import os

        from ray_tpu_torch.util import metrics as _m

        key = f"metrics/{self.node_id[:12]}"
        if not self.is_driver:
            key += f"/{os.getpid()}"
        if text is None:
            text = _m.prometheus_text()
        self.head.retrying_call("kv_put", "default", key.encode(),
                                text.encode(), True, timeout=10)

    def rpc_dump_flight(self, conn):
        """This process's flight-recorder ring (drivers/workers serve it
        too — trace_dump and post-mortems read any process)."""
        from ray_tpu_torch.util import flight_recorder as _fl

        payload = _fl.dump_payload()
        payload["node_id"] = self.node_id
        return payload

    # ------------------------------------------------------------------ tasks

    def current_task_id(self) -> TaskID:
        ctx = runtime_context.current_worker_context()
        return ctx.get("task_id") or self._driver_task_id

    def current_actor_id(self) -> Optional[ActorID]:
        return runtime_context.current_worker_context().get("actor_id")

    def current_resources(self) -> Dict[str, float]:
        return runtime_context.current_worker_context().get("resources", {})

    def _export_function(self, func: Callable) -> bytes:
        """Export ``func`` to the head's function table once; return its
        digest. Subsequent submits of the same function object reuse the
        cached digest, so the per-task cost is a dict lookup instead of a
        cloudpickle round.

        Export-once semantics (matches the reference function manager,
        python/ray/_private/function_manager.py): the snapshot taken at
        first submit is what executes — mutating captured closure state
        after the first ``.remote()`` does NOT re-export. Create a new
        function object (or a fresh ``.options()``-bound task) to ship new
        state. The local digest cache is LRU-bounded (``_fn_cache``) so
        unique-lambda loops don't grow it without bound; the head-side
        ``__fn__`` KV namespace is job-scoped and dropped with the job."""
        try:
            digest = self._fn_exports.get(func)
        except TypeError:  # unhashable/unweakrefable callable
            digest = None
        if digest is not None:
            return digest
        import hashlib

        blob = SERIALIZER.encode(func)
        digest = hashlib.sha1(blob).digest()
        with self._fn_exports_lock:
            if digest not in self._fn_cache:
                # Export lock spans the kv_put BY DESIGN: it single-
                # flights concurrent exports of one function (dedup) and
                # is never taken on the dispatch/cache hot path (that is
                # what _fn_cache_lock is for).
                self.head.retrying_call("kv_put", "__fn__", digest, blob,  # rtpu-lint: disable=blocking-under-lock
                                        False, timeout=10)
                self._fn_cache_put(digest, func)
        try:
            self._fn_exports[func] = digest
        except TypeError:
            pass
        return digest

    def _fn_cache_put(self, digest: bytes, fn: Callable) -> None:
        with self._fn_cache_lock:
            self._fn_cache[digest] = fn
            self._fn_cache.move_to_end(digest)
            while len(self._fn_cache) > self._fn_cache_max:
                self._fn_cache.popitem(last=False)

    def _fetch_function(self, digest: bytes) -> Callable:
        """Resolve a task's function digest via the local cache, falling
        back to one head KV fetch per (process, function)."""
        with self._fn_cache_lock:
            fn = self._fn_cache.get(digest)
            if fn is not None:
                self._fn_cache.move_to_end(digest)
                return fn
        blob = self.head.retrying_call("kv_get", "__fn__", digest,
                                       timeout=10)
        if blob is None:
            raise RuntimeError(
                "function table entry missing (head lost its KV state?)")
        fn = SERIALIZER.decode(blob)
        self._fn_cache_put(digest, fn)
        return fn

    def submit_task(self, func: Callable, args: Sequence, kwargs: Dict,
                    num_returns: int = 1, resources=None, max_retries: int = 0,
                    retry_exceptions: bool = False, scheduling_strategy=None,
                    name: str = "", runtime_env=None) -> List[ObjectRef]:
        tmpl = self.make_submit_template(
            func, num_returns=num_returns, resources=resources,
            max_retries=max_retries, retry_exceptions=retry_exceptions,
            scheduling_strategy=scheduling_strategy, name=name,
            runtime_env=runtime_env)
        return self.submit_templated(tmpl, args, kwargs)

    def make_submit_template(self, func: Callable, *, num_returns: int = 1,
                             resources=None, max_retries: int = 0,
                             retry_exceptions: bool = False,
                             scheduling_strategy=None, name: str = "",
                             runtime_env=None,
                             generator_backpressure_num_objects=None
                             ) -> "_SubmitTemplate":
        """Precompute everything about a submission that does not vary per
        call (reference analog: the per-SchedulingKey caching inside
        NormalTaskSubmitter). ``RemoteFunction`` caches the result, so the
        ``f.remote()`` hot loop skips option normalization, strategy/
        sched-key construction and the constant spec fields entirely."""
        from ray_tpu_torch.core.runtime_env import (runtime_env_hash,
                                              validate_runtime_env)

        runtime_env = validate_runtime_env(runtime_env)
        # Only a task that names no resources at all costs the default
        # CPU, as for actors (create_actor): the caller's own default
        # (``remote_function._task_resources``) already adds CPU 1 when
        # num_cpus is not given, and ResourceSet drops zero amounts, so
        # a missing CPU here is an explicit num_cpus=0 and leases none.
        res = ({"CPU": 1.0} if resources is None
               else _as_resource_dict(resources))
        strategy = _strategy_dict(scheduling_strategy)
        task_name = name or getattr(func, "__name__", "task")
        spread = bool(strategy and strategy.get("kind") == "spread")
        streaming = num_returns == "streaming"
        if streaming:
            num_returns = 0
        sched_key = None
        if not spread:
            sched_key = _sched_key(func, res, strategy)
            if runtime_env is not None:
                # Distinct envs must never share leases/workers.
                sched_key = sched_key + (runtime_env_hash(runtime_env),)
        spec_proto = {
            "task_id": b"",
            "func_digest": self._export_function(func),
            "args": (),
            "kwargs": {},
            "return_ids": (),
            "owner_addr": self.owner_addr,
            "name": task_name,
            "resources": res,
            "retry_exceptions": retry_exceptions,
            "max_retries": max_retries,
        }
        if streaming:
            spec_proto["streaming"] = True
            if generator_backpressure_num_objects is not None:
                spec_proto["stream_ahead"] = int(
                    generator_backpressure_num_objects)
        return _SubmitTemplate(
            func, num_returns, res, strategy, task_name, sched_key, spread,
            max_retries if retry_exceptions else 0, runtime_env,
            runtime_env_hash(runtime_env) if runtime_env is not None
            else None, spec_proto, streaming)

    def submit_templated(self, tmpl: "_SubmitTemplate", args: Sequence,
                         kwargs: Dict) -> List[ObjectRef]:
        task_id = TaskID.for_task(self._nil_actor)
        task_id_bytes = task_id.binary()
        return_ids = [ObjectID.for_task_return(task_id, i)
                      for i in range(tmpl.num_returns)]
        for oid in return_ids:
            self.refcount.add_owned_object(oid)
        refs = [ObjectRef(oid, self.owner_addr) for oid in return_ids]

        spec = dict(tmpl.spec_proto)
        spec["task_id"] = task_id_bytes
        spec["args"] = tuple(args)
        spec["kwargs"] = dict(kwargs)
        spec["return_ids"] = [o.binary() for o in return_ids]
        trace_ctx = None
        t_submit = 0.0
        if cfg.tracing_enabled:
            from ray_tpu_torch.util import tracing

            t_submit = time.time()
            ctx = tracing.current()
            if ctx is not None:
                spec["trace"] = ctx
                trace_ctx = ctx
        spec_blob = SERIALIZER.encode(spec)
        if tmpl.spread:
            sched_key = _sched_key(tmpl.func, tmpl.resources, tmpl.strategy)
            if tmpl.env_hash is not None:
                sched_key = sched_key + (tmpl.env_hash,)
        else:
            sched_key = tmpl.sched_key
        info = _InflightTask(spec_blob, return_ids, None,
                             tmpl.effective_retries, sched_key,
                             tmpl.resources, tmpl.strategy, tmpl.name,
                             tmpl.runtime_env, streaming=tmpl.streaming)
        info.trace_ctx = trace_ctx
        info.submit_t = t_submit
        _metrics.TASKS_SUBMITTED.inc()
        arg_ids = self._register_submitted_args(task_id_bytes, args, kwargs)
        info.arg_ids = arg_ids
        if tmpl.streaming:
            # No lineage for streams (v1): partial replay would duplicate
            # already-consumed items; a lost stream fails instead.
            with self._streams_lock:
                self._streams[task_id_bytes] = _StreamState()
            self._enqueue_task(task_id_bytes, info)
            self._emit_submit_span(info, t_submit)
            return ObjectRefGenerator(self, task_id)
        self.lineage.record(task_id_bytes, _LineageRecord(
            spec_blob, sched_key, tmpl.resources, tmpl.strategy, tmpl.name,
            return_ids, arg_ids, runtime_env=tmpl.runtime_env))
        self._enqueue_when_resolved(task_id_bytes, info, args, kwargs)
        self._emit_submit_span(info, t_submit)
        return refs

    def _enqueue_when_resolved(self, task_id_bytes: bytes,
                               info: "_InflightTask", args,
                               kwargs) -> None:
        """Enqueue a task once every argument this process owns and is
        still computing has arrived (the reference's dependency resolver).
        Pushed earlier, the task would occupy a worker that blocks in
        ``get`` and hands its CPU back, so the node would start another
        worker for the next link: a chain of n dependent tasks would hold
        n workers. Top-level arguments only, as the worker resolves only
        those; an argument that fails still arrives (as its error)."""
        pending = [a.id() for a in itertools.chain(args, kwargs.values())
                   if isinstance(a, ObjectRef)
                   and a.owner_address == self.owner_addr
                   and not self.memory_store.contains(a.id())]
        if not pending:
            self._enqueue_task(task_id_bytes, info)
            return
        left = [len(pending)]
        lock = threading.Lock()

        def arrived(_rec) -> None:
            with lock:
                left[0] -= 1
                done = left[0] == 0
            if done:
                self._resolved_q.put(task_id_bytes)

        with self._resolver_lock:
            if not self._resolver_started:
                self._resolver_started = True
                threading.Thread(target=self._resolver_loop, daemon=True,
                                 name="dep-resolver").start()
        with self._dep_lock:
            self._dep_waiting[task_id_bytes] = (info, pending, arrived)
        for oid in pending:
            self.memory_store.get_async(oid, arrived)

    def _resolver_loop(self) -> None:
        while not self._shutdown_flag:
            try:
                task_id_bytes = self._resolved_q.get(timeout=0.5)
            except queue.Empty:
                continue
            # Enqueued under _dep_lock, so ``cancel`` finds the task
            # either here or in its key queue.
            with self._dep_lock:
                entry = self._dep_waiting.pop(task_id_bytes, None)
                if entry is not None:
                    self._enqueue_task(task_id_bytes, entry[0])

    def _cancel_waiting(self, tid_bytes: bytes) -> bool:
        """Fail a task still waiting on its arguments with
        TaskCancelledError and drop its callbacks; False if none waits."""
        from ray_tpu_torch.exceptions import TaskCancelledError

        with self._dep_lock:
            entry = self._dep_waiting.pop(tid_bytes, None)
        if entry is None:
            return False
        info, pending, arrived = entry
        for oid in pending:
            self.memory_store.remove_callback(oid, arrived)
        err = TaskCancelledError(f"task {info.name} cancelled")
        for oid in info.return_ids:
            self.memory_store.put(oid, err, is_exception=True)
        self._release_submitted_args(tid_bytes)
        return True

    @staticmethod
    def _emit_submit_span(info: "_InflightTask", t_submit: float) -> None:
        """task.submit: spec build + arg registration + enqueue (the
        owner-side cost before the dispatcher takes over). Gated on the
        task's captured wire context so the untraced path is one None
        check."""
        if info.trace_ctx is None:
            return
        from ray_tpu_torch.util import tracing

        tracing.emit_span("task.submit", t_submit, time.time(),
                          parent=info.trace_ctx,
                          attrs={"task": info.name,
                                 "args": len(info.arg_ids)})

    # ------------------------------------------------- streaming generators

    def _next_stream_ref(self, task_id: TaskID, index: int,
                         timeout: float) -> ObjectRef:
        """Block until yield #index has arrived (or the stream ended)."""
        task_id_bytes = task_id.binary()
        with self._streams_lock:
            st = self._streams.get(task_id_bytes)
        if st is None:
            raise StopIteration
        deadline = time.monotonic() + timeout
        with st.cv:
            while True:
                if st.received > index:
                    st.consumed = max(st.consumed, index + 1)
                    return ObjectRef(
                        ObjectID.for_stream_return(task_id, index),
                        self.owner_addr)
                if st.error is not None and st.received <= index:
                    self._drop_stream(task_id_bytes)
                    raise st.error
                if st.total is not None and index >= st.total:
                    self._drop_stream(task_id_bytes)
                    raise StopIteration
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise GetTimeoutError(
                        f"stream item {index} of task "
                        f"{task_id.hex()[:12]} not ready in {timeout}s")
                st.cv.wait(min(remaining, 1.0))

    def _drop_stream(self, task_id_bytes: bytes) -> None:
        with self._streams_lock:
            self._streams.pop(task_id_bytes, None)

    def _mark_cancelled(self, task_id: TaskID, force: bool = False) -> None:
        """Shared cancel bookkeeping: remember the id (bounded) and tell
        the executing worker, if dispatched (used by cancel() and stream
        abandonment). ``force`` rides the same (single) notify — the
        worker exits if the task is inside user code."""
        self._cancelled.add(task_id)
        self._cancelled_order.append(task_id)
        while len(self._cancelled_order) > cfg.cancelled_ids_max:
            self._cancelled.discard(self._cancelled_order.popleft())
        with self._inflight_lock:
            info = self._inflight.get(task_id.binary())
        if info is not None and info.worker_addr:
            try:
                self._pool.get(info.worker_addr).notify(
                    "cancel_task", task_id.binary(), force)
            except Exception:
                pass

    def _abandon_stream(self, task_id: TaskID) -> None:
        """The consumer dropped its generator: cancel producer-side and
        release every delivered-but-unconsumed item (consumed items'
        ObjectRefs release themselves through normal ref GC; items racing
        through rpc_batch_done are reconciled post-commit in
        _fire_stream_notifies)."""
        task_id_bytes = task_id.binary()
        with self._streams_lock:
            st = self._streams.pop(task_id_bytes, None)
        if st is None:
            return
        with st.cv:
            consumed, received = st.consumed, st.received
            st.error = TaskError(
                "StreamAbandoned", "stream abandoned by consumer")
            st.cv.notify_all()
        self._mark_cancelled(task_id)
        for idx in range(consumed, received):
            self._release_stream_item(task_id, idx)

    def _release_stream_item(self, task_id: TaskID, index: int) -> None:
        oid = ObjectID.for_stream_return(task_id, index)
        self.memory_store.delete([oid])
        try:
            self.refcount.drop_owned_object(oid)
        except Exception:
            pass

    def rpc_stream_consumed(self, conn, task_id_bytes: bytes) -> int:
        """Producer flow-control poll: how many items the consumer has
        taken (-1 = stream gone/abandoned; producer should stop)."""
        with self._streams_lock:
            st = self._streams.get(task_id_bytes)
        if st is None:
            return -1
        with st.cv:
            return st.consumed

    def _handle_stream_item(self, task_id_bytes: bytes, index: int,
                            result: Tuple[bytes, str, Any],
                            puts: list, notifies: list) -> None:
        with self._streams_lock:
            live = task_id_bytes in self._streams
        if not live:
            return  # abandoned: do not store (would pin forever)
        oid_bytes, kind, payload = result
        oid = ObjectID(oid_bytes)
        self.refcount.add_owned_object(oid)
        if kind == "value":
            puts.append((oid, SERIALIZER.decode(payload), False))
        elif kind == "error":
            puts.append((oid, payload, True))
        else:
            if isinstance(payload, (tuple, list)) and len(payload) == 2:
                self._note_object_location(oid_bytes, payload[0], payload[1])
            puts.append((oid, PlasmaStub(oid), False))
        # The consumer wakes only AFTER put_batch lands (the ref must be
        # gettable the moment __next__ returns): defer via `notifies`.
        notifies.append(("item", task_id_bytes, index))

    def _handle_stream_end(self, task_id_bytes: bytes, count: int,
                           error, span, puts: list, notifies: list) -> None:
        # Completion bookkeeping (inflight pop, lease credit, metrics).
        self._complete_task(task_id_bytes, [], span, puts)
        notifies.append(("end", task_id_bytes, count, error))

    def _fire_stream_notifies(self, notifies: list) -> None:
        for entry in notifies:
            with self._streams_lock:
                st = self._streams.get(entry[1])
            if st is None:
                # Stream abandoned while this batch was mid-commit: the
                # item landed in the store AFTER _abandon_stream's release
                # pass — reconcile here or it is owned forever with no
                # ref and no release path.
                if entry[0] == "item":
                    self._release_stream_item(TaskID(entry[1]), entry[2])
                continue
            with st.cv:
                if entry[0] == "item":
                    st.received = max(st.received, entry[2] + 1)
                else:
                    st.total = entry[2]
                    if entry[3] is not None:
                        st.error = entry[3]
                st.cv.notify_all()

    def _fail_stream(self, task_id_bytes: bytes, error) -> None:
        with self._streams_lock:
            st = self._streams.get(task_id_bytes)
        if st is not None:
            with st.cv:
                st.error = error
                st.total = st.received
                st.cv.notify_all()

    # ---- per-scheduling-key dispatch (reference: NormalTaskSubmitter's
    # per-SchedulingKey worker-lease pools + backlog, lease reuse via
    # OnWorkerIdle, rate-limited lease requests) ----

    def _enqueue_task(self, task_id_bytes: bytes, info: _InflightTask) -> None:
        key = info.sched_key
        info.enqueued_at = time.monotonic()
        with self._lease_lock:
            kq = self._key_queues.get(key)
            if kq is None:
                kq = self._key_queues[key] = _KeyQueue(key)
            if not kq.queue:
                # A fresh burst after quiescence starts with a clean slate:
                # stale saturation backoff must not delay its first lease.
                kq.lease_backoff = 0.0
                kq.next_lease_attempt = 0.0
            kq.queue.append((task_id_bytes, info))
            if not kq.dispatcher_running:
                kq.dispatcher_running = True
                threading.Thread(target=self._dispatch_loop, args=(kq,),
                                 daemon=True,
                                 name=f"dispatch-{key[0][:24]}").start()
            else:
                kq.wake.set()

    def _dispatch_loop(self, kq: "_KeyQueue") -> None:
        """One dispatcher per scheduling key while work exists: drains the
        queue onto leased workers in bursts (pipelined up to 4/worker).
        Lease acquisition runs on BACKGROUND threads (bounded by
        `max_pending_lease_requests_per_scheduling_key`) so slow lease
        grants / worker spawns never stall the push path. After draining,
        the dispatcher lingers briefly: a sync submit-get loop would
        otherwise pay a thread spawn per call."""
        idle_deadline = None
        while True:
            batch: List[Tuple[tuple, _Lease]] = []
            with self._lease_lock:
                depth = cfg.max_tasks_in_flight_per_worker
                # The per-worker pipeline hides push RTT for short tasks —
                # it is NOT parallel capacity. Duration-gated: once this
                # key's observed exec-time EWMA says tasks are SHORT,
                # pipeline to full depth (frame/wake amortization is the
                # single-core throughput ceiling); while tasks are long —
                # or unmeasured — hold one per lease, because a long task
                # queued behind another serializes (pushed tasks never
                # migrate) and a queued task goes to the FIRST lease that
                # frees, which no fixed assignment beats.
                short = (kq.avg_task_s is not None
                         and kq.avg_task_s < cfg.pipeline_short_task_s)
                cap = depth if short else 1
                locality_on = cfg.scheduler_locality_enabled
                # Live-lease census per node: the locality match defers a
                # task whose home node has a live lease here (bounded —
                # see _match_queued_task) instead of migrating its input.
                live_count: Dict[str, int] = {}
                if locality_on:
                    for l in kq.leases:
                        if not l.broken and l.node_id:
                            live_count[l.node_id] = \
                                live_count.get(l.node_id, 0) + 1
                made_progress = True
                while kq.queue and made_progress:
                    made_progress = False
                    free = sorted(
                        (l for l in kq.leases
                         if not l.broken and l.inflight < cap),
                        key=lambda l: l.inflight)
                    for lease in free:
                        if not kq.queue or lease.inflight >= cap:
                            continue
                        match = self._match_queued_task(
                            kq, lease, live_count, locality_on, cap)
                        if match is None:
                            continue
                        idx, pref = match
                        if idx:
                            kq.queue.rotate(-idx)
                            entry = kq.queue.popleft()
                            kq.queue.rotate(idx)
                        else:
                            entry = kq.queue.popleft()
                        lease.inflight += 1
                        batch.append((entry, lease))
                        made_progress = True
                queue_len = len(kq.queue)
                sample = kq.queue[0][1] if kq.queue else None
            if batch:
                # One push frame per lease per round (the per-task frame +
                # ack + wakeup tax was the single-core throughput ceiling).
                by_lease: Dict[Any, list] = {}
                for (task_id_bytes, info), lease in batch:
                    by_lease.setdefault(id(lease), (lease, []))[1].append(
                        (task_id_bytes, info))
                for lease, items in by_lease.values():
                    self._push_group_to_lease(items, lease, kq)
            if sample is not None:
                self._maybe_request_leases(kq, sample, queue_len)
            if not batch:
                with self._lease_lock:
                    # Quiescent when nothing is queued and no HEALTHY lease
                    # has work in flight (a broken lease's stuck counters
                    # must not keep the dispatcher spinning — its tasks were
                    # already re-enqueued or failed by the conn-lost hook).
                    done = (not kq.queue
                            and not kq.pending_lease_requests
                            and all(l.inflight <= 0 or l.broken
                                    for l in kq.leases))
                    if done and idle_deadline is not None \
                            and time.monotonic() > idle_deadline:
                        kq.dispatcher_running = False
                        return
                if done and idle_deadline is None:
                    idle_deadline = (time.monotonic()
                                     + cfg.dispatcher_idle_linger_s)
                elif not done:
                    idle_deadline = None
                kq.wake.wait(0.25)
                kq.wake.clear()
            else:
                idle_deadline = None

    def _match_queued_task(self, kq: "_KeyQueue", lease: _Lease,
                           live_count: Dict[str, int], locality_on: bool,
                           cap: int) -> Optional[Tuple[int, Optional[str]]]:
        """(index into kq.queue, that task's preferred node) of the task
        to hand this lease, or None to leave the lease idle this round
        (it lingers briefly, then returns to its node). Preference
        order, scanned over a bounded window:

        1. a task whose inputs live on the lease's node (locality hit);
        2. a task with no known input locations;
        3. a task whose preferred node has no live lease under this key —
           it has to run SOMEWHERE, and a miss now beats waiting for a
           lease that may never come.

        A task whose preferred node DOES have live leases here is
        DEFERRED — its home lease frees within one task, or leaves
        kq.leases entirely, which lifts the deferral next round — but
        only up to 4 x (live leases x pipeline cap) tasks per node, so a
        skewed workload (every input on one hot node) still fans out
        instead of serializing behind one worker. Caller holds
        _lease_lock."""
        if not kq.queue:
            return None
        if not locality_on:
            return 0, None  # FIFO; hit/miss accounting is off anyway
        fallback = None
        deferred: Dict[str, int] = {}
        stale_cutoff = time.monotonic() - cfg.scheduler_locality_defer_max_s
        for i, (_tid, info) in enumerate(kq.queue):
            if i >= 64:
                break
            pref = self._preferred_node(info)
            if pref is not None and pref == lease.node_id:
                return i, pref
            if (pref is None or pref not in live_count
                    or info.enqueued_at < stale_cutoff):
                # No locality data, no live home lease, or deferred past
                # the age cap (home lease wedged on one long task): run
                # anywhere rather than wait longer.
                if fallback is None:
                    fallback = (i, pref)
                continue
            d = deferred.get(pref, 0)
            if d >= 4 * cap * live_count[pref]:
                if fallback is None:
                    fallback = (i, pref)
            else:
                deferred[pref] = d + 1
        return fallback

    def _maybe_request_leases(self, kq: "_KeyQueue", sample: _InflightTask,
                              queue_len: int) -> None:
        """Spawn background lease requesters if the queue outruns capacity."""
        with self._lease_lock:
            if time.monotonic() < kq.next_lease_attempt:
                return
            # Parallelism-first sizing: one WORKER per runnable task (the
            # per-worker pipeline is an RTT-hiding optimization, not
            # parallel capacity — sizing by pipeline depth left 4 sleeping
            # tasks sharing one worker). Tasks already pipelined beyond
            # one-per-lease count as backlog too. A saturated node
            # declines the extras and the declined-lease backoff bounds
            # the request rate.
            healthy = [l for l in kq.leases if not l.broken]
            idle = sum(1 for l in healthy if l.inflight == 0)
            excess = sum(max(0, l.inflight - 1) for l in healthy)
            shortfall = (queue_len + excess - idle
                         - kq.pending_lease_requests)
            want = min(max(0, shortfall),
                       cfg.max_pending_lease_requests_per_scheduling_key
                       - kq.pending_lease_requests)
            kq.pending_lease_requests += want
            if sample.strategy is None and kq.lease_fail_deadline is None:
                kq.lease_fail_deadline = (
                    time.monotonic() + cfg.lease_timeout_ms / 1000.0 * 6)
            # DISTINCT samples: the i-th new request hints the i-th queued
            # task's inputs, so granted leases land where the backlog's
            # data actually lives — `want` copies of the head task's hint
            # would pile every lease onto one holder node.
            qlist = list(kq.queue)
            samples = [qlist[i][1] if i < len(qlist) else sample
                       for i in range(want)]
        if len(samples) == 1:
            threading.Thread(target=self._lease_requester,
                             args=(kq, samples[0]), daemon=True).start()
        elif samples:
            # One batched pick_nodes frame covers the whole round; the
            # per-node lease requests still fan out on their own threads.
            threading.Thread(target=self._batch_lease_requests,
                             args=(kq, samples), daemon=True).start()

    def _locality_hint_for(self, sample: _InflightTask):
        if (cfg.scheduler_locality_enabled and sample.arg_ids
                and sample.strategy is None):
            return [o.binary() for o in
                    sample.arg_ids[:cfg.scheduler_locality_max_hint_objects]]
        return None

    def _batch_lease_requests(self, kq: "_KeyQueue",
                              samples: List[_InflightTask]) -> None:
        """Resolve a round of head picks in ONE pick_nodes frame, then run
        the standard per-sample lease requester with the pick pre-filled.
        A failed batch call degrades to per-sample picks (first_pick=None).
        Each requester decrements kq.pending_lease_requests exactly as in
        the unbatched path."""
        demand_key = None
        picks: List[Any] = [None] * len(samples)
        try:
            reqs = []
            for s in samples:
                demand_key = (self.worker_id.hex(),
                              tuple(sorted(s.resources.items())))
                reqs.append((s.resources, s.strategy, [], demand_key,
                             self._locality_hint_for(s)))
            with self._lease_lock:
                self.dispatch_stats["head_picks"] += 1
            got = self.head.retrying_call("pick_nodes", reqs, timeout=10)
            if isinstance(got, list) and len(got) == len(samples):
                picks = got
        except Exception:
            pass  # per-sample requesters fall back to their own picks
        for s, pick in zip(samples, picks):
            threading.Thread(target=self._lease_requester,
                             args=(kq, s, pick), daemon=True).start()

    def _lease_requester(self, kq: "_KeyQueue", sample: _InflightTask,
                         first_pick=None) -> None:
        from ray_tpu_torch.exceptions import RuntimeEnvSetupError

        env_err = None
        lease = None
        via_block = False
        hint = self._locality_hint_for(sample)
        t_lease0 = time.time() if sample.trace_ctx is not None else 0.0
        try:
            # Steady state: admit against the key's lease block
            # node-direct; only a missing/dead block pays the
            # head-mediated pick below.
            lease = self._request_lease_via_block(kq, sample)
            via_block = lease is not None
            if lease is None:
                lease = self._request_new_lease(sample.resources,
                                                sample.strategy,
                                                sample.runtime_env, hint,
                                                first_pick=first_pick)
        except RuntimeEnvSetupError as e:
            env_err = e
        finally:
            with self._lease_lock:
                kq.pending_lease_requests -= 1
        if sample.trace_ctx is not None:
            # task.lease: pick_node + request_lease round-trip for the
            # sampled task's scheduling key (grants are shared by the
            # key's whole queue; the span is parented to the task whose
            # shape/locality hint drove the request).
            from ray_tpu_torch.util import tracing as _tr

            _tr.emit_span(
                "task.lease", t_lease0, time.time(),
                parent=sample.trace_ctx,
                attrs={"task": sample.name,
                       "granted": lease is not None,
                       "node": (lease.node_id or "") if lease else "",
                       "worker": lease.worker_addr if lease else ""},
                ok=env_err is None)
        if env_err is not None:
            # The env can never materialize: every queued task of this key
            # fails NOW with the real install error (not a hang).
            self._fail_queued(kq, env_err)
            return
        if lease is not None:
            with self._lease_lock:
                if self._key_queues.get(kq.key) is not kq:
                    # The kq was reaped while this grant was in flight:
                    # nobody will ever dispatch on (or return) this lease —
                    # hand the worker straight back to its node.
                    orphaned = True
                elif not kq.queue and any(not l.broken for l in kq.leases):
                    # SURPLUS straggler: the backlog drained onto existing
                    # leases while this grant was queued at its node.
                    # Return it NOW instead of letting it linger — a chain
                    # of trailing grants each holding the node's resources
                    # for a linger period starves other submitters' (and
                    # other keys') locality-hinted requests at that node.
                    orphaned = True
                else:
                    orphaned = False
                    kq.leases.append(lease)
                    kq.lease_fail_deadline = None
                    kq.lease_backoff = 0.0
                    kq.next_lease_attempt = 0.0
            if orphaned:
                try:
                    self._pool.get(lease.node_addr).retrying_call(
                        "return_lease", lease.lease_id,
                        timeout=cfg.rpc_control_timeout_s)
                except Exception:
                    pass
                return
            if (not via_block and cfg.lease_block_enabled
                    and sample.strategy is None):
                # First head-mediated grant for this key succeeded:
                # negotiate the block in the background so the NEXT
                # dispatch round goes node-direct.
                with self._lease_lock:
                    start = kq.block is None and not kq.block_pending
                    if start:
                        kq.block_pending = True
                if start:
                    threading.Thread(target=self._negotiate_block,
                                     args=(kq, sample), daemon=True).start()
            kq.wake.set()
            return
        # Infeasible right now. If nothing is making progress for too long,
        # fail what's queued instead of spinning forever.
        with self._lease_lock:
            has_live = any(not l.broken for l in kq.leases)
            deadline = kq.lease_fail_deadline
        if (not has_live and deadline is not None
                and time.monotonic() > deadline):
            self._fail_queued(kq, TimeoutError(
                f"no feasible node for {sample.resources}"))
        else:
            with self._lease_lock:
                kq.lease_backoff = min(max(kq.lease_backoff * 2,
                               cfg.lease_backoff_base_s),
                           cfg.lease_backoff_max_s)
                kq.next_lease_attempt = time.monotonic() + kq.lease_backoff
            time.sleep(0.05)
            kq.wake.set()

    def _push_group_to_lease(self, items: List[Tuple[bytes, _InflightTask]],
                             lease: _Lease, kq: "_KeyQueue") -> None:
        survivors: List[Tuple[bytes, _InflightTask]] = []
        for task_id_bytes, info in items:
            # A cancel must survive re-dispatch (worker-crash re-enqueue)
            # and the queue-pop -> inflight-insert window: last check
            # before push.
            if TaskID(task_id_bytes) in self._cancelled:
                from ray_tpu_torch.exceptions import TaskCancelledError

                err = TaskCancelledError(f"task {info.name} cancelled")
                for oid in info.return_ids:
                    self.memory_store.put(oid, err, is_exception=True)
                self._release_submitted_args(task_id_bytes)
                # Undo this dispatch round's inflight++ (handles linger too).
                self._lease_task_finished(info.sched_key, lease.worker_addr)
                continue
            info.worker_addr = lease.worker_addr
            with self._inflight_lock:
                self._inflight[task_id_bytes] = info
            survivors.append((task_id_bytes, info))
        if not survivors:
            return
        try:
            worker = self._pool.get(lease.worker_addr,
                                    on_close=self._on_worker_conn_lost)
            waiter = worker.call_async(
                "push_tasks",
                [(tid, info.spec_blob) for tid, info in survivors])
            for _tid, info in survivors:
                if info.trace_ctx is not None:
                    # task.dispatch: submit -> lease pairing -> push
                    # frame on the wire (one span per push ATTEMPT —
                    # emitted only after the frame actually sent, so a
                    # dead-worker failure below records nothing).
                    from ray_tpu_torch.util import tracing as _tr

                    _tr.emit_span(
                        "task.dispatch", info.submit_t or time.time(),
                        time.time(), parent=info.trace_ctx,
                        attrs={"task": info.name,
                               "worker": lease.worker_addr,
                               "node": lease.node_id or ""})
            self._push_acks.append(
                [waiter, survivors, lease, kq, 0,
                 time.monotonic() + cfg.push_ack_timeout_s])
            self._push_ack_event.set()
        except BaseException:
            with self._inflight_lock:
                for tid, _ in survivors:
                    self._inflight.pop(tid, None)
            lease.broken = True
            with self._lease_lock:
                for tid, info in reversed(survivors):
                    kq.queue.appendleft((tid, info))

    def _push_ack_loop(self) -> None:
        """Collects push acks asynchronously (pipelining stays intact) and
        retries unacked pushes: an ack or request lost to chaos must not
        strand the task."""
        import collections

        while not self._shutdown_flag:
            try:
                # Every iteration — a continuously-busy dispatch queue must
                # not stall pin expiry (pins would accumulate unboundedly).
                self._sweep_transfer_pins()
                if not self._push_acks:
                    self._push_ack_event.wait(0.2)
                    self._push_ack_event.clear()
                    continue
                entry = self._push_acks.popleft()
                waiter, items, lease, kq, attempts, deadline = entry
                if not waiter._event.is_set():
                    if time.monotonic() < deadline:
                        self._push_acks.append(entry)
                        # Snapshot: dispatchers append concurrently, and
                        # iterating the live deque would raise and kill this
                        # thread (stranding every future unacked push).
                        if all(not e[0]._event.is_set()
                               for e in list(self._push_acks)):
                            time.sleep(cfg.push_ack_idle_poll_s)
                        continue
                    self._retry_push(entry)
                    continue
                try:
                    waiter.wait(0)
                except BaseException:
                    self._retry_push(entry)
            except BaseException:  # noqa: BLE001 — ack loop must survive
                time.sleep(0.05)

    def _retry_push(self, entry) -> None:
        waiter, items, lease, kq, attempts, deadline = entry
        with self._inflight_lock:
            live = [(tid, info) for tid, info in items
                    if tid in self._inflight]
        if not live:
            return  # all completed or already handled by conn-loss hook
        if attempts < 8 and not lease.broken:
            try:
                worker = self._pool.get(lease.worker_addr,
                                        on_close=self._on_worker_conn_lost)
                w2 = worker.call_async(
                    "push_tasks",
                    [(tid, info.spec_blob) for tid, info in live])
                self._push_acks.append(
                    [w2, live, lease, kq, attempts + 1,
                     time.monotonic() + 5.0])
                return
            except BaseException:
                pass
        # Give up on this worker: re-route through the queue.
        lease.broken = True
        for tid, info in live:
            with self._inflight_lock:
                if self._inflight.pop(tid, None) is None:
                    continue
            self._enqueue_task(tid, info)

    def _fail_queued(self, kq: "_KeyQueue", exc: Exception) -> None:
        err = capture_exception(exc)
        with self._lease_lock:
            tasks = list(kq.queue)
            kq.queue.clear()
        for tid, info in tasks:
            for oid in info.return_ids:
                self.memory_store.put(oid, err, is_exception=True)
            self._release_submitted_args(tid)

    def _request_new_lease(self, resources: Dict[str, float],
                           strategy,
                           runtime_env=None,
                           locality_hint: Optional[List[bytes]] = None,
                           first_pick=None,
                           ) -> Optional[_Lease]:
        """One head pick + node lease round trip; None if infeasible now.
        Both RPCs are retry-safe: pick_node is read-only, request_lease is
        idempotent via the per-attempt req_id (the node caches the grant).
        ``locality_hint`` ships the requesting task's input-object ids so
        the head can score candidates by locally-resident bytes.
        ``first_pick`` (from a batched pick_nodes) skips the first
        pick_node round trip; spillback hops re-pick individually."""
        exclude: List[str] = []
        # Demand identity for the head's unmet-demand ring: this
        # submitter + shape. Retries of one starved key stay one demand;
        # distinct submitters register separately.
        demand_key = (self.worker_id.hex(),
                      tuple(sorted(resources.items())))
        for hop in range(4):  # a few spillback hops per attempt
            if hop == 0 and first_pick is not None:
                picked = first_pick
            else:
                try:
                    with self._lease_lock:
                        self.dispatch_stats["head_picks"] += 1
                    picked = self.head.retrying_call(
                        "pick_node", resources, strategy, exclude,
                        demand_key, locality_hint, timeout=10)
                except (ConnectionLost, TimeoutError):
                    return None
            if picked is None:
                return None
            node_id, node_addr, _ = picked
            pg = pg_key_from_strategy(strategy)
            req_id = uuid.uuid4().hex
            # The short locality wait applies ONLY when the picked node
            # actually holds input bytes (a locality gamble): queue
            # briefly, declined -> exclude -> repick is the spillback. A
            # plain hybrid pick keeps the full default queue window —
            # shortening it for every data task would cost the whole
            # cluster 3x its queue patience under saturation.
            block_ms = None
            if locality_hint:
                with self._obj_loc_lock:
                    holders = {self._obj_locality[k][0]
                               for k in locality_hint
                               if k in self._obj_locality}
                if node_id in holders:
                    block_ms = cfg.scheduler_locality_wait_ms
            try:
                granted = self._pool.get(node_addr).retrying_call(
                    "request_lease", resources, True, pg, req_id,
                    self.owner_addr, runtime_env, block_ms,
                    timeout=cfg.lease_timeout_ms / 1000.0 + 5)
            except (ConnectionLost, TimeoutError):
                exclude.append(node_id)
                continue
            if granted is None:
                exclude.append(node_id)
                continue
            if isinstance(granted, dict) and "env_error" in granted:
                # Permanent per-node env failure: spilling back would just
                # reinstall-and-fail elsewhere forever.
                from ray_tpu_torch.exceptions import RuntimeEnvSetupError

                raise RuntimeEnvSetupError(granted["env_error"])
            worker_addr, lease_id = granted
            return _Lease(worker_addr, lease_id, node_addr, node_id)
        return None

    # ------------------------------------------------------------ lease blocks

    def _request_lease_via_block(self, kq: "_KeyQueue",
                                 sample: _InflightTask) -> Optional[_Lease]:
        """Steady-state node-direct dispatch: admit against the key's
        head-granted lease block, skipping the pick_node round trip.
        None = no usable block — the caller falls back to the normal
        head-mediated path, so a revoked/expired/exhausted block degrades
        gracefully, never wrongly."""
        if not cfg.lease_block_enabled or sample.strategy is not None:
            return None
        renew = False
        with self._lease_lock:
            blk = kq.block
            if blk is None:
                return None
            if blk.remaining <= 0 or time.monotonic() > blk.expires_at:
                # Spent or expired: next head-mediated grant renegotiates.
                kq.block = None
                dead_id = blk.block_id
            else:
                dead_id = None
                blk.remaining -= 1
                if (blk.remaining
                        <= blk.size * cfg.lease_block_renew_lowwater
                        and not blk.renewing):
                    blk.renewing = True
                    renew = True
        if dead_id is not None:
            self._revoke_block_async(dead_id)
            return None
        if renew:
            # Ahead-of-exhaustion renewal OFF the dispatch path: dispatch
            # keeps draining the old budget while this round-trips.
            threading.Thread(target=self._negotiate_block,
                             args=(kq, sample, blk), daemon=True).start()
        pg = pg_key_from_strategy(sample.strategy)
        req_id = uuid.uuid4().hex
        try:
            granted = self._pool.get(blk.node_addr).retrying_call(
                "request_lease", sample.resources, True, pg, req_id,
                self.owner_addr, sample.runtime_env, None, blk.block_id,
                timeout=cfg.lease_timeout_ms / 1000.0 + 5)
        except (ConnectionLost, TimeoutError):
            # Node unreachable (died under the block): drop it and fall
            # back to a head pick — the head's death path revokes.
            with self._lease_lock:
                if kq.block is blk:
                    kq.block = None
                self.dispatch_stats["block_fallbacks"] += 1
            return None
        if isinstance(granted, dict):
            if "env_error" in granted:
                from ray_tpu_torch.exceptions import RuntimeEnvSetupError

                raise RuntimeEnvSetupError(granted["env_error"])
            # {"block_revoked": True}: the node no longer honors the
            # block (head revoked it / TTL beat the owner's clock).
            with self._lease_lock:
                if kq.block is blk:
                    kq.block = None
                self.dispatch_stats["block_fallbacks"] += 1
            return None
        if granted is None:
            # Saturated node declined; the node credited the admission
            # unit back — mirror that locally and spill back to the head.
            with self._lease_lock:
                blk.remaining += 1
                self.dispatch_stats["block_fallbacks"] += 1
            return None
        with self._lease_lock:
            self.dispatch_stats["block_dispatches"] += 1
        worker_addr, lease_id = granted
        return _Lease(worker_addr, lease_id, blk.node_addr, blk.node_id)

    def _negotiate_block(self, kq: "_KeyQueue", sample: _InflightTask,
                         prev: Optional[_LeaseBlock] = None) -> None:
        """Background block grant (prev=None, after the first successful
        head-mediated lease for the key) or low-water renewal (prev =
        the draining block, placement stays sticky to its node). Never
        called on the dispatch path."""
        block_id = uuid.uuid4().hex
        got = None
        try:
            if prev is None:
                got = self.head.retrying_call(
                    "lease_block_grant", block_id, self.owner_addr,
                    sample.resources, sample.strategy,
                    self._locality_hint_for(sample), timeout=10)
            else:
                got = self.head.retrying_call(
                    "lease_block_renew", block_id, self.owner_addr,
                    sample.resources, prev.node_id, sample.strategy,
                    timeout=10)
        except Exception as e:
            logger.debug("lease block negotiation for %r failed: %r",
                         kq.key, e)
            got = None
        stale_id = None
        with self._lease_lock:
            if prev is None:
                kq.block_pending = False
            else:
                prev.renewing = False
            if got is not None:
                node_id, node_addr, size, ttl_ms = got
                if self._key_queues.get(kq.key) is not kq:
                    # The kq was reaped while the grant was in flight:
                    # nobody will ever dispatch against this block.
                    stale_id = block_id
                else:
                    stale = kq.block
                    kq.block = _LeaseBlock(block_id, node_id, node_addr,
                                           size, ttl_ms)
                    self.dispatch_stats["block_grants"] += 1
                    if stale is not None:
                        stale_id = stale.block_id
        if stale_id is not None:
            self._revoke_block_async(stale_id)

    def _revoke_block_async(self, block_id: str) -> None:
        """Best-effort head-routed release of a block this owner no
        longer uses (replaced, expired, key reaped) — keeps the node's
        admission budget and the census honest without waiting out the
        TTL backstop."""
        def _go():
            try:
                self.head.retrying_call("lease_block_revoke", block_id,
                                        timeout=5)
            except Exception:  # rtpu-lint: disable=swallowed-exception — best-effort: TTL expiry at head and node is the backstop
                pass

        threading.Thread(target=_go, daemon=True).start()

    def _on_worker_conn_lost(self, client: RpcClient) -> None:
        """A worker connection died: fail/retry its inflight tasks, mark its
        actors dead-pending-head-confirmation."""
        addr = client.address
        victims = []
        with self._inflight_lock:
            for tid, info in list(self._inflight.items()):
                if info.worker_addr == addr:
                    victims.append((tid, info))
                    del self._inflight[tid]
        with self._lease_lock:
            for kq in self._key_queues.values():
                for l in kq.leases:
                    if l.worker_addr == addr:
                        l.broken = True
        # System failure: normal tasks are resubmitted through the queue
        # (bounded by their per-task sys_retries counter).
        for tid, info in victims:
            if info.sched_key and info.sched_key[0] == "actor":
                continue  # actor calls handled by _handle_actor_conn_lost
            if info.streaming:
                # Replaying a partially-consumed stream would duplicate
                # delivered items: fail it (documented v1 semantics).
                self._fail_stream(tid, WorkerCrashedError(
                    f"worker at {addr} died mid-stream in {info.name}"))
                self._release_submitted_args(tid)
                continue
            if info.sys_retries is None:
                info.sys_retries = cfg.task_max_retries_default
            info.sys_retries -= 1
            if info.sys_retries < 0:
                err = capture_exception(WorkerCrashedError(
                    f"worker at {addr} died executing {info.name}"))
                for oid in info.return_ids:
                    self.memory_store.put(oid, err, is_exception=True)
                self._release_submitted_args(tid)
            else:
                self._enqueue_task(tid, info)
        with self._actors_lock:
            conns = [c for c in self._actors.values() if c.address == addr]
        for c in conns:
            threading.Thread(target=self._handle_actor_conn_lost, args=(c,),
                             daemon=True).start()

    # ------------------------------------------------------------------ leases

    def _lease_task_finished(self, sched_key: tuple, worker_addr: str,
                             exec_s: Optional[float] = None) -> None:
        with self._lease_lock:
            kq = self._key_queues.get(sched_key)
            if kq is None:
                return
            if exec_s is not None:
                kq.avg_task_s = (exec_s if kq.avg_task_s is None
                                 else 0.8 * kq.avg_task_s + 0.2 * exec_s)
            for l in kq.leases:
                if l.worker_addr == worker_addr and l.inflight > 0:
                    l.inflight -= 1
                    if l.inflight <= 0:
                        l.release_at = time.monotonic() + cfg.lease_linger_ms / 1000.0
                    break
            kq.wake.set()

    def _lease_reaper_loop(self) -> None:
        """Returns idle leases to their node managers after the linger.
        Also reports per-key queued backlog to the head every ~2s — the
        autoscaler's demand signal (reference: backlog_size rides lease
        requests, raylet forwards demand to the autoscaler)."""
        last_backlog_report = 0.0
        while not self._shutdown_flag:
            time.sleep(0.05)
            now = time.monotonic()
            if now - last_backlog_report >= 2.0:
                last_backlog_report = now
                try:
                    self._report_backlog()
                except Exception:
                    pass
            to_release = []
            doomed_blocks: List[str] = []
            with self._lease_lock:
                for key, kq in list(self._key_queues.items()):
                    keep = []
                    for l in kq.leases:
                        if l.broken or (l.inflight <= 0 and l.release_at
                                        and now >= l.release_at):
                            to_release.append(l)
                        else:
                            keep.append(l)
                    kq.leases[:] = keep
                    if (not kq.leases and not kq.queue
                            and not kq.dispatcher_running
                            and not kq.pending_lease_requests):
                        # pending_lease_requests guard: a slow worker-spawn
                        # grant landing on a popped (orphaned) kq would
                        # leak the lease's resources on its node forever.
                        self._key_queues.pop(key, None)
                        if kq.block is not None:
                            # The key went idle: hand the admission
                            # budget back instead of pinning it at the
                            # node until TTL.
                            doomed_blocks.append(kq.block.block_id)
                            kq.block = None
            for bid in doomed_blocks:
                self._revoke_block_async(bid)
            for l in to_release:
                # BROKEN leases are returned too: "broken" only means OUR
                # connection to the worker died — if the worker is actually
                # alive (transient conn loss), skipping the return would
                # leave its resources debited on the node forever.
                # pool_worker=False for broken ones: the worker may still
                # be executing the re-routed tasks' original copies, so the
                # node terminates it instead of pooling it (double-dispatch).
                try:
                    # Acked + retried: a lost return would leak the
                    # lease's resources on the node forever.
                    self._pool.get(l.node_addr).retrying_call(
                        "return_lease", l.lease_id, not l.broken,
                        timeout=cfg.rpc_control_timeout_s)
                except Exception:
                    pass

    def _return_all_leases(self, deadline: float) -> None:
        """Hand every lease this owner holds back to its node: a node
        keeps a lease, and the worker and resources under it, until its
        lessee returns it, so a driver that joined a cluster and exits
        must not leave its leases behind (the next owner's task would
        find the worker taken). An idle lease's worker goes back to its
        pool; one with tasks in flight is terminated by its node."""
        with self._lease_lock:
            held = [l for kq in self._key_queues.values() for l in kq.leases]
            for kq in self._key_queues.values():
                kq.leases[:] = []
        for l in held:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                self._pool.get(l.node_addr).call(
                    "return_lease", l.lease_id,
                    not l.broken and l.inflight <= 0,
                    timeout=min(2.0, left))
            except Exception:  # a dead node took its leases with it
                pass

    def _report_backlog(self) -> None:
        entries = []
        with self._lease_lock:
            for kq in self._key_queues.values():
                # Demand = undispatched queue + tasks PIPELINED onto leases
                # beyond what they can run (1 task per lease executes; the
                # rest wait in the worker's slot queue).
                pipelined_waiting = sum(max(0, l.inflight - 1)
                                        for l in kq.leases if not l.broken)
                backlog = len(kq.queue) + pipelined_waiting
                if backlog > 0:
                    resources = dict(kq.key[1]) if len(kq.key) > 1 else {}
                    strat = None
                    if kq.queue:
                        info = kq.queue[0][1]
                        resources = dict(info.resources)
                        strat = info.strategy
                    # Label-constrained backlogs carry the constraint:
                    # the autoscaler must not satisfy them with capacity
                    # that can never match (see Autoscaler._labels_match).
                    if strat and strat.get("kind") == "node_label" \
                            and strat.get("hard"):
                        resources["_labels"] = tuple(
                            sorted(tuple(p) for p in strat["hard"]))
                    entries.append((resources, backlog))
        if entries or getattr(self, "_backlog_was_nonempty", False):
            self._backlog_was_nonempty = bool(entries)
            self.head.notify("report_backlog",
                             self.worker_id.hex(), entries)
        # Ship completed-task events to the head (cluster-wide list_tasks;
        # reference: TaskEventBuffer periodic flush to GcsTaskManager).
        if self._task_event_outbox:
            events = []
            while self._task_event_outbox and len(events) < 2000:
                try:
                    events.append(self._task_event_outbox.popleft())
                except IndexError:
                    break
            try:
                self.head.notify("report_task_events",
                                 self.owner_addr, events)
            except Exception:
                pass  # best-effort observability; next sweep retries new ones

    def cancel(self, ref: ObjectRef, force: bool = False,
               recursive: bool = True):
        """Cancel the task that produces `ref`: tasks waiting on their
        arguments or queued are failed with TaskCancelledError
        immediately; dispatched ones get a cancel RPC to their worker —
        cooperative by default (skipped if not yet started; running user
        code is never preempted), while ``force=True`` kills the executing worker the way the reference's
        ray.cancel(force=True) does (core_worker Cancel path +
        force_kill): the conn-lost re-enqueue then converts the task to
        TaskCancelledError at re-dispatch."""
        from ray_tpu_torch.exceptions import TaskCancelledError

        task_id = ref.id().task_id()
        tid_bytes = task_id.binary()
        # Mark FIRST (closes the race with a concurrent dispatch: the
        # push path re-checks _cancelled right before pushing), then
        # remove from queues. _mark_cancelled notifies the dispatched
        # worker exactly once (pending there -> skipped; running + force
        # -> worker exits and the re-dispatch converts the task to
        # TaskCancelledError).
        self._mark_cancelled(task_id, force=force)
        # Still waiting on an argument, or queued? Remove + fail its
        # returns.
        if self._cancel_waiting(tid_bytes):
            return
        with self._lease_lock:
            for kq in self._key_queues.values():
                for entry in list(kq.queue):
                    if entry[0] == tid_bytes:
                        kq.queue.remove(entry)
                        err = TaskCancelledError(
                            f"task {entry[1].name} cancelled")
                        for oid in entry[1].return_ids:
                            self.memory_store.put(oid, err,
                                                  is_exception=True)
                        self._release_submitted_args(tid_bytes)
                        return

    # ------------------------------------------------------------------ actors

    def create_actor(self, cls, args, kwargs, *, name: Optional[str] = None,
                     namespace: str = "default", max_concurrency: int = 1,
                     max_restarts: int = 0, max_task_retries: int = 0,
                     resources=None, lifetime=None,
                     scheduling_strategy=None, get_if_exists: bool = False,
                     runtime_env=None, release_resources: bool = False,
                     concurrency_groups: Optional[Dict[str, int]] = None,
                     allow_out_of_order_execution: bool = False,
                     ) -> ActorID:
        from ray_tpu_torch.core.runtime_env import validate_runtime_env

        runtime_env = validate_runtime_env(runtime_env)
        resources = _as_resource_dict(resources)
        # Only a DEFAULTED actor (no explicit resources) costs 1 CPU to
        # schedule (released at mark_actor_host). An explicit num_cpus=0
        # actor schedules with zero demand (reference: ray_option_utils —
        # actors default num_cpus=1 for scheduling, 0 for running, but an
        # explicit 0 is honored as 0).
        if release_resources:
            resources.setdefault("CPU", 1.0)
        actor_id = ActorID.of(self.job_id)
        spec_blob = SERIALIZER.encode({
            "cls": cls, "args": tuple(args), "kwargs": dict(kwargs),
            "max_concurrency": max_concurrency,
            "concurrency_groups": dict(concurrency_groups or {}),
            "owner_addr": self.owner_addr,
            "release_resources": release_resources,
            "out_of_order": bool(allow_out_of_order_execution),
        })
        # Constructor-arg refs must outlive this call: the head re-ships
        # spec_blob on every actor RESTART, long after the caller's local
        # refs are gone. Held until the actor is terminally dead.
        self._register_submitted_args(b"actor-args:" + actor_id.binary(),
                                      args, kwargs)
        try:
            status, existing = self.head.retrying_call(
                "register_actor", actor_id.binary(), name, namespace,
                spec_blob, max_restarts, resources, get_if_exists,
                _strategy_dict(scheduling_strategy), runtime_env,
                max_task_retries,
                timeout=cfg.actor_connect_timeout_s)
        except BaseException:
            self._release_submitted_args(b"actor-args:" + actor_id.binary())
            raise
        if status == "exists":
            self._release_submitted_args(b"actor-args:" + actor_id.binary())
            return ActorID(existing)
        self._actor_classes[actor_id] = cls
        return actor_id

    def _actor_conn(self, actor_id: ActorID) -> _ActorConn:
        with self._actors_lock:
            conn = self._actors.get(actor_id)
            if conn is None:
                reason = self._dead_actor_reasons.get(actor_id)
                if reason is not None:
                    # Retired actor: hand back an EPHEMERAL dead conn
                    # (not registered — registering would re-leak the
                    # entry retirement just reclaimed). Callers fail
                    # fast on conn.dead exactly as before.
                    conn = _ActorConn(actor_id)
                    conn.dead = True
                    conn.death_reason = reason
                    return conn
                conn = _ActorConn(actor_id)
                self._actors[actor_id] = conn
            return conn

    def _retire_actor_conn(self, conn: _ActorConn) -> None:
        """Drop a DEAD actor's conn from the registry. The _actors dict
        held one _ActorConn (pending map, sender state, address) per
        actor ever called, forever, on the driver side. The bounded memo
        preserves the death reason for late callers; beyond the cap the oldest retirement is forgotten
        and a late call re-resolves against the head (which also
        answers DEAD)."""
        with self._actors_lock:
            self._actors.pop(conn.actor_id, None)
            memo = self._dead_actor_reasons
            memo[conn.actor_id] = conn.death_reason or "actor died"
            memo.move_to_end(conn.actor_id)
            while len(memo) > 4096:
                memo.popitem(last=False)

    def _resolve_actor_address(self, conn: _ActorConn,
                               timeout: Optional[float] = None
                               ) -> Optional[str]:
        """Blocks until the head reports the actor ALIVE (the restart-
        pending QUEUE window: callers park here while a max_restarts
        re-creation is in flight, bounded by
        actor_restart_queue_timeout_s)."""
        if conn.address is not None:
            return conn.address
        if timeout is None:
            timeout = cfg.actor_restart_queue_timeout_s
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            # Short long-poll rounds (read-only, retry-safe under chaos);
            # round length clipped to the remaining window so a short
            # restart-pending timeout is honored at ~its own granularity.
            poll = max(0.5, min(10.0, deadline - time.monotonic()))
            try:
                state, payload = self.head.call(
                    "wait_actor_address", conn.actor_id.binary(), poll,
                    timeout=poll + 5)
            except ConnectionLost:
                time.sleep(0.2)  # dead socket fails instantly: no hot spin
                try:
                    self.head.reconnect()
                except OSError:
                    pass
                continue
            except TimeoutError:
                continue
            if state == "ALIVE":
                conn.address = payload
                return payload
            if state == "DEAD":
                conn.dead = True
                conn.death_reason = payload
                # Retire here too: an actor first discovered dead at
                # resolution (worker died before any conn existed, or a
                # memo-evicted late call re-resolving) would otherwise
                # park its conn in _actors forever — the exact leak
                # retirement exists to close. The conn object stays
                # valid for the caller failing its pending entries.
                self._retire_actor_conn(conn)
                return None
            # PENDING: keep waiting until our own deadline.
        return None

    def submit_actor_task(self, actor_id: ActorID, method_name: str, args,
                          kwargs, num_returns: int = 1) -> List[ObjectRef]:
        task_id = TaskID.for_task(actor_id)
        return_ids = [ObjectID.for_task_return(task_id, i)
                      for i in range(num_returns)]
        for oid in return_ids:
            self.refcount.add_owned_object(oid)
        refs = [ObjectRef(oid, self.owner_addr) for oid in return_ids]
        conn = self._actor_conn(actor_id)

        if method_name == "__ray_terminate__":
            self.kill_actor(actor_id, no_restart=True)
            for oid in return_ids:
                self.memory_store.put(oid, None)
            return refs

        # Positional tuple spec (decoded into a dict worker-side): control
        # frames are encode-bound at high call rates, and a 7-tuple pickles
        # materially cheaper/smaller than a 7-key dict.
        blob = SERIALIZER.encode((
            task_id.binary(), actor_id.binary(), method_name,
            tuple(args), dict(kwargs),
            [o.binary() for o in return_ids], self.owner_addr))
        self._register_submitted_args(task_id.binary(), args, kwargs)
        _metrics.ACTOR_CALLS.inc()
        # Seq assignment + enqueue are synchronous with the caller: two
        # sequential .remote() calls CANNOT be reordered (the sender thread
        # drains in seq order).
        with conn.lock:
            seq = conn.next_seq
            conn.next_seq += 1
            conn.pending[seq] = (task_id.binary(), blob, return_ids)
            conn.outbound.append((seq, task_id.binary(), blob, return_ids))
            start_sender = not conn.sender_running
            if start_sender:
                conn.sender_running = True
        if start_sender:
            threading.Thread(target=self._actor_sender_loop, args=(conn,),
                             daemon=True,
                             name=f"actor-send-{actor_id.hex()[:8]}").start()
        return refs

    def _actor_sender_loop(self, conn: _ActorConn) -> None:
        """Single per-actor sender: drains queued calls in seq order as
        BATCHES — one `push_actor_batch` frame per burst (pipelined, acked)
        over one pooled connection — then services unacked batches: a batch
        ack lost to chaos is retried (the worker dedups and re-orders via
        the min_pending horizon). Any failure fails the affected calls and
        moves on — the sender thread itself must never die with
        sender_running stuck True (that would wedge the actor)."""
        while True:
            batch: List[tuple] = []
            with conn.lock:
                if not conn.outbound and not conn.unacked:
                    conn.sender_running = False
                    return
                # A conn-loss handler may have failed a seq while it was
                # still queued (actor died/restarted before we sent it):
                # failed-then-executed would duplicate side effects on the
                # new incarnation, so never send a seq no longer pending.
                while conn.outbound and len(batch) < cfg.actor_send_batch_max:
                    item = conn.outbound.popleft()
                    if item[0] in conn.pending:
                        batch.append(item)
            try:
                if batch:
                    self._send_actor_batch(conn, batch, 0)
                    # Opportunistically reap acked heads to bound unacked.
                    # Pops ride conn.lock (and never span the settle,
                    # which may resend = block): a replay handler
                    # snapshots this deque from another thread, and a
                    # bare mutation mid-snapshot raises RuntimeError in
                    # exactly the recovery path that must not die.
                    while True:
                        with conn.lock:
                            if not (conn.unacked
                                    and conn.unacked[0][1]._event.is_set()):
                                break
                            entry = conn.unacked.popleft()
                        self._settle_actor_ack(conn, entry)
                    continue
                entry = conn.unacked[0]
                if entry[1]._event.wait(0.05):
                    with conn.lock:
                        conn.unacked.popleft()
                    self._settle_actor_ack(conn, entry)
                elif time.monotonic() > entry[3]:
                    with conn.lock:
                        conn.unacked.popleft()
                    self._resend_actor_batch(conn, entry)
            except BaseException:  # noqa: BLE001 — keep the sender alive
                for it in batch:
                    self._fail_actor_call(conn, it[0])

    def _send_actor_batch(self, conn: _ActorConn, items: List[tuple],
                          tries: int) -> None:
        """items: [(seq, task_id_bytes, blob, return_ids)]. One RPC frame
        carries the whole burst; the unacked entry tracks the batch."""
        if conn.dead:
            for it in items:
                self._fail_actor_call(conn, it[0])
            return
        try:
            addr = self._resolve_actor_address(conn)
        except Exception:
            addr = None
        if addr is None:
            reason = (None if conn.dead else
                      "actor restart still pending after "
                      f"{cfg.actor_restart_queue_timeout_s:.0f}s")
            for it in items:
                self._fail_actor_call(conn, it[0], reason=reason)
            return
        with conn.lock:
            live = [it for it in items if it[0] in conn.pending]
        if not live:
            return
        with self._inflight_lock:
            for seq, task_id_bytes, blob, rids in live:
                self._inflight[task_id_bytes] = _InflightTask(
                    blob, rids, addr, 0, ("actor", conn.actor_id),
                    {}, None, "actor_task")
        try:
            waiter = self._pool.get(
                addr, on_close=self._on_worker_conn_lost).call_async(
                    "push_actor_batch",
                    [(it[0], it[2]) for it in live], conn.min_pending())
            # 2s resend deadline: worker-side dedup makes resends free, and
            # a chaos-dropped frame must not stall the whole batch 10s.
            with conn.lock:
                conn.unacked.append([live, waiter, tries,
                                     time.monotonic() + 2.0])
        except (ConnectionLost, OSError):
            self._handle_actor_conn_lost(conn)

    def _settle_actor_ack(self, conn: _ActorConn, entry) -> None:
        try:
            entry[1].wait(0)
        except BaseException:
            self._resend_actor_batch(conn, entry)

    def _resend_actor_batch(self, conn: _ActorConn, entry) -> None:
        items, _, tries, _ = entry
        with conn.lock:
            live = [it for it in items if it[0] in conn.pending]
        if not live:
            return
        if tries >= 10:
            for it in live:
                self._fail_actor_call(conn, it[0])
            return
        self._send_actor_batch(conn, live, tries + 1)

    def _fail_actor_call(self, conn: _ActorConn, seq: int,
                         reason: Optional[str] = None) -> None:
        with conn.lock:
            entry = conn.pending.pop(seq, None)
            conn.replays.pop(seq, None)
        if entry is None:
            return
        task_id_bytes, _, return_ids = entry
        with self._inflight_lock:
            self._inflight.pop(task_id_bytes, None)
        self._release_submitted_args(task_id_bytes)
        err = ActorDiedError(conn.actor_id,
                             reason or conn.death_reason or "actor died")
        for oid in return_ids:
            self.memory_store.put(oid, err, is_exception=True)

    def rpc_actor_call_done(self, conn_ctx, actor_id_bytes: bytes, seq: int,
                            task_id_bytes: bytes,
                            results: List[Tuple[bytes, str, Any]],
                            span: Optional[Tuple[float, float, str]] = None):
        aconn = self._actor_conn(ActorID(actor_id_bytes))
        with aconn.lock:
            aconn.pending.pop(seq, None)
            aconn.replays.pop(seq, None)
        return self.rpc_task_done(conn_ctx, task_id_bytes, results, span)

    def _handle_actor_conn_lost(self, conn: _ActorConn) -> None:
        """Connection to the actor's worker died: consult the head.

        Two policies, switched by the actor's ``max_restarts`` (the head
        reports it as ``at_least_once``):

        - max_restarts == 0 (default): in-flight calls FAIL — a call
          that may already have executed is never replayed (reference
          semantics, max_task_retries=0).
        - max_restarts > 0: the actor is declared restartable, so its
          callers opted into at-least-once calls — every still-pending
          seq REPLAYS against the restarted incarnation, in seq order,
          through the same sender machinery. The worker-side
          (caller, seq) horizon + reply memo turn the at-least-once
          wire into exactly-once execution per incarnation; only calls
          whose execution-and-results were lost WITH the old
          incarnation run again.

        Restart-pending windows QUEUE, not fail: while the head reports
        PENDING/RESTARTING this handler keeps waiting (and new submits
        keep queueing in outbound) until actor_restart_queue_timeout_s.
        """
        with conn.lock:
            if conn.loss_handling:
                return  # another thread owns this conn's recovery
            conn.loss_handling = True
            stale_addr = conn.address
            conn.address = None
        try:
            self._handle_actor_conn_lost_inner(conn, stale_addr)
        finally:
            with conn.lock:
                conn.loss_handling = False

    def _handle_actor_conn_lost_inner(self, conn: _ActorConn,
                                      stale_addr: Optional[str]) -> None:
        # Same window as the sibling loss path (_send_actor_batch ->
        # _resolve_actor_address): both must honor the configured
        # restart-pending queueing timeout EXACTLY, or the two paths
        # fail identical calls at different times with a reason naming
        # a wait that never happened.
        deadline = time.monotonic() + cfg.actor_restart_queue_timeout_s
        while time.monotonic() < deadline:
            try:
                info = self.head.retrying_call("get_actor_info",
                                               conn.actor_id.binary(), timeout=10)
            except Exception as e:
                # Head unreachable (mid-restart/upgrade): keep polling
                # until our own deadline — the restart-pending window.
                logger.debug("actor info poll failed (head down?): %r", e)
                time.sleep(0.5)
                continue
            if info is None:
                conn.dead = True
                conn.death_reason = "unknown actor"
                self._release_submitted_args(
                    b"actor-args:" + conn.actor_id.binary())
                break
            if info["state"] == "ALIVE" and info["address"]:
                if info["address"] == stale_addr:
                    # Head hasn't noticed the death yet; keep polling.
                    time.sleep(0.2)
                    continue
                conn.address = info["address"]
                if info.get("at_least_once"):
                    conn.incarnation = int(info.get("restarts", 0))
                    self._replay_actor_calls(
                        conn, int(info.get("max_task_retries", 0)))
                    return
                conn.death_reason = ("actor restarted; in-flight calls "
                                     "failed (max_task_retries=0)")
                with conn.lock:
                    seqs = list(conn.pending)
                for seq in seqs:
                    self._fail_actor_call(conn, seq)
                return
            if info["state"] == "DEAD":
                conn.dead = True
                conn.death_reason = info["reason"] or "actor died"
                self._release_submitted_args(
                    b"actor-args:" + conn.actor_id.binary())
                break
            time.sleep(0.2)  # PENDING/RESTARTING: wait (queued callers)
        with conn.lock:
            seqs = list(conn.pending)
        for seq in seqs:
            self._fail_actor_call(
                conn, seq,
                reason=None if conn.dead else
                "actor restart still pending after "
                f"{cfg.actor_restart_queue_timeout_s:.0f}s")
        if conn.dead:
            self._retire_actor_conn(conn)

    def _replay_actor_calls(self, conn: _ActorConn,
                            max_task_retries: int = -1) -> None:
        """Re-enqueue every still-pending call for the actor's new
        incarnation. Seqs already queued in outbound (new submits that
        parked during the restart) merge in — the rebuilt outbound is
        sorted so the wire carries one ascending stream. Seqs riding an
        unacked batch are NOT re-enqueued here: their resend deadline
        re-drives them through _send_actor_batch against the new
        address, and a duplicate send is dedup'd by the worker's
        (caller, seq) horizon anyway. Each seq replays at most
        max_task_retries times across incarnations (<0 = unlimited) —
        the poison-call bound."""
        exhausted: List[int] = []
        with conn.lock:
            # Snapshot under the lock the sender's unacked mutations
            # also hold: a bare deque iteration racing an append/pop
            # raises RuntimeError in exactly this recovery path.
            inflight: set = set()
            for entry in conn.unacked:
                for it in entry[0]:
                    inflight.add(it[0])
            items = {it[0]: it for it in conn.outbound}
            for seq, (tid, blob, rids) in conn.pending.items():
                if seq in items or seq in inflight:
                    continue
                n = conn.replays.get(seq, 0) + 1
                if max_task_retries >= 0 and n > max_task_retries:
                    exhausted.append(seq)
                    continue
                conn.replays[seq] = n
                items[seq] = (seq, tid, blob, rids)
            conn.outbound.clear()
            for seq in sorted(items):
                conn.outbound.append(items[seq])
            replayed = len(items)
            start = (not conn.sender_running
                     and bool(conn.outbound or conn.unacked))
            if start:
                conn.sender_running = True
        for seq in exhausted:
            self._fail_actor_call(
                conn, seq,
                reason=f"call replayed {max_task_retries}x across actor "
                       "restarts without completing (max_task_retries)")

        if start:
            threading.Thread(
                target=self._actor_sender_loop, args=(conn,), daemon=True,
                name=f"actor-send-{conn.actor_id.hex()[:8]}").start()

    def get_actor(self, name: str, namespace: str = "default") -> ActorID:
        found = self.head.retrying_call("get_named_actor", name, namespace, timeout=10)
        if found is None:
            raise ValueError(f"no actor named '{name}' in namespace "
                             f"'{namespace}'")
        aid, spec_blob = found
        actor_id = ActorID(aid)
        if actor_id not in self._actor_classes:
            self._actor_classes[actor_id] = SERIALIZER.decode(spec_blob)["cls"]
        return actor_id

    def actor_class_of(self, actor_id: ActorID):
        return self._actor_classes.get(actor_id)

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True) -> None:
        try:
            self.head.retrying_call("kill_actor", actor_id.binary(), no_restart,
                                     timeout=10)
        except Exception:
            pass
        conn = self._actor_conn(actor_id)
        conn.dead = True
        conn.death_reason = "killed via ray_tpu_torch.kill"
        conn.address = None
        self._release_submitted_args(b"actor-args:" + actor_id.binary())
        with conn.lock:
            seqs = list(conn.pending)
        for seq in seqs:
            self._fail_actor_call(conn, seq)
        self._retire_actor_conn(conn)

    def list_actors(self):
        return self.head.retrying_call("list_actors", timeout=10)

    # ------------------------------------------------------------------ pgs

    def create_placement_group(self, spec: PlacementGroupSpec) -> None:
        ok = self.head.retrying_call(
            "create_pg", spec.pg_id.binary(),
            [b.resources.to_dict() for b in spec.bundles],
            spec.strategy, spec.name, timeout=30)
        if not ok:
            raise RuntimeError(
                f"placement group creation failed: {spec.strategy}")
        self._pgs[spec.pg_id] = spec

    def placement_group_ready(self, pg_id: PlacementGroupID,
                              timeout=None) -> bool:
        return bool(self.head.retrying_call("pg_ready", pg_id.binary(), timeout=10))

    def remove_placement_group(self, pg_id: PlacementGroupID) -> None:
        self.head.retrying_call("remove_pg", pg_id.binary(), timeout=10)
        self._pgs.pop(pg_id, None)

    def placement_group_table(self):
        return self.head.retrying_call("pg_table", timeout=10)

    # ------------------------------------------------------------------ misc

    def nodes(self):
        return self.head.retrying_call("list_nodes", timeout=10)

    def cluster_resources(self) -> Dict[str, float]:
        total, _ = self.head.retrying_call("cluster_resources", timeout=10)
        return total

    def available_resources(self) -> Dict[str, float]:
        _, avail = self.head.retrying_call("cluster_resources", timeout=10)
        return avail

    def shutdown(self) -> None:
        if self._shutdown_flag:
            return
        self._shutdown_flag = True
        try:
            # Last-gasp directory sync: queued adds/removes still flush so
            # the head's view doesn't miss this owner's final objects.
            self._flush_object_notifies()
        except Exception:
            pass
        # Hand lease blocks back: a dead owner's blocks would otherwise
        # pin admission budget at their nodes until the TTL backstop.
        with self._lease_lock:
            final_blocks = [kq.block.block_id
                            for kq in self._key_queues.values()
                            if kq.block is not None]
            for kq in self._key_queues.values():
                kq.block = None
        revoke_deadline = time.monotonic() + 5.0
        for bid in final_blocks:
            left = revoke_deadline - time.monotonic()
            if left <= 0:
                break  # TTL expiry reclaims the rest; don't stall exit
            try:
                self.head.retrying_call("lease_block_revoke", bid,
                                        timeout=min(2.0, left))
            except Exception:  # rtpu-lint: disable=swallowed-exception — best-effort: TTL expiry is the backstop at head and node
                pass
        if not getattr(self, "_owns_cluster", True):
            # A driver that joined a cluster (``ClusterRuntime``) returns
            # its leases: the cluster outlives it. One that started the
            # cluster ends it instead.
            self._return_all_leases(deadline=time.monotonic() + 5.0)
        self._server.stop()
        self._pool.close_all()
        # _shutdown_flag is set above: the reaper's next 50ms lap exits.
        self._lease_reaper.join(timeout=2.0)
        for c in (self.head, self.node):
            try:
                c.close()
            except Exception:
                pass
        try:
            self.store.close()
        except Exception:
            pass
        # RTPU_DEBUG_RES balance assertion: this core's tracked threads
        # must have exited by now (the reaper was joined above); the
        # check reports and never blocks teardown.
        _resdbg.check_balanced("cluster_core.shutdown", kinds=("thread",),
                               owner=self)
        runtime_context.set_runtime(None)


def _scan_object_refs(obj, out: List[ObjectID], depth: int = 0) -> None:
    """Collect ObjectIDs of every ObjectRef reachable through plain
    containers in task args (bounded depth: refs buried deeper inside
    arbitrary user objects are covered by borrower registration instead)."""
    if depth > 6:
        return
    if isinstance(obj, ObjectRef):
        out.append(obj.id())
        return
    if isinstance(obj, (list, tuple, set, frozenset)):
        for v in obj:
            _scan_object_refs(v, out, depth + 1)
    elif isinstance(obj, dict):
        for k, v in obj.items():
            _scan_object_refs(k, out, depth + 1)
            _scan_object_refs(v, out, depth + 1)


def _as_resource_dict(resources) -> Dict[str, float]:
    if resources is None:
        return {}
    if hasattr(resources, "to_dict"):
        return dict(resources.to_dict())
    return dict(resources)


def _strategy_dict(strategy) -> Optional[Dict[str, Any]]:
    """Normalize a scheduling strategy object/string to the wire dict."""
    if strategy is None:
        return None
    if isinstance(strategy, dict):
        return strategy
    if isinstance(strategy, str):
        if strategy == "SPREAD":
            return {"kind": "spread"}
        if strategy == "DEFAULT":
            return None
        raise ValueError(f"unknown scheduling strategy {strategy!r}")
    kind = type(strategy).__name__
    if kind == "PlacementGroupSchedulingStrategy":
        return {"kind": "placement_group",
                "pg_id": strategy.placement_group.id.binary(),
                "bundle_index":
                    getattr(strategy, "placement_group_bundle_index", -1)}
    if kind == "NodeAffinitySchedulingStrategy":
        return {"kind": "node_affinity", "node_id": strategy.node_id,
                "soft": getattr(strategy, "soft", False)}
    if kind == "NodeLabelSchedulingStrategy":
        return {"kind": "node_label",
                "hard": tuple(dict(strategy.hard).items()
                              if not isinstance(strategy.hard, tuple)
                              else strategy.hard),
                "soft": tuple(dict(strategy.soft).items()
                              if not isinstance(strategy.soft, tuple)
                              else strategy.soft)}
    raise ValueError(f"unknown scheduling strategy {strategy!r}")


_spread_rr_counter = itertools.count()


def _sched_key(func, resources: Dict[str, float], strategy) -> tuple:
    fid = getattr(func, "__qualname__", repr(func))
    strat_part = (tuple(sorted((strategy or {}).items(),
                               key=lambda kv: str(kv[0])))
                  if strategy else None)
    if strategy and strategy.get("kind") == "spread":
        # Spread tasks must NOT share worker leases (lease reuse would pack
        # them); rotate across a few keys so each requests its own lease.
        strat_part = strat_part + (("rr", next(_spread_rr_counter) % 8),)
    return (fid, tuple(sorted(resources.items())), strat_part)
