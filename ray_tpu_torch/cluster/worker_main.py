"""Worker process entry point + task/actor execution engine.

Parity target: the reference's default worker + task receiver (reference:
python/ray/_private/workers/default_worker.py, core worker TaskReceiver
src/ray/core_worker/transport/task_receiver.cc:36, ActorSchedulingQueue, and
execute_task in python/ray/_raylet.pyx:1716): connects to its node manager +
head, embeds a full ClusterCore (so nested ray_tpu_torch.get/put/remote inside
tasks go through the cluster), and executes pushed tasks/actor methods.

Execution semantics match the single-process runtime: normal tasks run on a
small pool; each hosted actor gets ordered execution with max_concurrency
threads (async actors get an asyncio loop); results go back to the OWNER via
task_done pushes — small values inline, big ones sealed into the node's shm
store with a location stub.
"""

from __future__ import annotations

import argparse
import collections
import inspect
import logging
import os
import sys
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.cluster.protocol import ConnectionLost
from ray_tpu_torch.core import runtime_context
from ray_tpu_torch.core.cluster_core import ClusterCore
from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg
from ray_tpu_torch.core.ids import ActorID, JobID, ObjectID, TaskID
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.serialization import SERIALIZER, capture_exception
from ray_tpu_torch.cluster.protocol import ClientPool
from ray_tpu_torch.exceptions import ActorDiedError, RayTpuError, TaskError

logger = logging.getLogger(__name__)


class _OrderState:
    """Per-(actor, submitter) in-order delivery: buffers out-of-order seqs
    (a chaos-dropped push retried late must not execute after its successor)
    and dedups retries. Parity: the reference's ActorSchedulingQueue +
    sequence_no/client_processed_up_to (task_receiver.cc:36).

    ``done`` is the at-least-once reply memo: completed calls' result
    batches keyed by seq, LRU-bounded by ``actor_reply_memo_max``. A
    duplicate delivery of an already-executed seq (lost push ack, a
    replay racing the original's completion) re-ships the memoized
    results instead of re-executing — owner-side completion handlers
    are first-write-wins, so a double delivery of RESULTS is free while
    a double EXECUTION of a mutating method is not. Entries below the
    submitter's min_pending horizon are pruned (the submitter settled
    those seqs; no retry can ever ask for them again)."""

    __slots__ = ("expected", "buf", "done")

    def __init__(self):
        self.expected: Optional[int] = None
        self.buf: Dict[int, Any] = {}
        self.done: "collections.OrderedDict[int, tuple]" = \
            collections.OrderedDict()


class _HostedActor:
    def __init__(self, actor_id: ActorID, instance: Any, max_concurrency: int,
                 is_async: bool,
                 concurrency_groups: Optional[Dict[str, int]] = None,
                 out_of_order: bool = False):
        self.actor_id = actor_id
        self.instance = instance
        self.max_concurrency = max_concurrency
        # Out-of-order execution (reference:
        # out_of_order_actor_submit_queue.h): calls run as they ARRIVE —
        # a chaos-delayed seq never gates its successors. Dedup still
        # applies (at-least-once pushes), ordering guarantees don't.
        self.out_of_order = out_of_order
        self.is_async = is_async
        self.lock = threading.Lock()
        self.pool = ThreadPoolExecutor(
            max_workers=max_concurrency,
            thread_name_prefix=f"actor-{actor_id.hex()[:8]}")
        # Concurrency groups (reference: concurrency_group_manager.h):
        # each named group gets its OWN executor with its own cap, so one
        # group's saturation never blocks another's methods; within a
        # group, submissions stay FIFO (size-1 groups are strictly
        # ordered). Methods route via @ray_tpu_torch.method(concurrency_group=).
        self.group_pools: Dict[str, ThreadPoolExecutor] = {}
        for gname, gsize in (concurrency_groups or {}).items():
            self.group_pools[gname] = ThreadPoolExecutor(
                max_workers=max(1, int(gsize)),
                thread_name_prefix=f"actor-{actor_id.hex()[:8]}-{gname}")
        self._method_groups: Dict[str, str] = {}
        for mname in dir(type(instance)):
            m = getattr(type(instance), mname, None)
            g = getattr(m, "__ray_tpu_concurrency_group__", None)
            if g is not None:
                self._method_groups[mname] = g
        self.loop = None
        # owner_addr -> per-caller stream state, LRU-bounded
        # (actor_order_states_max): a service actor called by thousands
        # of short-lived drivers must not pin one state per caller ever
        # seen — least-recently-active streams are evicted (their memo
        # goes with them; a retry after THAT long re-executes, which is
        # the documented at-least-once floor).
        self.order: "collections.OrderedDict[str, _OrderState]" = \
            collections.OrderedDict()
        self.order_lock = threading.Lock()
        self.dead = False

    def pool_for(self, method_name: str) -> ThreadPoolExecutor:
        group = self._method_groups.get(method_name)
        if group is None:
            return self.pool
        pool = self.group_pools.get(group)
        if pool is None:
            # Undeclared group on the actor: fall back to the default
            # pool rather than failing the call.
            return self.pool
        return pool


class WorkerRuntime(ClusterCore):
    """ClusterCore + execution-side RPC handlers."""

    def __init__(self, head_addr: str, node_addr: str, node_id: str,
                 store_name: str, worker_id_hex: str):
        super().__init__(head_addr, node_addr, node_id, store_name,
                         JobID.from_int(1), is_driver=False)
        self._exec_pool = ThreadPoolExecutor(
            max_workers=cfg.worker_exec_pool_size,
            thread_name_prefix="task-exec")
        # ONE normal-task execution slot: the lease this worker serves is
        # sized for a single task's resources, so pipelined pushes QUEUE
        # here and execute serially (running them all concurrently
        # oversubscribed the node: 16 x 2-CPU tasks on a 2-CPU lease).
        # A task blocked in get()/wait() yields the slot (the nested-task
        # reentrancy the reference gets from blocked-worker resource
        # release), tracked per-thread so nested blocked scopes release
        # exactly once.
        self._task_slot = threading.Semaphore(1)
        self._slot_state = threading.local()
        self._hosted: Dict[ActorID, _HostedActor] = {}
        self._hosted_lock = threading.Lock()
        self._owner_pool = ClientPool()
        # Dedup for retried pushes (the submitter retries an unacked push;
        # at-least-once delivery + this set = exactly-once execution here).
        self._seen_tasks: set = set()
        self._seen_order = collections.deque()
        self._seen_lock = threading.Lock()
        # Per-owner completion flushers: one dead/unreachable owner must not
        # head-of-line block completion delivery to every other owner.
        self._done_flushers: Dict[str, tuple] = {}
        self._done_lock = threading.Lock()
        # Cooperative cancellation: ids cancelled before execution start
        # are skipped (running user code is never preempted — reference
        # semantics for non-force cancel). FIFO-bounded like _seen_tasks.
        self._cancelled: set = set()
        self._cancelled_order = collections.deque()
        # Task ids currently INSIDE user code: force-cancel consults this
        # to decide between a cooperative skip and a process kill.
        self._executing: set = set()
        # The runtime must be installed BEFORE registration: a lease can
        # arrive (and a task execute) the instant the node manager sees us.
        runtime_context.set_runtime(self)
        # register_worker returns False when the node manager has no entry
        # for this id — e.g. a zygote fork whose spawn request timed out
        # and was replaced by a cold spawn under a fresh id. Retry briefly
        # (the spawner inserts the _workers entry a beat after the process
        # starts), then exit rather than linger unsupervised.
        deadline = time.monotonic() + 10.0
        while not self.node.retrying_call("register_worker", worker_id_hex,
                                          self.owner_addr, timeout=10):
            if time.monotonic() >= deadline:
                print(f"worker {worker_id_hex[:8]} rejected by node "
                      "manager (stale spawn id); exiting", file=sys.stderr,
                      flush=True)
                raise SystemExit(0)
            time.sleep(0.25)

    def _seen_before(self, task_id_bytes: bytes) -> bool:
        with self._seen_lock:
            if task_id_bytes in self._seen_tasks:
                return True
            self._seen_tasks.add(task_id_bytes)
            self._seen_order.append(task_id_bytes)
            if len(self._seen_order) > cfg.worker_seen_tasks_max:
                self._seen_tasks.discard(self._seen_order.popleft())
            return False

    # ---------------------------------------------------------------- tasks

    def rpc_push_tasks(self, conn, pairs):
        """Batched push: one frame carries every task the dispatcher had
        ready for this lease (the reference pipelines PushNormalTask the
        same way via OnWorkerIdle bursts)."""
        for task_id_bytes, spec_blob in pairs:
            if not self._seen_before(task_id_bytes):
                self._exec_pool.submit(self._execute_task, spec_blob)
        return True

    def _on_task_blocked(self) -> None:
        ctx = runtime_context.current_worker_context()
        if ctx.get("actor_id") is not None or not getattr(
                self._slot_state, "holding", False):
            return
        depth = getattr(self._slot_state, "block_depth", 0)
        self._slot_state.block_depth = depth + 1
        if depth == 0:
            self._task_slot.release()

    def _on_task_unblocked(self) -> None:
        depth = getattr(self._slot_state, "block_depth", 0)
        if depth <= 0:
            return
        self._slot_state.block_depth = depth - 1
        if depth == 1:
            self._task_slot.acquire()

    def _execute_task(self, spec_blob: bytes) -> None:
        self._task_slot.acquire()
        self._slot_state.holding = True
        self._slot_state.block_depth = 0
        try:
            self._execute_task_inner(spec_blob)
        finally:
            self._slot_state.holding = False
            self._task_slot.release()

    def _execute_task_inner(self, spec_blob: bytes) -> None:
        spec, undecodable = SERIALIZER.decode_or_error(spec_blob)
        task_id = TaskID(spec["task_id"])
        return_ids = [ObjectID(b) for b in spec["return_ids"]]
        owner = spec["owner_addr"]
        name = spec.get("name", "task")
        t_start = time.time()
        if undecodable is not None:
            # An argument (a CUDA tensor) cannot be restored in this
            # process: the task fails at its get site, it is not lost.
            self._send_results(owner, task_id, return_ids,
                               error=capture_exception(undecodable),
                               span=(t_start, time.time(), name))
            return

        def span():
            # Every terminal send carries a span — failed tasks are the
            # ones operators most need to see in timeline/list_tasks.
            return (t_start, time.time(), name)

        attempt = 0
        # Context covers ARG RESOLUTION too: blocked scopes during arg
        # fetches must release the node resources + the execution slot, or
        # a task waiting for an upstream output would pin the worker.
        prev = runtime_context.set_worker_context({
            "task_id": task_id, "actor_id": None,
            "resources": spec.get("resources", {})})
        try:
            while True:
                try:
                    args, kwargs = self._resolve_args(spec["args"],
                                                      spec["kwargs"])
                except TaskError as te:
                    self._send_results(owner, task_id, return_ids,
                                       error=te, span=span())
                    return
                except BaseException as e:  # noqa: BLE001
                    self._send_results(owner, task_id, return_ids,
                                       error=capture_exception(e),
                                       span=span())
                    return
                if task_id.binary() in self._cancelled:
                    from ray_tpu_torch.exceptions import TaskCancelledError

                    self._send_results(owner, task_id, return_ids,
                                       error=TaskCancelledError(
                                           f"task {name} cancelled"),
                                       span=span())
                    return
                t_start = time.time()
                self._executing.add(task_id.binary())
                try:
                    func = (self._fetch_function(spec["func_digest"])
                            if "func_digest" in spec else spec["func"])
                    if spec.get("streaming"):
                        self._execute_streaming(
                            owner, task_id, func, args, kwargs,
                            span, spec.get("stream_ahead"))
                        return
                    result = func(*args, **kwargs)
                    self._send_results(owner, task_id, return_ids,
                                       value=result, span=span())
                    return
                except TaskError as te:
                    self._send_results(owner, task_id, return_ids, error=te,
                                       span=span())
                    return
                except BaseException as e:  # noqa: BLE001
                    attempt += 1
                    if spec.get("retry_exceptions") and attempt <= spec.get(
                            "max_retries", 0):
                        time.sleep(cfg.task_retry_delay_ms / 1000.0)
                        continue
                    self._send_results(owner, task_id, return_ids,
                                       error=capture_exception(e),
                                       span=span())
                    return
                finally:
                    self._executing.discard(task_id.binary())
        finally:
            runtime_context.set_worker_context(prev)


    def _execute_streaming(self, owner: str, task_id, func, args, kwargs,
                           span, stream_ahead=None) -> bool:
        """Run a streaming-generator task: each yield seals one object and
        ships to the owner INCREMENTALLY (reference: streaming-generator
        execution feeding task_manager.h:212 refs) — the full output never
        materializes on either side at once. Flow control is CONSUMER
        driven: past _STREAM_AHEAD_MAX unconsumed items the producer polls
        the owner's consumed counter and pauses (the flush queue alone is
        no gauge — the owner acks as fast as it buffers)."""
        from ray_tpu_torch.core.ids import ObjectID as _OID

        task_id_bytes = task_id.binary()
        # Per-task override (generator_backpressure_num_objects) beats the
        # global default — Data sizes it to the pipeline memory budget.
        # <= 0 disables backpressure (the reference's -1 sentinel).
        ahead_max = (int(stream_ahead) if stream_ahead is not None
                     else int(cfg.streaming_ahead_max))
        if ahead_max <= 0:
            ahead_max = float("inf")
        index = 0
        consumed = 0
        err = None
        cancelled = False
        poll_sleep = 0.02
        try:
            gen = func(*args, **kwargs)
            for item in gen:
                if task_id_bytes in self._cancelled:
                    cancelled = True
                    break
                oid = _OID.for_stream_return(task_id, index)
                header, buffers = SERIALIZER.serialize(item)
                total = SERIALIZER.encode_total_size(header, buffers)
                if total <= cfg.object_store_inline_max_bytes:
                    flat = bytearray(total)
                    SERIALIZER.encode_into(memoryview(flat), header,
                                           buffers)
                    rec = (oid.binary(), "value", bytes(flat))
                else:
                    self._put_plasma(oid, header, buffers)
                    # (node_id, size): the owner's locality cache feeds on
                    # where each sealed result lives.
                    rec = (oid.binary(), "in_store", (self.node_id, total))
                self._enqueue_done(owner, ("stream",
                                           (task_id_bytes, index, rec)))
                index += 1
                while (index - consumed > ahead_max and not cancelled):
                    try:
                        consumed = self._owner_pool.get(owner).call(
                            "stream_consumed", task_id_bytes, timeout=10)
                    except Exception as e:
                        logger.debug("stream_consumed poll to %s failed:"
                                     " %r; stop gating", owner, e)
                        consumed = index  # owner unreachable: stop gating
                        break
                    if consumed < 0:  # stream abandoned owner-side
                        cancelled = True
                        break
                    if index - consumed > ahead_max:
                        # Exponential poll backoff: a long-stalled
                        # consumer must not cost the owner 50 RPCs/s.
                        time.sleep(poll_sleep)
                        poll_sleep = min(0.5, poll_sleep * 1.6)
                    else:
                        poll_sleep = 0.02
                if cancelled:
                    break
            if cancelled and hasattr(gen, "close"):
                try:
                    gen.close()
                except Exception as e:
                    logger.debug("generator close after cancel raised: "
                                 "%r", e)
        except BaseException as e:  # noqa: BLE001 -> terminal record
            err = capture_exception(e)
        self._enqueue_done(owner, ("stream_end",
                                   (task_id_bytes, index, err, span())))
        return err is None

    def _resolve_args(self, args, kwargs):
        def res(a):
            if isinstance(a, ObjectRef):
                return self.get(a)
            return a

        return [res(a) for a in args], {k: res(v) for k, v in kwargs.items()}

    def _send_results(self, owner: str, task_id: TaskID,
                      return_ids: List[ObjectID], value: Any = None,
                      error: Optional[Exception] = None,
                      actor_ctx: Optional[Tuple[bytes, int]] = None,
                      span: Optional[Tuple[float, float, str]] = None) -> None:
        results: List[Tuple[bytes, str, Any]] = []
        if error is not None:
            for oid in return_ids:
                results.append((oid.binary(), "error", error))
        else:
            n = len(return_ids)
            vals: List[Any]
            if n == 0:
                vals = []
            elif n == 1:
                vals = [value]
            else:
                vals = (list(value) if isinstance(value, (tuple, list))
                        else [value])
                if len(vals) != n:
                    err = capture_exception(ValueError(
                        f"task declared {n} returns, produced {len(vals)}"))
                    return self._send_results(owner, task_id, return_ids,
                                              error=err, actor_ctx=actor_ctx)
            for oid, v in zip(return_ids, vals):
                header, buffers = SERIALIZER.serialize(v)
                total = SERIALIZER.encode_total_size(header, buffers)
                if total <= cfg.object_store_inline_max_bytes:
                    flat = bytearray(total)
                    SERIALIZER.encode_into(memoryview(flat), header, buffers)
                    results.append((oid.binary(), "value", bytes(flat)))
                else:
                    self._put_plasma(oid, header, buffers)
                    # Locality breadcrumb for the owner's dispatch.
                    results.append((oid.binary(), "in_store",
                                    (self.node_id, total)))
        # Batched + acked + retried via the flusher: a chaos-dropped
        # completion must not leave the owner waiting forever, and one
        # frame per completion was a single-core throughput ceiling.
        # Owner-side handlers are idempotent (memory-store puts are
        # first-write-wins, inflight pop guards the lease decrement).
        if actor_ctx is not None:
            actor_id_bytes, seq = actor_ctx
            entry = ("actor", (actor_id_bytes, seq, task_id.binary(),
                               results, span))
            # Reply memo: a duplicate delivery of this seq (lost ack /
            # replay racing completion) answers with THESE results
            # instead of re-executing (see _OrderState.done).
            self._memoize_actor_reply(owner, actor_id_bytes, seq, entry)
        else:
            entry = ("task", (task_id.binary(), results, span))
        self._enqueue_done(owner, entry)

    def _memoize_actor_reply(self, owner: str, actor_id_bytes: bytes,
                             seq: int, entry: tuple) -> None:
        with self._hosted_lock:
            hosted = self._hosted.get(ActorID(actor_id_bytes))
        if hosted is None:
            return  # killed mid-call / "not hosted" error reply: no memo
        with hosted.order_lock:
            st = hosted.order.get(owner)
            if st is None:
                return  # caller stream evicted (or pre-registration path)
            st.done[seq] = entry
            st.done.move_to_end(seq)
            cap = int(cfg.actor_reply_memo_max)
            while len(st.done) > cap:
                st.done.popitem(last=False)

    def _enqueue_done(self, owner: str, entry) -> None:
        """Routes a completion to the owner's dedicated flusher thread
        (lazily spawned). Per-owner isolation: a dead owner stalls only
        its own flusher, never delivery to other owners."""
        with self._done_lock:
            fl = self._done_flushers.get(owner)
            if fl is None:
                q: collections.deque = collections.deque()
                ev = threading.Event()
                t = threading.Thread(
                    target=self._owner_flush_loop, args=(owner, q, ev),
                    daemon=True, name=f"done-flush-{owner}")
                fl = self._done_flushers[owner] = (q, ev, t)
                t.start()
            fl[0].append(entry)
            fl[1].set()

    def _owner_flush_loop(self, owner: str, q, ev: threading.Event) -> None:
        """Drains completions to one owner in batches: one `batch_done`
        RPC per cycle. Batches form naturally under load because the
        flusher awaits each ack while new completions queue up. Exits
        (and deregisters) after 60s idle so many short-lived owners don't
        leak threads."""
        while True:
            if not ev.wait(timeout=cfg.done_flusher_idle_ttl_s):
                with self._done_lock:
                    if not q:
                        self._done_flushers.pop(owner, None)
                        return
                continue
            ev.clear()
            entries = []
            while q:
                try:
                    entries.append(q.popleft())
                except IndexError:
                    break
            if not entries:
                continue
            try:
                self._owner_pool.get(owner).retrying_call(
                    "batch_done", entries, timeout=10)
            except (ConnectionLost, OSError) as e:
                # Owner gone: results are orphaned; large ones stay in
                # the store until the owner's death GC reclaims them.
                logger.debug("owner %s unreachable, %d completions "
                             "orphaned: %r", owner, len(entries), e)
            except Exception as e:
                # A handler-side error at a LIVE owner is a completion
                # LOSS — it must be visible, never silent.
                print(f"batch_done delivery to {owner} failed: {e!r}",
                      file=sys.stderr, flush=True)
                traceback.print_exc(file=sys.stderr)

    # ---------------------------------------------------------------- actors

    from ray_tpu_torch.cluster.protocol import blocking_rpc as _brpc

    @_brpc
    def rpc_create_actor(self, conn, actor_id_bytes: bytes, spec_blob: bytes,
                         lease_id: str):
        """Synchronous creation (head waits): instantiate + take over.
        Idempotent: a retried creation (lost ack OR a retry racing a slow
        __init__) must not re-run __init__."""
        actor_id = ActorID(actor_id_bytes)
        with self._hosted_lock:
            if actor_id in self._hosted:
                return True
            if not hasattr(self, "_creating_actors"):
                self._creating_actors = {}
            ev = self._creating_actors.get(actor_id)
            am_creator = ev is None
            if am_creator:
                ev = self._creating_actors[actor_id] = threading.Event()
        if not am_creator:
            ev.wait(600)
            with self._hosted_lock:
                return actor_id in self._hosted
        try:
            return self._create_actor_inner(actor_id, spec_blob, lease_id)
        finally:
            ev.set()
            with self._hosted_lock:
                self._creating_actors.pop(actor_id, None)

    def _create_actor_inner(self, actor_id: ActorID, spec_blob: bytes,
                            lease_id: str):
        spec = SERIALIZER.decode(spec_blob)
        cls = spec["cls"]
        is_async = any(inspect.iscoroutinefunction(m)
                       for _, m in inspect.getmembers(
                           cls, inspect.isfunction))
        max_conc = spec["max_concurrency"]
        if is_async and max_conc == 1:
            max_conc = 1000
        args, kwargs = self._resolve_args(spec["args"], spec["kwargs"])
        prev = runtime_context.set_worker_context({
            "task_id": TaskID.for_task(actor_id), "actor_id": actor_id,
            "resources": {}})
        try:
            instance = cls(*args, **kwargs)
        finally:
            runtime_context.set_worker_context(prev)
        hosted = _HostedActor(actor_id, instance, max_conc, is_async,
                              spec.get("concurrency_groups"),
                              out_of_order=spec.get("out_of_order", False))
        if is_async:
            self._start_actor_loop(hosted)
        with self._hosted_lock:
            self._hosted[actor_id] = hosted
        self.node.retrying_call("mark_actor_host", lease_id,
                                spec.get("release_resources", False),
                                timeout=5)
        return True

    def _start_actor_loop(self, hosted: _HostedActor) -> None:
        import asyncio

        ready = threading.Event()

        def run_loop():
            loop = asyncio.new_event_loop()
            hosted.loop = loop
            asyncio.set_event_loop(loop)
            ready.set()
            loop.run_forever()

        threading.Thread(target=run_loop, daemon=True,
                         name=f"actor-loop-{hosted.actor_id.hex()[:8]}").start()
        ready.wait()

    def rpc_push_actor_batch(self, conn, entries, min_pending: int = 0):
        """Batched at-least-once actor-call delivery: one frame per
        submitter burst, entries = [(seq, blob)] in seq order. Dedup +
        per-submitter seq buffering out. `min_pending` is the submitter's
        smallest still-pending seq — everything below it was completed or
        failed elsewhere, so the expected-seq horizon starts there (a fresh
        incarnation never waits for seqs that predate it)."""
        if not entries:
            return True
        specs = []
        for seq, blob in entries:
            t, undecodable = SERIALIZER.decode_or_error(blob)
            specs.append((seq, {
                "task_id": t[0], "actor_id": t[1], "method": t[2],
                "args": t[3], "kwargs": t[4], "return_ids": t[5],
                "owner_addr": t[6], "undecodable": undecodable}))
        actor_id = ActorID(specs[0][1]["actor_id"])
        with self._hosted_lock:
            hosted = self._hosted.get(actor_id)
        if hosted is None or hosted.dead:
            for seq, spec in specs:
                self._send_results(
                    spec["owner_addr"], TaskID(spec["task_id"]),
                    [ObjectID(b) for b in spec["return_ids"]],
                    error=ActorDiedError(actor_id, "actor not hosted here"),
                    actor_ctx=(spec["actor_id"], seq))
            return True
        owner = specs[0][1]["owner_addr"]
        dup_replies: List[tuple] = []
        with hosted.order_lock:
            st = hosted.order.get(owner)
            if st is None:
                st = hosted.order[owner] = _OrderState()
            hosted.order.move_to_end(owner)
            while len(hosted.order) > int(cfg.actor_order_states_max):
                hosted.order.popitem(last=False)  # LRU caller stream
            if st.expected is None:
                st.expected = min_pending
            else:
                st.expected = max(st.expected, min_pending)
            # Reply-memo hygiene: seqs the submitter settled can never be
            # retried — drop their memoized results.
            for s in [s for s in st.done if s < min_pending]:
                del st.done[s]
            if hosted.out_of_order:
                # Dedup via the horizon + the buffered-seen set, but run
                # immediately: buf marks "already dispatched" seqs (pruned
                # as min_pending advances past them).
                for seq_ot in [x for x in st.buf if x < st.expected]:
                    del st.buf[seq_ot]
                runnable = []
                for seq, spec in specs:
                    if seq < st.expected or seq in st.buf:
                        entry = st.done.get(seq)
                        if entry is not None:  # executed: re-ship results
                            st.done.move_to_end(seq)
                            dup_replies.append(entry)
                        continue
                    st.buf[seq] = True
                    runnable.append((spec, seq))
            else:
                # Seqs below the horizon were completed/failed at the
                # submitter: drop stale buffered ones so the scan below
                # can't stall.
                for s in [s for s in st.buf if s < st.expected]:
                    del st.buf[s]
                for seq, spec in specs:
                    if seq < st.expected or seq in st.buf:
                        # Duplicate of an executed/buffered push: an
                        # already-executed seq answers from the reply
                        # memo (its results frame may have been the
                        # thing that was lost); an in-flight one stays
                        # silent — its results flow when it completes.
                        entry = st.done.get(seq)
                        if entry is not None:
                            st.done.move_to_end(seq)
                            dup_replies.append(entry)
                        continue
                    st.buf[seq] = spec
                runnable = []
                while st.expected in st.buf:
                    s = st.expected
                    runnable.append((st.buf.pop(s), s))
                    st.expected += 1
        for entry in dup_replies:
            self._enqueue_done(owner, entry)
        if hosted.is_async and hosted.loop is not None:
            # Async actors: schedule the runnable burst onto the actor's
            # event loop in ONE threadsafe hop (pool.submit +
            # run_coroutine_threadsafe per call doubled the thread churn).
            # CONCURRENCY-GROUP methods are the exception: they route
            # through their group executor so the group's cap applies
            # (the loop path would run them unbounded).
            import asyncio

            loop_batch = [(sp, s) for sp, s in runnable
                          if hosted.pool_for(sp["method"]) is hosted.pool]
            for sp, s in runnable:
                pool = hosted.pool_for(sp["method"])
                if pool is not hosted.pool:
                    pool.submit(self._execute_actor_task, hosted, sp, s)

            def _schedule(batch):
                for sp, s in batch:
                    asyncio.ensure_future(
                        self._run_async_actor_task(hosted, sp, s))

            if loop_batch:
                hosted.loop.call_soon_threadsafe(_schedule, loop_batch)
            return True
        for sp, s in runnable:
            hosted.pool_for(sp["method"]).submit(
                self._execute_actor_task, hosted, sp, s)
        return True

    async def _run_async_actor_task(self, hosted: _HostedActor, spec: Dict,
                                    seq: int) -> None:
        """Runs one actor coroutine on the actor's event loop. Ref args
        resolve on the pool (blocking gets must never stall the loop)."""
        if spec["method"] == "__rtpu_dag_loop__":
            # DAG bootstrap has its own thread handling in the sync path.
            hosted.pool.submit(self._execute_actor_task, hosted, spec, seq)
            return
        task_id = TaskID(spec["task_id"])
        return_ids = [ObjectID(b) for b in spec["return_ids"]]
        owner = spec["owner_addr"]
        actor_ctx = (spec["actor_id"], seq)
        try:
            if spec.get("undecodable") is not None:
                raise spec["undecodable"]  # reported, in seq order
            args, kwargs = spec["args"], spec["kwargs"]
            if any(isinstance(a, ObjectRef) for a in args) or any(
                    isinstance(v, ObjectRef) for v in kwargs.values()):
                import asyncio

                args, kwargs = await asyncio.get_running_loop() \
                    .run_in_executor(hosted.pool, self._resolve_args,
                                     args, kwargs)
            method = getattr(hosted.instance, spec["method"])
            # ContextVar scoping: each asyncio task has its own context, so
            # this set is visible only to THIS call's coroutine chain.
            runtime_context.set_worker_context({
                "task_id": task_id, "actor_id": hosted.actor_id,
                "resources": {}})
            t_exec = time.time()
            if inspect.iscoroutinefunction(method):
                result = await method(*args, **kwargs)
            else:
                # Plain methods on an async actor run on the pool: a
                # blocking body must not stall every other coroutine.
                import asyncio

                ctx = runtime_context.current_worker_context()

                def _call():
                    prev = runtime_context.set_worker_context(ctx)
                    try:
                        if hosted.max_concurrency == 1:
                            with hosted.lock:
                                return method(*args, **kwargs)
                        return method(*args, **kwargs)
                    finally:
                        runtime_context.set_worker_context(prev)

                result = await asyncio.get_running_loop().run_in_executor(
                    hosted.pool, _call)
            self._send_results(owner, task_id, return_ids, value=result,
                               actor_ctx=actor_ctx,
                               span=(t_exec, time.time(),
                                     f"actor.{spec['method']}"))
        except BaseException as e:  # noqa: BLE001
            err = e if isinstance(e, RayTpuError) else capture_exception(e)
            self._send_results(owner, task_id, return_ids, error=err,
                               actor_ctx=actor_ctx)

    def _execute_actor_task(self, hosted: _HostedActor, spec: Dict, seq: int) -> None:
        task_id = TaskID(spec["task_id"])
        return_ids = [ObjectID(b) for b in spec["return_ids"]]
        owner = spec["owner_addr"]
        actor_ctx = (spec["actor_id"], seq)
        if hosted.dead:
            # A kill raced this queued call out of its executor: the owner
            # was already told the actor died — never execute on a dead
            # instance (side effects + a success reply would contradict it).
            self._send_results(
                owner, task_id, return_ids,
                error=ActorDiedError(hosted.actor_id, "actor was killed"),
                actor_ctx=actor_ctx)
            return
        if spec["method"] == "__rtpu_dag_loop__":
            # Compiled-DAG bootstrap (dag/compiled_dag.py): run the
            # shipped per-actor schedule on a dedicated thread — the actor
            # keeps serving normal calls while the DAG loop blocks on
            # channel reads.
            from ray_tpu_torch.dag.compiled_dag import run_actor_dag_loop

            schedule = spec["args"][0]
            stop = threading.Event()
            hosted.dag_stops = getattr(hosted, "dag_stops", [])
            hosted.dag_stops.append(stop)
            threading.Thread(
                target=run_actor_dag_loop,
                args=(hosted.instance, schedule, stop), daemon=True,
                name=f"dag-loop-{hosted.actor_id.hex()[:8]}").start()
            self._send_results(owner, task_id, return_ids, value=True,
                               actor_ctx=actor_ctx)
            return
        try:
            if spec.get("undecodable") is not None:
                raise spec["undecodable"]  # reported, in seq order
            args, kwargs = self._resolve_args(spec["args"], spec["kwargs"])
            method = getattr(hosted.instance, spec["method"])
            if inspect.iscoroutinefunction(method):
                import asyncio

                fut = asyncio.run_coroutine_threadsafe(
                    method(*args, **kwargs), hosted.loop)

                def _done(f):
                    try:
                        self._send_results(owner, task_id, return_ids,
                                           value=f.result(),
                                           actor_ctx=actor_ctx)
                    except BaseException as e:  # noqa: BLE001
                        self._send_results(owner, task_id, return_ids,
                                           error=capture_exception(e),
                                           actor_ctx=actor_ctx)

                fut.add_done_callback(_done)
                if hosted.pool_for(spec["method"]) is not hosted.pool:
                    # Group-routed coroutine: HOLD this group-pool thread
                    # until completion so the group's concurrency cap
                    # bounds coroutines too (results flow via _done).
                    try:
                        fut.result()
                    except BaseException:  # noqa: BLE001 — _done reported
                        pass
                return
            prev = runtime_context.set_worker_context({
                "task_id": task_id, "actor_id": hosted.actor_id,
                "resources": {}})
            t_exec = time.time()
            try:
                # The max_concurrency=1 serialization lock applies only to
                # DEFAULT-pool methods: a concurrency-group method has its
                # own executor cap and must not queue behind the default
                # group (the whole point of groups).
                if (hosted.max_concurrency == 1
                        and hosted.pool_for(spec["method"]) is hosted.pool):
                    with hosted.lock:
                        result = method(*args, **kwargs)
                else:
                    result = method(*args, **kwargs)
            finally:
                runtime_context.set_worker_context(prev)
            self._send_results(owner, task_id, return_ids, value=result,
                               actor_ctx=actor_ctx,
                               span=(t_exec, time.time(),
                                     f"actor.{spec['method']}"))
        except BaseException as e:  # noqa: BLE001
            err = e if isinstance(e, RayTpuError) else capture_exception(e)
            self._send_results(owner, task_id, return_ids, error=err,
                               actor_ctx=actor_ctx)

    def rpc_cancel_task(self, conn, task_id_bytes: bytes,
                        force: bool = False):
        """Cooperative cancel: a task that has not started is skipped; a
        running one completes (no preemption, reference non-force cancel).
        ``force`` mirrors ray.cancel(force=True): if the task is INSIDE
        user code, the worker process exits — the owner's conn-lost hook
        re-enqueues its tasks and the re-dispatch check converts the
        cancelled one into TaskCancelledError (never a silent retry)."""
        if force and task_id_bytes in self._executing:
            import threading as _threading

            # Delay lets the RPC reply flush before the process dies.
            _threading.Timer(0.05, os._exit, (1,)).start()
        self._cancelled.add(task_id_bytes)
        self._cancelled_order.append(task_id_bytes)
        while len(self._cancelled_order) > 4096:
            # Oldest-first eviction: set.pop() would drop arbitrary marks,
            # possibly the one just added.
            self._cancelled.discard(self._cancelled_order.popleft())
        return True

    def rpc_kill_actor(self, conn, actor_id_bytes: bytes):
        actor_id = ActorID(actor_id_bytes)
        with self._hosted_lock:
            hosted = self._hosted.pop(actor_id, None)
        if hosted is not None:
            hosted.dead = True
            for stop in getattr(hosted, "dag_stops", []):
                stop.set()
            hosted.pool.shutdown(wait=False, cancel_futures=True)
            for gpool in hosted.group_pools.values():
                gpool.shutdown(wait=False, cancel_futures=True)
            if hosted.loop is not None:
                hosted.loop.call_soon_threadsafe(hosted.loop.stop)
        # The worker process hosting an actor exits on kill (the lease dies
        # with it; the node manager reaps and reports).
        if hosted is not None:
            threading.Thread(target=self._exit_soon, daemon=True).start()
        return True

    def _exit_soon(self) -> None:
        time.sleep(0.1)
        import os

        os._exit(0)


def _zygote_child(args, worker_id: str) -> None:
    """Post-fork worker setup: own PDEATHSIG (vs the zygote), own log
    file, then the normal worker runtime."""
    import signal as _signal

    from ray_tpu_torch.core.process_util import PARENT_PID_VAR, bind_to_parent

    _signal.signal(_signal.SIGCHLD, _signal.SIG_DFL)
    # The inherited RTPU_PARENT_PID names the NODE MANAGER (the zygote's
    # spawner); this process's parent is the zygote — retarget before
    # bind_to_parent's stale-parent check silently exits us.
    os.environ[PARENT_PID_VAR] = str(os.getppid())
    bind_to_parent()  # zygote dies -> its workers die (chain to the node)
    os.environ["RTPU_WORKER_ID"] = worker_id
    log_path = os.path.join(cfg.log_dir, f"worker-{worker_id[:8]}.log")
    os.makedirs(cfg.log_dir, exist_ok=True)
    fd = os.open(log_path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    os.close(fd)
    devnull = os.open(os.devnull, os.O_RDONLY)
    os.dup2(devnull, 0)
    os.close(devnull)
    WorkerRuntime(args.head_addr, args.node_addr, args.node_id,
                  args.store_name, worker_id)
    while True:
        time.sleep(3600)


def zygote_main(args) -> None:
    """Worker ZYGOTE (reference analog: the worker pool's prestart —
    here taken further because Python pays ~0.4 s of interpreter+import
    CPU per cold worker, the whole cost of an actor on a busy host):
    import everything ONCE, then fork() per spawn request (~10 ms). The
    zygote stays single-threaded and opens no CUDA context, so neither the
    fork-with-threads deadlock nor a broken inherited context can occur; each child re-arms
    PDEATHSIG against the zygote, which itself dies with the node
    manager — the same lifetime chain as cold-spawned workers.

    Protocol (line JSON on stdio): {"worker_id": w} -> {"worker_id": w,
    "pid": p}. The node manager holds one zygote per default-env host
    and falls back to cold spawns if the zygote dies."""
    import json as _json
    import signal as _signal

    from ray_tpu_torch.core.process_util import bind_to_parent

    bind_to_parent()
    # torch is imported once here, so a forked worker does not pay for it
    # again. Nothing may touch torch.cuda in this process: a CUDA context
    # does not survive fork(), and every child would inherit a broken one.
    import torch  # noqa: F401

    _signal.signal(_signal.SIGCHLD, _signal.SIG_IGN)  # auto-reap children
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            req = _json.loads(line)
        except ValueError:
            continue
        wid = req["worker_id"]
        pid = os.fork()
        if pid == 0:
            try:
                _zygote_child(args, wid)
            except BaseException:  # noqa: BLE001
                traceback.print_exc()
            finally:
                os._exit(0)
        try:
            sys.stdout.write(_json.dumps({"worker_id": wid, "pid": pid})
                             + "\n")
            sys.stdout.flush()
        except OSError:
            break  # node manager abandoned us: stop serving, linger below
    # stdin EOF / stdout closed: the node manager abandoned this zygote
    # (spawn-timeout fallback closes our pipes). Do NOT exit — forked
    # workers hold PDEATHSIG against this process, so exiting would take
    # down every healthy worker it ever forked. Linger as their anchor;
    # our own PDEATHSIG (bind_to_parent above) still ends us with the
    # node manager.
    while True:
        _signal.pause()


def main() -> None:
    import faulthandler
    import signal

    from ray_tpu_torch.core.process_util import bind_to_parent

    p = argparse.ArgumentParser()
    p.add_argument("--node-addr", required=True)
    p.add_argument("--head-addr", required=True)
    p.add_argument("--node-id", required=True)
    p.add_argument("--store-name", required=True)
    p.add_argument("--worker-id", default="")
    p.add_argument("--zygote", action="store_true")
    args = p.parse_args()

    if args.zygote:
        zygote_main(args)
        return

    bind_to_parent()  # PDEATHSIG armed in the CHILD (no preexec_fn fork)

    faulthandler.register(signal.SIGUSR1)  # kill -USR1 <pid> dumps stacks

    WorkerRuntime(args.head_addr, args.node_addr, args.node_id,
                  args.store_name, args.worker_id)  # installs itself
    try:
        while True:  # serve until parent kills us
            time.sleep(3600)
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
