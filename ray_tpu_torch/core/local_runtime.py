"""Single-process runtime: full task/actor/object semantics on threads
(``ray_tpu/core/local_runtime.py``).

This is the equivalent of running the whole reference stack in one process
(reference behavior: ray.init(local_mode=True), python/ray/_private/worker.py)
but kept *concurrent*: tasks run on a thread pool, actors get dedicated
executors with ordered queues, so async patterns, actor concurrency and
wait/get semantics behave exactly as on a cluster. Nothing is serialized:
arguments, actor constructor arguments and results pass by reference, so a
tensor handed to an actor is the caller's tensor.

One addition to ``ray_tpu``'s: killing an actor (``kill``, shutdown) calls
its ``__ray_shutdown__()`` once, if it defines one, so an actor that owns
threads (a serve replica's engine) can stop them.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch.core import runtime_context
from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg
from ray_tpu_torch.core.ids import (
    ActorID,
    JobID,
    NodeID,
    ObjectID,
    PlacementGroupID,
    TaskID,
    WorkerID,
)
from ray_tpu_torch.core.memory_store import MemoryStore
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.refcount import ReferenceCounter
from ray_tpu_torch.core.serialization import capture_exception
from ray_tpu_torch.core.task_spec import PlacementGroupSpec
from ray_tpu_torch.exceptions import (
    ActorDiedError,
    TaskCancelledError,
    TaskError,
)

_logger = logging.getLogger(__name__)
_task_local = threading.local()
_SENTINEL = object()


def _restore_task_local(attr: str, prev) -> None:
    """Restore a _task_local slot to its pre-task state. Deleting (rather than
    setting None) lets current_task_id() fall back to the driver task id on
    recycled pool threads."""
    if prev is _SENTINEL:
        try:
            delattr(_task_local, attr)
        except AttributeError:
            pass
    else:
        setattr(_task_local, attr, prev)


class _ActorState:
    """One live actor: instance + its execution queue/threads."""

    def __init__(self, actor_id: ActorID, name: Optional[str],
                 max_concurrency: int, max_restarts: int):
        self.actor_id = actor_id
        self.name = name
        self.instance: Any = None
        self.cls: Any = None
        self.init_args: Tuple = ()
        self.init_kwargs: Dict = {}
        self.max_concurrency = max_concurrency
        self.max_restarts = max_restarts
        self.restart_count = 0
        self.dead = False
        self.death_reason = ""
        self.lock = threading.Lock()  # serializes calls when max_concurrency == 1
        self.pool = ThreadPoolExecutor(
            max_workers=max_concurrency, thread_name_prefix=f"actor-{actor_id.hex()[:8]}"
        )
        self.is_async = False
        # Return ObjectIDs of submitted-but-unfinished calls; on kill these are
        # failed with ActorDiedError so callers' get() never hangs.
        self.pending_lock = threading.Lock()
        self.pending_returns: Dict[Any, List[Any]] = {}
        self.loop = None  # asyncio loop for async actors
        self.seq_counter = itertools.count()


class LocalRuntime:
    """Implements the runtime interface consumed by the public API layer."""

    is_cluster = False

    def __init__(self, num_cpus: Optional[float] = None, job_id: Optional[JobID] = None):
        self.job_id = job_id or JobID.from_int(1)
        self.node_id = NodeID.from_random()
        self.worker_id = WorkerID.from_random()
        self.memory_store = MemoryStore()
        self.refcount = ReferenceCounter(on_release=self._release_object)
        self._driver_task_id = TaskID.for_driver(self.job_id)
        self._put_counter = itertools.count(1)
        # Local mode simulates a cluster with threads: the pool must be deep
        # enough that nested submit+get chains never exhaust it (a cluster
        # scales workers for nested calls; we oversize instead).
        self._pool = ThreadPoolExecutor(max_workers=256, thread_name_prefix="task")
        self._actors: Dict[ActorID, _ActorState] = {}
        self._named_actors: Dict[Tuple[str, str], ActorID] = {}
        self._actors_lock = threading.Lock()
        self._pgs: Dict[PlacementGroupID, PlacementGroupSpec] = {}
        self._cancelled: set = set()
        self._shutdown = False

        def _flush_loop():
            while not self._shutdown:
                time.sleep(0.2)
                self.refcount.flush_deferred()

        # Finalizer-queued ref decrements apply even when idle (see
        # ReferenceCounter._deferred).
        threading.Thread(target=_flush_loop, daemon=True,
                         name="refcount-flush").start()

    # ------------------------------------------------------------------ refs

    def resolve_record(self, rec) -> Any:
        if rec.is_exception:
            raise rec.value
        return rec.value

    def register_ready_callback(self, oid: ObjectID, cb: Callable) -> None:
        self.memory_store.get_async(oid, cb)

    def on_ref_deserialized(self, oid: ObjectID, owner_addr: Optional[str]) -> None:
        pass  # single process: owner is always us

    def _release_object(self, oid: ObjectID) -> None:
        self.memory_store.delete([oid])

    # ------------------------------------------------------------------ tasks

    def current_task_id(self) -> TaskID:
        return getattr(_task_local, "task_id", self._driver_task_id)

    def current_actor_id(self) -> Optional[ActorID]:
        return getattr(_task_local, "actor_id", None)

    def current_resources(self) -> Dict[str, float]:
        return getattr(_task_local, "resources", {})

    def put(self, value: Any, _owner=None, inline_ok: bool = True
            ) -> ObjectRef:
        # inline_ok is interface parity with ClusterCore.put: one process
        # means the memory store IS the object's lifetime either way.
        oid = ObjectID.for_put(self.current_task_id(), next(self._put_counter))
        self.refcount.add_owned_object(oid)
        if isinstance(value, TaskError):
            self.memory_store.put(oid, value, is_exception=True)
        else:
            self.memory_store.put(oid, value)
        return ObjectRef(oid)

    def submit_task(self, func: Callable, args: Sequence, kwargs: Dict,
                    num_returns: int = 1, resources=None, max_retries: int = 0,
                    retry_exceptions: bool = False, scheduling_strategy=None,
                    name: str = "", runtime_env=None) -> List[ObjectRef]:
        task_id = TaskID.for_task(ActorID.nil_for_job(self.job_id))
        return_ids = [ObjectID.for_task_return(task_id, i) for i in range(num_returns)]
        for oid in return_ids:
            self.refcount.add_owned_object(oid)
        refs = [ObjectRef(oid) for oid in return_ids]
        arg_refs = [a for a in list(args) + list(kwargs.values())
                    if isinstance(a, ObjectRef)]
        for r in arg_refs:
            self.refcount.add_submitted_task_ref(r.id())

        def run():
            self._execute_task(task_id, func, args, kwargs, return_ids,
                               max_retries, retry_exceptions, name or func.__name__)
            for r in arg_refs:
                self.refcount.remove_submitted_task_ref(r.id())

        self._pool.submit(run)
        return refs

    def _execute_task(self, task_id: TaskID, func, args, kwargs, return_ids,
                      max_retries: int, retry_exceptions: bool, name: str) -> None:
        attempt = 0
        while True:
            if task_id in self._cancelled:
                err = TaskCancelledError(task_id)
                for oid in return_ids:
                    self._put_return(oid, err, is_exception=True)
                return
            try:
                r_args, r_kwargs = self._resolve_args(args, kwargs)
                prev = getattr(_task_local, "task_id", _SENTINEL)
                _task_local.task_id = task_id
                try:
                    result = func(*r_args, **r_kwargs)
                finally:
                    _restore_task_local("task_id", prev)
                self._store_results(result, return_ids)
                return
            except TaskError as te:
                # Dependency failed: propagate as-is, never retry here
                for oid in return_ids:
                    self._put_return(oid, te, is_exception=True)
                return
            except BaseException as e:  # noqa: BLE001
                attempt += 1
                if retry_exceptions and attempt <= max_retries:
                    time.sleep(cfg.task_retry_delay_ms / 1000.0)
                    continue
                err = capture_exception(e)
                for oid in return_ids:
                    self._put_return(oid, err, is_exception=True)
                return

    def _put_return(self, oid: ObjectID, value, is_exception: bool = False) -> None:
        """Store a task result; reclaim immediately if every ref was dropped
        before completion (fire-and-forget tasks must not leak results)."""
        self.memory_store.put(oid, value, is_exception=is_exception)
        if not self.refcount.is_in_scope(oid):
            self.memory_store.delete([oid])

    def _store_results(self, result, return_ids: List[ObjectID]) -> None:
        n = len(return_ids)
        if n == 0:
            return
        if n == 1:
            self._put_return(return_ids[0], result)
            return
        vals = list(result) if isinstance(result, (tuple, list)) else [result]
        if len(vals) != n:
            err = capture_exception(
                ValueError(f"task declared {n} returns but produced {len(vals)}")
            )
            for oid in return_ids:
                self._put_return(oid, err, is_exception=True)
            return
        for oid, v in zip(return_ids, vals):
            self._put_return(oid, v)

    def _resolve_args(self, args, kwargs):
        """Inline ObjectRef args with their values (raises if a dep failed)."""

        def res(a):
            if isinstance(a, ObjectRef):
                rec = self.memory_store.get([a.id()])[0]
                if rec.is_exception:
                    raise rec.value
                return rec.value
            return a

        return [res(a) for a in args], {k: res(v) for k, v in kwargs.items()}

    # ------------------------------------------------------------------ get/wait

    def get(self, refs, timeout: Optional[float] = None):
        single = isinstance(refs, ObjectRef)
        ref_list = [refs] if single else list(refs)
        for r in ref_list:
            if not isinstance(r, ObjectRef):
                raise TypeError(f"get() expects ObjectRef, got {type(r).__name__}")
        recs = self.memory_store.get([r.id() for r in ref_list], timeout)
        out = []
        for rec in recs:
            if rec.is_exception:
                raise rec.value
            out.append(rec.value)
        return out[0] if single else out

    def wait(self, refs: List[ObjectRef], num_returns: int = 1,
             timeout: Optional[float] = None, fetch_local: bool = True):
        if len(set(r.id() for r in refs)) != len(refs):
            raise ValueError("wait() requires unique object refs")
        ready_ids = self.memory_store.wait([r.id() for r in refs], num_returns, timeout)
        ready, not_ready = [], []
        for r in refs:
            (ready if r.id() in ready_ids and len(ready) < num_returns
             else not_ready).append(r)
        return ready, not_ready

    def cancel(self, ref: ObjectRef, force: bool = False, recursive: bool = True):
        self._cancelled.add(ref.id().task_id())

    # ------------------------------------------------------------------ actors

    def create_actor(self, cls, args, kwargs, *, name: Optional[str] = None,
                     namespace: str = "default", max_concurrency: int = 1,
                     max_restarts: int = 0, max_task_retries: int = 0,
                     resources=None, lifetime=None,
                     scheduling_strategy=None, get_if_exists: bool = False,
                     runtime_env=None, release_resources: bool = False,
                     concurrency_groups=None,
                     allow_out_of_order_execution: bool = False
                     ) -> "ActorID":
        # Local mode runs every method on one pool; concurrency groups
        # only isolate executors in cluster workers.
        import inspect

        is_async = any(
            inspect.iscoroutinefunction(m)
            for _, m in inspect.getmembers(cls, inspect.isfunction)
        )
        if is_async and max_concurrency == 1:
            max_concurrency = 1000  # async actors default to high concurrency

        actor_id = ActorID.of(self.job_id)
        state = _ActorState(actor_id, name, max_concurrency, max_restarts)
        state.cls, state.init_args, state.init_kwargs = cls, tuple(args), dict(kwargs)
        state.is_async = is_async
        # Name reservation and actor registration are one atomic step so
        # concurrent creates with the same name cannot both win.
        with self._actors_lock:
            if name is not None:
                key = (namespace, name)
                if key in self._named_actors:
                    if get_if_exists:
                        return self._named_actors[key]
                    raise ValueError(f"actor name '{name}' already taken")
                self._named_actors[key] = actor_id
            self._actors[actor_id] = state

        if state.is_async:
            self._start_actor_loop(state)

        def init():
            try:
                r_args, r_kwargs = self._resolve_args(state.init_args, state.init_kwargs)
                prev = getattr(_task_local, "actor_id", _SENTINEL)
                _task_local.actor_id = actor_id
                try:
                    state.instance = cls(*r_args, **r_kwargs)
                finally:
                    _restore_task_local("actor_id", prev)
            except BaseException as e:  # noqa: BLE001
                state.dead = True
                state.death_reason = f"__init__ failed: {e!r}"

        state.pool.submit(init).result()  # creation is synchronous locally
        if state.dead:
            with self._actors_lock:
                if name is not None:
                    self._named_actors.pop((namespace, name), None)
                self._actors.pop(actor_id, None)
            raise ActorDiedError(actor_id, state.death_reason)
        return actor_id

    def _start_actor_loop(self, state: _ActorState) -> None:
        import asyncio

        ready = threading.Event()

        def run_loop():
            loop = asyncio.new_event_loop()
            state.loop = loop
            asyncio.set_event_loop(loop)
            ready.set()
            loop.run_forever()

        t = threading.Thread(target=run_loop, daemon=True,
                             name=f"actor-loop-{state.actor_id.hex()[:8]}")
        t.start()
        ready.wait()

    def submit_actor_task(self, actor_id: ActorID, method_name: str, args, kwargs,
                          num_returns: int = 1) -> List[ObjectRef]:
        state = self._actors.get(actor_id)
        task_id = TaskID.for_task(actor_id)
        return_ids = [ObjectID.for_task_return(task_id, i) for i in range(num_returns)]
        for oid in return_ids:
            self.refcount.add_owned_object(oid)
        refs = [ObjectRef(oid) for oid in return_ids]
        if state is None or state.dead:
            err = ActorDiedError(actor_id,
                                 state.death_reason if state else "unknown actor")
            for oid in return_ids:
                self._put_return(oid, err, is_exception=True)
            return refs

        with state.pending_lock:
            state.pending_returns[task_id] = return_ids

        def finish_pending():
            with state.pending_lock:
                state.pending_returns.pop(task_id, None)

        def run():
            still_pending = False
            if state.dead:
                finish_pending()
                err = ActorDiedError(actor_id, state.death_reason)
                for oid in return_ids:
                    self._put_return(oid, err, is_exception=True)
                return
            try:
                r_args, r_kwargs = self._resolve_args(args, kwargs)
                method = getattr(state.instance, method_name)
                import inspect

                if inspect.iscoroutinefunction(method):
                    # Run on the actor's event loop without holding a pool
                    # thread: concurrent awaits interleave like on a cluster.
                    import asyncio

                    fut = asyncio.run_coroutine_threadsafe(
                        method(*r_args, **r_kwargs), state.loop
                    )

                    def _done(f):
                        try:
                            self._store_results(f.result(), return_ids)
                        except BaseException as e:  # noqa: BLE001
                            err = capture_exception(e)
                            for oid in return_ids:
                                self._put_return(oid, err, is_exception=True)
                        finally:
                            finish_pending()

                    fut.add_done_callback(_done)
                    # The call stays pending until the coroutine resolves —
                    # _done owns finish_pending(); the sync path's finally
                    # below must not drain it while the coroutine is in
                    # flight (kill() could then never fail these refs and a
                    # concurrent get() would hang forever).
                    still_pending = True
                    return
                prev_task = getattr(_task_local, "task_id", _SENTINEL)
                prev_actor = getattr(_task_local, "actor_id", _SENTINEL)
                _task_local.task_id = task_id
                _task_local.actor_id = actor_id
                try:
                    if state.max_concurrency == 1:
                        with state.lock:
                            result = method(*r_args, **r_kwargs)
                    else:
                        result = method(*r_args, **r_kwargs)
                finally:
                    _restore_task_local("task_id", prev_task)
                    _restore_task_local("actor_id", prev_actor)
                self._store_results(result, return_ids)
            except BaseException as e:  # noqa: BLE001
                from ray_tpu_torch.exceptions import RayTpuError

                err = e if isinstance(e, RayTpuError) else capture_exception(e)
                for oid in return_ids:
                    self._put_return(oid, err, is_exception=True)
            finally:
                if not still_pending:
                    finish_pending()

        if method_name == "__ray_terminate__":
            finish_pending()
            self._kill_actor(actor_id, "terminated by user")
            for oid in return_ids:
                self._put_return(oid, None)
            return refs
        try:
            state.pool.submit(run)
        except RuntimeError:
            # Pool shut down by a concurrent kill — fail the refs, don't raise.
            finish_pending()
            err = ActorDiedError(actor_id, state.death_reason or "actor killed")
            for oid in return_ids:
                self._put_return(oid, err, is_exception=True)
        return refs

    def get_actor(self, name: str, namespace: str = "default") -> ActorID:
        with self._actors_lock:
            key = (namespace, name)
            if key not in self._named_actors:
                raise ValueError(f"no actor named '{name}' in namespace '{namespace}'")
            return self._named_actors[key]

    def actor_class_of(self, actor_id: ActorID):
        state = self._actors.get(actor_id)
        return state.cls if state else None

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True) -> None:
        self._kill_actor(actor_id, "killed via ray_tpu_torch.kill")

    def _kill_actor(self, actor_id: ActorID, reason: str) -> None:
        with self._actors_lock:
            state = self._actors.get(actor_id)
            if state is None:
                return
            first_kill = not state.dead
            state.dead = True
            state.death_reason = reason
            if state.name is not None:
                for k in [k for k, v in self._named_actors.items() if v == actor_id]:
                    self._named_actors.pop(k, None)
            if state.loop is not None:
                state.loop.call_soon_threadsafe(state.loop.stop)
        state.pool.shutdown(wait=False, cancel_futures=True)
        # Queued calls were cancelled before storing anything; fail their
        # return objects so pending get()s resolve with ActorDiedError.
        # (_put_return keeps the first value, so a call that actually finished
        # concurrently wins over this error.)
        with state.pending_lock:
            pending = [oid for oids in state.pending_returns.values() for oid in oids]
            state.pending_returns.clear()
        err = ActorDiedError(actor_id, reason)
        for oid in pending:
            self._put_return(oid, err, is_exception=True)
        hook = getattr(state.instance, "__ray_shutdown__", None)
        if first_kill and hook is not None:
            try:
                hook()
            except Exception:
                # A failing hook must not stop the kill or the shutdown.
                _logger.exception("__ray_shutdown__ of actor %s failed",
                                  actor_id.hex())

    def list_actors(self):
        with self._actors_lock:
            return [
                {"actor_id": a.hex(), "name": s.name, "dead": s.dead,
                 "class": s.cls.__name__ if s.cls else None}
                for a, s in self._actors.items()
            ]

    # ------------------------------------------------------------------ pgs

    def create_placement_group(self, spec: PlacementGroupSpec) -> None:
        self._pgs[spec.pg_id] = spec

    def placement_group_ready(self, pg_id: PlacementGroupID, timeout=None) -> bool:
        return pg_id in self._pgs

    def remove_placement_group(self, pg_id: PlacementGroupID) -> None:
        self._pgs.pop(pg_id, None)

    def placement_group_table(self):
        return {pg.hex(): {"state": "CREATED", "bundles": [b.resources.to_dict()
                                                           for b in spec.bundles],
                           "strategy": spec.strategy, "name": spec.name}
                for pg, spec in self._pgs.items()}

    # ------------------------------------------------------------------ misc

    def nodes(self):
        from ray_tpu_torch.core.resources import detect_node_resources

        nr = detect_node_resources()
        return [{"node_id": self.node_id.hex(), "alive": True,
                 "resources": nr.total.to_dict(), "labels": nr.labels,
                 "address": "local"}]

    def cluster_resources(self) -> Dict[str, float]:
        return self.nodes()[0]["resources"]

    def available_resources(self) -> Dict[str, float]:
        return self.cluster_resources()

    def shutdown(self) -> None:
        if self._shutdown:
            return
        self._shutdown = True
        for actor_id in list(self._actors):
            self._kill_actor(actor_id, "runtime shutdown")
        self._pool.shutdown(wait=False, cancel_futures=True)
        runtime_context.set_runtime(None)
