"""ClientRuntime: the thin remote-driver runtime behind client:// addresses
(``ray_tpu/client/runtime.py``).

Parity target: the reference's client-side worker
(reference: python/ray/util/client/worker.py — Worker.get/put/wait/
call_remote over gRPC; dataclient.py streams releases). Implements the same
runtime interface `api.py`/`remote_function.py`/`actor.py` drive, so every
frontend feature (tasks, actors, named actors, kill/cancel, kv, wait) works
unchanged from a process that is not part of the cluster.

Reference releases happen in the client's ObjectRef.__del__ path via a tiny
local refcounter; drops are batched and shipped to the gateway on a flusher
thread (one notify frame per sweep, mirroring the reference's streaming
ReleaseRequest batching).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch.cluster.protocol import ConnectionLost, RpcClient
from ray_tpu_torch.core.ids import ActorID, ObjectID
from ray_tpu_torch.core.object_ref import ObjectRef


class _Record:
    """Shape-compatible with the memory-store records resolve_record sees."""

    __slots__ = ("value", "is_exception", "in_plasma")

    def __init__(self, value, is_exception):
        self.value = value
        self.is_exception = is_exception
        self.in_plasma = False


class _ClientRefcount:
    """Minimal local refcounter: batches zero-count drops to the gateway."""

    def __init__(self, runtime: "ClientRuntime"):
        self._rt = runtime
        self._counts: Dict[bytes, int] = {}
        self._dropped: List[bytes] = []
        self._lock = threading.Lock()

    def add_local_ref(self, oid: ObjectID) -> None:
        key = oid.binary()
        with self._lock:
            self._counts[key] = self._counts.get(key, 0) + 1

    def remove_local_ref(self, oid: ObjectID) -> None:
        key = oid.binary()
        with self._lock:
            n = self._counts.get(key)
            if n is None:
                return
            if n <= 1:
                del self._counts[key]
                self._dropped.append(key)
            else:
                self._counts[key] = n - 1

    def take_dropped(self) -> List[bytes]:
        with self._lock:
            dropped, self._dropped = self._dropped, []
        return dropped

    def count(self, key: bytes) -> int:
        with self._lock:
            return self._counts.get(key, 0)


class ClientRuntime:
    """Runtime for ``ray_tpu_torch.init(address="client://host:port")``."""

    is_client = True

    def __init__(self, address: str):
        if address.startswith("client://"):
            address = address[len("client://"):]
        self.address = address
        self._conn = RpcClient(address)
        self.refcount = _ClientRefcount(self)
        self._holds_buf: List[Tuple[bytes, Optional[str]]] = []
        self._holds_lock = threading.Lock()
        self._flush_lock = threading.Lock()
        self._actor_classes: Dict[ActorID, Any] = {}
        self._shutdown = False
        self._stop_event = threading.Event()
        info = self._conn.call("client_hello", 1, timeout=30)
        self.protocol_version = info["protocol_version"]
        self._flusher = threading.Thread(target=self._flush_loop, daemon=True,
                                         name="client-ref-flusher")
        self._flusher.start()

    # ---------------------------------------------------------- plumbing

    def _flush_loop(self) -> None:
        from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg

        while not self._shutdown:
            self._stop_event.wait(cfg.client_ref_flush_period_s)
            if self._shutdown:
                return
            self.flush_refs()

    def flush_refs(self) -> None:
        """Ship buffered holds, then releases reconciled against the
        CURRENT refcounts. Every buffered hold is sent (a hold is buffered
        by ref deserialization BEFORE the ObjectRef is constructed —
        filtering on count would discard the pin for a ref
        mid-construction); a release
        is sent only if the count is still zero, so drop-then-re-acquire
        within one sweep nets out to "held". The hold call completes
        before the release notify is sent, and the whole flush is
        serialized, so the gateway always applies them in that order."""
        with self._flush_lock:
            with self._holds_lock:
                holds, self._holds_buf = self._holds_buf, []
            dropped = self.refcount.take_dropped()
            releases = [o for o in set(dropped)
                        if self.refcount.count(o) == 0]
            try:
                if holds:
                    self._conn.call("hold", holds, timeout=30)
                if releases:
                    self._conn.notify("release", releases)
            except (ConnectionLost, OSError):
                pass

    #: Gateway methods whose NAMES are in the global RETRY_SAFE_RPCS
    #: (they collide with head/worker handlers): blind chaos drops may
    #: eat these frames, so THIS side must be the required retry loop —
    #: the contract retry-safety is predicated on. Safe to retry at the
    #: gateway too: three are pure reads, kill_actor is idempotent.
    _RETRY_SAFE_GATEWAY = frozenset({
        "ping", "kill_actor", "list_actors", "cluster_resources"})

    def _call(self, method: str, *args, timeout: Optional[float] = None):
        if method in self._RETRY_SAFE_GATEWAY:
            return self._conn.retrying_call(method, *args,
                                            timeout=timeout)
        return self._conn.call(method, *args, timeout=timeout)

    def _make_ref(self, oid: bytes, owner: Optional[str]) -> ObjectRef:
        return ObjectRef(ObjectID(oid), owner)

    # ---------------------------------------------------------- objects

    def put(self, value: Any, _owner=None) -> ObjectRef:
        oid, owner = self._call("put", value)
        return self._make_ref(oid, owner)

    def get(self, refs, timeout: Optional[float] = None):
        single = isinstance(refs, ObjectRef)
        ref_list = [refs] if single else list(refs)
        for r in ref_list:
            if not isinstance(r, ObjectRef):
                raise TypeError(f"get() expects ObjectRefs, got {type(r)}")
        if not ref_list:
            return refs if single else []
        # Holds for refs nested in the request must land before the server
        # processes anything that could release them.
        self.flush_refs()
        vals = self._call(
            "get", [(r.binary(), r.owner_address) for r in ref_list],
            timeout, timeout=None if timeout is None else timeout + 30)
        return vals[0] if single else vals

    def wait(self, refs: List[ObjectRef], num_returns: int = 1,
             timeout: Optional[float] = None, fetch_local: bool = True):
        by_id = {r.binary(): r for r in refs}
        self.flush_refs()
        ready_b, pending_b = self._call(
            "wait", [(r.binary(), r.owner_address) for r in refs],
            num_returns, timeout, fetch_local,
            timeout=None if timeout is None else timeout + 30)
        return ([by_id[b] for b in ready_b], [by_id[b] for b in pending_b])

    def cancel(self, ref: ObjectRef, force: bool = False,
               recursive: bool = True) -> None:
        self._call("cancel", ref.binary(), ref.owner_address, force,
                   recursive, timeout=30)

    # ---------------------------------------------------------- tasks

    def submit_task(self, func: Callable, args: Sequence, kwargs: Dict,
                    num_returns: int = 1, resources=None, max_retries: int = 0,
                    retry_exceptions: bool = False, scheduling_strategy=None,
                    name: str = "", runtime_env=None) -> List[ObjectRef]:
        self.flush_refs()
        opts = {
            "num_returns": num_returns,
            "resources": resources.to_dict() if resources is not None else None,
            "max_retries": max_retries,
            "retry_exceptions": retry_exceptions,
            "scheduling_strategy": scheduling_strategy,
            "name": name,
            "runtime_env": runtime_env,
        }
        pairs = self._call("submit_task", func, tuple(args), dict(kwargs),
                           opts, timeout=60)
        return [self._make_ref(o, owner) for o, owner in pairs]

    # ---------------------------------------------------------- actors

    def create_actor(self, cls, args, kwargs, *, name: Optional[str] = None,
                     namespace: str = "default", max_concurrency: int = 1,
                     max_restarts: int = 0, max_task_retries: int = 0,
                     resources=None, lifetime=None,
                     scheduling_strategy=None, get_if_exists: bool = False,
                     runtime_env=None, release_resources: bool = False,
                     concurrency_groups: Optional[Dict[str, int]] = None,
                     allow_out_of_order_execution: bool = False,
                     ) -> ActorID:
        self.flush_refs()
        opts = {
            "name": name, "namespace": namespace,
            "max_concurrency": max_concurrency,
            "concurrency_groups": concurrency_groups,
            "max_restarts": max_restarts,
            "max_task_retries": max_task_retries,
            "resources": resources.to_dict() if resources is not None else None,
            "lifetime": lifetime,
            "scheduling_strategy": scheduling_strategy,
            "get_if_exists": get_if_exists,
            "runtime_env": runtime_env,
            "release_resources": release_resources,
            "allow_out_of_order_execution": allow_out_of_order_execution,
        }
        aid = self._call("client_create_actor", cls, tuple(args),
                         dict(kwargs), opts, timeout=120)
        self._actor_classes[ActorID(aid)] = cls
        return ActorID(aid)

    def submit_actor_task(self, actor_id: ActorID, method_name: str, args,
                          kwargs, num_returns: int = 1) -> List[ObjectRef]:
        self.flush_refs()
        pairs = self._call("submit_actor_task", actor_id.binary(),
                           method_name, tuple(args), dict(kwargs),
                           num_returns, timeout=60)
        return [self._make_ref(o, owner) for o, owner in pairs]

    def get_actor(self, name: str, namespace: str = "default") -> ActorID:
        found = self._call("get_actor", name, namespace, timeout=30)
        aid, cls = found
        actor_id = ActorID(aid)
        if cls is not None:
            self._actor_classes[actor_id] = cls
        return actor_id

    def actor_class_of(self, actor_id: ActorID):
        return self._actor_classes.get(actor_id)

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True) -> None:
        self._call("kill_actor", actor_id.binary(), no_restart, timeout=30)

    def list_actors(self):
        return self._call("list_actors", timeout=30)

    # ---------------------------------------------------------- ref plumbing

    def on_ref_deserialized(self, oid: ObjectID,
                            owner_addr: Optional[str]) -> None:
        with self._holds_lock:
            self._holds_buf.append((oid.binary(), owner_addr))

    def resolve_record(self, rec: _Record) -> Any:
        if rec.is_exception:
            raise rec.value
        return rec.value

    def register_ready_callback(self, oid: ObjectID, cb: Callable) -> None:
        """Powers ObjectRef.future()/await from a client process: resolve
        on a background thread (the gateway does the real async wait)."""
        ref = ObjectRef(oid, None, _add_local_ref=False)

        def run():
            try:
                value = self.get([ref], timeout=None)[0]
            except BaseException as e:  # noqa: BLE001
                cb(_Record(e, True))
                return
            cb(_Record(value, False))

        threading.Thread(target=run, daemon=True,
                         name=f"client-await-{oid.hex()[:8]}").start()

    # ---------------------------------------------------------- cluster info

    def nodes(self):
        return self._call("nodes", timeout=30)

    def cluster_resources(self) -> Dict[str, float]:
        total, _ = self._call("cluster_resources", timeout=30)
        return total

    def available_resources(self) -> Dict[str, float]:
        _, avail = self._call("cluster_resources", timeout=30)
        return avail

    # ---------------------------------------------------------- kv

    def kv_put(self, key: str, value: bytes, *, namespace: str = "default",
               overwrite: bool = True) -> bool:
        data = value if isinstance(value, bytes) else str(value).encode()
        return self._call("kv", "put", namespace, key.encode(), data,
                          {"overwrite": overwrite}, timeout=30)

    def kv_get(self, key: str, *, namespace: str = "default"):
        return self._call("kv", "get", namespace, key.encode(), None, {},
                          timeout=30)

    def kv_del(self, key: str, *, namespace: str = "default") -> bool:
        return self._call("kv", "del", namespace, key.encode(), None, {},
                          timeout=30)

    def kv_keys(self, prefix: str = "", *,
                namespace: str = "default") -> List[str]:
        return self._call("kv", "keys", namespace, prefix.encode(), None, {},
                          timeout=30)

    # ---------------------------------------------------------- lifecycle

    def shutdown(self) -> None:
        if self._shutdown:
            return
        self._shutdown = True
        self._stop_event.set()  # wake the flusher out of its sleep
        try:
            self.flush_refs()
        except Exception:
            pass
        # Ordered teardown: the flusher must not race flush_refs against
        # the closing connection (it exits promptly — the stop event is
        # set before the join).
        if self._flusher.is_alive() and \
                self._flusher is not threading.current_thread():
            self._flusher.join(timeout=5.0)
        self._conn.close()
