"""Public API: init / shutdown / remote / get / put / wait / kill / actors
(``ray_tpu/api.py``).

Parity target: python/ray/_private/worker.py public functions in the reference
(ray.init :1275, get :2635, put :2803, wait :2868, get_actor :3013, remote
 :3256), rebuilt over the runtime interface in core/.

``init()`` starts a single-node cluster (a head, a node manager and worker
processes over the shm object store), ``init("host:port")`` joins one, and
``init(local_mode=True)`` keeps everything in this process on threads, and
``init("client://host:port")`` drives a cluster through a client gateway
(``client/``) from a process that is not part of it.
"""

from __future__ import annotations

import inspect
import os
import threading
from typing import Any, Dict, List, Optional, Sequence, Union

from ray_tpu_torch.actor import ActorClass, ActorHandle
from ray_tpu_torch.core import runtime_context
from ray_tpu_torch.core.config import GLOBAL_CONFIG
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.runtime_context import get_runtime, require_runtime
from ray_tpu_torch.remote_function import RemoteFunction, validate_options

_init_lock = threading.Lock()


def is_initialized() -> bool:
    return get_runtime() is not None


def init(
    address: Optional[str] = None,
    *,
    num_cpus: Optional[float] = None,
    num_gpus: Optional[float] = None,
    resources: Optional[Dict[str, float]] = None,
    local_mode: bool = False,
    ignore_reinit_error: bool = False,
    object_store_memory: Optional[int] = None,
    labels: Optional[Dict[str, str]] = None,
    _system_config: Optional[Dict[str, Any]] = None,
):
    """Start (or connect to) a runtime.

    - ``address=None``: start a single-node cluster: a head and a node
      manager process, worker processes, the node's shm object store.
      ``num_gpus`` takes ``ray_tpu``'s ``num_tpus`` place; without
      ``num_cpus``/``num_gpus``/``resources`` the node counts this host's
      CPUs and CUDA cards.
    - ``address="host:port"``: join an existing cluster's head.
    - ``address="local"`` or ``local_mode=True``: in-process thread runtime.
    - ``address="client://host:port"``: a remote driver; everything rides
      one framed-RPC connection to a gateway
      (``ray_tpu_torch.client.server.start_gateway``).
    - ``address=None`` with ``RTPU_ADDRESS`` set (a submitted job's
      driver): join that cluster.
    """
    with _init_lock:
        if is_initialized():
            if ignore_reinit_error:
                return get_runtime()
            raise RuntimeError("ray_tpu_torch.init() called twice; pass "
                               "ignore_reinit_error=True")
        if _system_config:
            GLOBAL_CONFIG.apply_system_config(_system_config)
        if object_store_memory is not None:
            GLOBAL_CONFIG.set("object_store_memory_bytes",
                              int(object_store_memory))
        if address is None:
            address = os.environ.get("RTPU_ADDRESS") or None
        if local_mode or address == "local":
            from ray_tpu_torch.core.local_runtime import LocalRuntime

            rt = LocalRuntime(num_cpus=num_cpus)
        elif address is not None and address.startswith("client://"):
            from ray_tpu_torch.client.runtime import ClientRuntime

            rt = ClientRuntime(address)
        else:
            from ray_tpu_torch.core.cluster_runtime import ClusterRuntime

            rt = ClusterRuntime(
                address=address,
                num_cpus=num_cpus,
                num_gpus=num_gpus,
                resources=resources,
                object_store_memory=object_store_memory,
                labels=labels,
            )
        runtime_context.set_runtime(rt)
        return rt


def shutdown() -> None:
    rt = get_runtime()
    if rt is not None:
        try:
            from ray_tpu_torch.util import pubsub

            pubsub.close()  # stop the rejoin loop before the head dies
        except Exception:
            pass
        rt.shutdown()
        runtime_context.set_runtime(None)
        GLOBAL_CONFIG.clear_exported_env()


def put(value: Any, *, _owner=None) -> ObjectRef:
    """Seals ``value`` as an object; it cannot change after. A CUDA tensor
    is staged through the host and comes back onto the getter's card."""
    if isinstance(value, ObjectRef):
        raise TypeError("Calling put() on an ObjectRef is not allowed")
    return require_runtime().put(value, _owner=_owner)


def get(refs: Union[ObjectRef, Sequence[ObjectRef]], *, timeout: Optional[float] = None):
    """The objects' values. A CPU tensor read from the shm store (so is a
    task's argument) shares the store's pages copy-on-write: writing into
    it is allowed and changes this value alone, never the object."""
    return require_runtime().get(refs, timeout=timeout)


def wait(
    refs: List[ObjectRef],
    *,
    num_returns: int = 1,
    timeout: Optional[float] = None,
    fetch_local: bool = True,
):
    if isinstance(refs, ObjectRef):
        raise TypeError("wait() expects a list of ObjectRefs")
    if num_returns > len(refs):
        raise ValueError("num_returns exceeds the number of refs")
    if num_returns <= 0:
        raise ValueError("num_returns must be positive")
    return require_runtime().wait(refs, num_returns=num_returns, timeout=timeout,
                                  fetch_local=fetch_local)


def kill(actor: ActorHandle, *, no_restart: bool = True) -> None:
    if not isinstance(actor, ActorHandle):
        raise TypeError("kill() expects an ActorHandle")
    require_runtime().kill_actor(actor.actor_id, no_restart=no_restart)


def cancel(ref: ObjectRef, *, force: bool = False, recursive: bool = True) -> None:
    require_runtime().cancel(ref, force=force, recursive=recursive)


def get_actor(name: str, namespace: str = "default") -> ActorHandle:
    rt = require_runtime()
    actor_id = rt.get_actor(name, namespace)
    num_returns: Dict[str, int] = {}
    cls = rt.actor_class_of(actor_id)
    if cls is not None:
        for attr in dir(cls):
            n = getattr(getattr(cls, attr, None), "__ray_tpu_num_returns__", None)
            if n is not None:
                num_returns[attr] = n
    return ActorHandle(actor_id, num_returns)


def remote(*args, **options):
    """``@remote`` / ``@remote(**options)`` on a function or class."""

    def decorate(obj):
        if inspect.isclass(obj):
            return ActorClass(obj, options)
        if inspect.isfunction(obj) or inspect.isbuiltin(obj) or callable(obj):
            return RemoteFunction(obj, options)
        raise TypeError(f"@remote cannot be applied to {type(obj).__name__}")

    if len(args) == 1 and callable(args[0]) and not options:
        return decorate(args[0])
    if args:
        raise TypeError("@remote options must be keyword arguments")
    validate_options(options)
    return decorate


def method(num_returns: int = 1, concurrency_group: Optional[str] = None,
           **_ignored):
    """Per-method options decorator (parity: ray.method — num_returns +
    concurrency_group routing, the reference's
    ConcurrencyGroupManager seam)."""

    def decorate(f):
        f.__ray_tpu_num_returns__ = num_returns
        if concurrency_group is not None:
            f.__ray_tpu_concurrency_group__ = concurrency_group
        return f

    return decorate


def nodes() -> List[Dict[str, Any]]:
    return require_runtime().nodes()


def cluster_resources() -> Dict[str, float]:
    return require_runtime().cluster_resources()


def available_resources() -> Dict[str, float]:
    return require_runtime().available_resources()


def timeline(filename: Optional[str] = None):
    """This process's task events as chrome-trace events, or written to
    ``filename`` (reference: ``ray timeline``)."""
    from ray_tpu_torch.util.timeline import dump_timeline

    return dump_timeline(filename)
