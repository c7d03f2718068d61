"""Public API: init / shutdown / remote / get / put / wait / kill / actors
(``ray_tpu/api.py``, over the in-process runtime).

Parity target: python/ray/_private/worker.py public functions in the reference
(ray.init :1275, get :2635, put :2803, wait :2868, get_actor :3013, remote
 :3256), rebuilt over the runtime interface in core/.

Only ``init(local_mode=True)`` / ``init(address="local")`` starts a runtime
here: ``LocalRuntime``, tasks on a thread pool and actors on their own
ordered executors. Every other address, the default ``None`` included (which
starts a cluster in ``ray_tpu``), raises ``NotImplementedError`` until the
cluster runtime is ported (ROADMAP.md, queue 1, item 9a).
"""

from __future__ import annotations

import inspect
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
    local_mode: bool = False,
    ignore_reinit_error: bool = False,
    _system_config: Optional[Dict[str, Any]] = None,
):
    """Start the in-process runtime.

    - ``address="local"`` or ``local_mode=True``: in-process thread runtime.
    - anything else raises ``NotImplementedError``: the cluster runtime is
      not ported yet. It never falls back to the local runtime.
    """
    if not (local_mode or address == "local"):
        raise NotImplementedError(
            f"ray_tpu_torch.init(address={address!r}): only the in-process "
            "runtime is ported (init(local_mode=True)); the cluster runtime "
            "is ROADMAP.md, queue 1, item 9a")
    with _init_lock:
        if is_initialized():
            if ignore_reinit_error:
                return get_runtime()
            raise RuntimeError("ray_tpu_torch.init() called twice; pass "
                               "ignore_reinit_error=True")
        if _system_config:
            GLOBAL_CONFIG.apply_system_config(_system_config)
        from ray_tpu_torch.core.local_runtime import LocalRuntime

        rt = LocalRuntime(num_cpus=num_cpus)
        runtime_context.set_runtime(rt)
        return rt


def shutdown() -> None:
    rt = get_runtime()
    if rt is not None:
        rt.shutdown()
        runtime_context.set_runtime(None)
        GLOBAL_CONFIG.clear_exported_env()


def put(value: Any, *, _owner=None) -> ObjectRef:
    if isinstance(value, ObjectRef):
        raise TypeError("Calling put() on an ObjectRef is not allowed")
    return require_runtime().put(value, _owner=_owner)


def get(refs: Union[ObjectRef, Sequence[ObjectRef]], *, timeout: Optional[float] = None):
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
