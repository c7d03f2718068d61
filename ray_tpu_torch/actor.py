"""Actor decorator machinery: ActorClass, ActorHandle, ActorMethod
(``ray_tpu/actor.py``; ``.bind`` into a compiled DAG waits for the DAG
channels, ROADMAP.md, queue 1, item 9b).

Parity target: python/ray/actor.py in the reference (ActorClass._remote,
ActorHandle._actor_method_call), redesigned without code generation: handles
resolve methods dynamically and serialize as (actor_id, method signatures).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

from ray_tpu_torch.core.ids import ActorID
from ray_tpu_torch.core.runtime_context import require_runtime


class ActorMethod:
    def __init__(self, handle: "ActorHandle", method_name: str, num_returns: int = 1):
        self._handle = handle
        self._method_name = method_name
        self._num_returns = num_returns

    def remote(self, *args, **kwargs):
        return self._handle._actor_method_call(
            self._method_name, args, kwargs, self._num_returns
        )

    def options(self, num_returns: int = 1, **_ignored) -> "ActorMethod":
        return ActorMethod(self._handle, self._method_name, num_returns)

    def bind(self, *args, **kwargs):
        """Author a compiled-DAG node (reference: ray.dag .bind syntax):
        not ported yet."""
        raise NotImplementedError(
            "actor method .bind (compiled DAGs) is not ported yet: "
            "ROADMAP.md, queue 1, item 9b (the DAG channels)")

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor methods cannot be called directly; use "
            f".{self._method_name}.remote()"
        )


class ActorHandle:
    """Serializable handle; method access returns ActorMethod wrappers."""

    def __init__(self, actor_id: ActorID, method_num_returns: Optional[Dict[str, int]] = None):
        object.__setattr__(self, "_actor_id", actor_id)
        object.__setattr__(self, "_method_num_returns", method_num_returns or {})

    @property
    def actor_id(self) -> ActorID:
        return self._actor_id

    def _actor_method_call(self, method_name: str, args, kwargs, num_returns: int):
        rt = require_runtime()
        refs = rt.submit_actor_task(self._actor_id, method_name, args, kwargs,
                                    num_returns=num_returns)
        if num_returns == 1:
            return refs[0]
        return refs

    def __getattr__(self, item: str):
        if item.startswith("_"):
            raise AttributeError(item)
        return ActorMethod(self, item, self._method_num_returns.get(item, 1))

    def __repr__(self):
        return f"ActorHandle({self._actor_id.hex()[:16]})"

    def __hash__(self):
        return hash(self._actor_id)

    def __eq__(self, other):
        return isinstance(other, ActorHandle) and other._actor_id == self._actor_id

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._method_num_returns))


class ActorClass:
    """Result of @ray_tpu_torch.remote on a class."""

    def __init__(self, cls, default_options: Dict[str, Any]):
        from ray_tpu_torch.remote_function import validate_options

        validate_options(default_options)
        self._cls = cls
        self._default_options = default_options
        functools.update_wrapper(self, cls, updated=[])

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actors must be created with {self._cls.__name__}.remote(), "
            f"not {self._cls.__name__}()."
        )

    def options(self, **overrides) -> "ActorClass":
        merged = dict(self._default_options)
        merged.update(overrides)
        return ActorClass(self._cls, merged)

    def method_num_returns(self) -> Dict[str, int]:
        """Collects @ray_tpu_torch.method(num_returns=N) annotations off the
        class."""
        out: Dict[str, int] = {}
        for name in dir(self._cls):
            m = getattr(self._cls, name, None)
            n = getattr(m, "__ray_tpu_num_returns__", None)
            if n is not None:
                out[name] = n
        return out

    def remote(self, *args, **kwargs) -> ActorHandle:
        rt = require_runtime()
        opts = self._default_options
        resources, defaulted = _resources_from_options(opts)
        actor_id = rt.create_actor(
            self._cls, args, kwargs,
            release_resources=defaulted,
            name=opts.get("name"),
            namespace=opts.get("namespace", "default"),
            max_concurrency=opts.get("max_concurrency", 1),
            concurrency_groups=opts.get("concurrency_groups"),
            max_restarts=opts.get("max_restarts", 0),
            max_task_retries=opts.get("max_task_retries", 0),
            resources=resources,
            lifetime=opts.get("lifetime"),
            scheduling_strategy=opts.get("scheduling_strategy"),
            get_if_exists=opts.get("get_if_exists", False),
            runtime_env=opts.get("runtime_env"),
            allow_out_of_order_execution=opts.get(
                "allow_out_of_order_execution", False),
        )
        return ActorHandle(actor_id, self.method_num_returns())

    @property
    def underlying_class(self):
        return self._cls


def _resources_from_options(opts: Dict[str, Any]):
    """Returns (resources, defaulted). `defaulted` drives the reference's
    actor resource semantics: an actor with no explicit resources costs
    1 CPU to schedule its creation but holds 0 while alive (the node
    releases the lease's resources at mark_actor_host)."""
    from ray_tpu_torch.core.resources import ResourceSet

    d: Dict[str, float] = dict(opts.get("resources") or {})
    if opts.get("num_cpus") is not None:
        d["CPU"] = float(opts["num_cpus"])
    if opts.get("num_gpus") is not None:
        d["GPU"] = float(opts["num_gpus"])
    if opts.get("num_tpus") is not None:
        d["TPU"] = float(opts["num_tpus"])
    if opts.get("memory") is not None:
        d["memory"] = float(opts["memory"])
    defaulted = not d
    if defaulted:
        d["CPU"] = 1.0
    return ResourceSet.from_dict(d), defaulted
