"""@ray_tpu_torch.remote on functions (``ray_tpu/remote_function.py``).

Parity target: python/ray/remote_function.py (RemoteFunction._remote) in the
reference; options normalization mirrors python/ray/_private/ray_option_utils.py.
"""

from __future__ import annotations

import functools
import weakref
from typing import Any, Dict

from ray_tpu_torch.core.runtime_context import require_runtime

_VALID_OPTIONS = {
    "num_cpus", "num_gpus", "num_tpus", "memory", "resources", "num_returns",
    "max_retries", "retry_exceptions", "scheduling_strategy", "name",
    "runtime_env", "max_concurrency", "max_restarts", "max_task_retries",
    "lifetime", "namespace", "get_if_exists", "placement_group",
    "max_calls", "concurrency_groups", "label_selector",
    "allow_out_of_order_execution",
    "generator_backpressure_num_objects",
}


def validate_options(opts: Dict[str, Any]) -> Dict[str, Any]:
    unknown = set(opts) - _VALID_OPTIONS
    if unknown:
        raise ValueError(f"invalid option(s): {sorted(unknown)}")
    nr = opts.get("num_returns")
    if nr is not None and not (nr in ("dynamic", "streaming")
                               or (isinstance(nr, int) and nr >= 0)):
        raise ValueError("num_returns must be a non-negative int, "
                         "'dynamic', or 'streaming'")
    return opts


class RemoteFunction:
    def __init__(self, func, default_options: Dict[str, Any]):
        self._func = func
        self._default_options = validate_options(default_options)
        self._tmpl = None       # cached submit template (cluster runtimes)
        self._tmpl_rt = None    # runtime the template was built against
        functools.update_wrapper(self, func)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote functions must be invoked with "
            f"{self._func.__name__}.remote(), not called directly."
        )

    def options(self, **overrides) -> "RemoteFunction":
        merged = dict(self._default_options)
        merged.update(overrides)
        return RemoteFunction(self._func, merged)

    def remote(self, *args, **kwargs):
        rt = require_runtime()
        opts = self._default_options
        num_returns = opts.get("num_returns", 1)
        if num_returns == "dynamic":
            num_returns = 1  # dynamic generators collapse to one list ref
        if num_returns == "streaming":
            make_tmpl = getattr(rt, "make_submit_template", None)
            if make_tmpl is None:
                raise RuntimeError(
                    "num_returns='streaming' requires the cluster runtime")
            if self._tmpl is None or (self._tmpl_rt() if self._tmpl_rt
                                      else None) is not rt:
                self._tmpl = make_tmpl(
                    self._func, num_returns="streaming",
                    resources=_task_resources(opts),
                    max_retries=0, retry_exceptions=False,
                    scheduling_strategy=opts.get("scheduling_strategy"),
                    name=opts.get("name") or self._func.__qualname__,
                    runtime_env=opts.get("runtime_env"),
                    generator_backpressure_num_objects=opts.get(
                        "generator_backpressure_num_objects"))
                self._tmpl_rt = weakref.ref(rt)
            return rt.submit_templated(self._tmpl, args, kwargs)
        make_tmpl = getattr(rt, "make_submit_template", None)
        if make_tmpl is not None:
            # Hot path: option normalization + constant spec fields are
            # computed once per (function, runtime) and cached. The runtime
            # is held via weakref so a module-level @remote function does
            # not pin a shut-down runtime's sockets/stores alive.
            cached_rt = self._tmpl_rt() if self._tmpl_rt is not None else None
            if self._tmpl is None or cached_rt is not rt:
                self._tmpl = make_tmpl(
                    self._func,
                    num_returns=num_returns,
                    resources=_task_resources(opts),
                    max_retries=opts.get("max_retries", 0),
                    retry_exceptions=bool(opts.get("retry_exceptions",
                                                   False)),
                    scheduling_strategy=opts.get("scheduling_strategy"),
                    name=opts.get("name") or self._func.__qualname__,
                    runtime_env=opts.get("runtime_env"),
                )
                self._tmpl_rt = weakref.ref(rt)
            refs = rt.submit_templated(self._tmpl, args, kwargs)
        else:
            refs = rt.submit_task(
                self._func, args, kwargs,
                num_returns=num_returns,
                resources=_task_resources(opts),
                max_retries=opts.get("max_retries", 0),
                retry_exceptions=bool(opts.get("retry_exceptions", False)),
                scheduling_strategy=opts.get("scheduling_strategy"),
                name=opts.get("name") or self._func.__qualname__,
                runtime_env=opts.get("runtime_env"),
            )
        if opts.get("num_returns", 1) == 1 or opts.get("num_returns") == "dynamic":
            return refs[0]
        if opts.get("num_returns", 1) == 0:
            return None
        return refs

    @property
    def underlying_function(self):
        return self._func

    def __getstate__(self):
        # The submit-template cache holds runtime handles (locks, sockets);
        # it is a per-process cache, never shipped.
        return {"_func": self._func,
                "_default_options": self._default_options}

    def __setstate__(self, state):
        self._func = state["_func"]
        self._default_options = state["_default_options"]
        self._tmpl = None
        self._tmpl_rt = None
        functools.update_wrapper(self, self._func)


def _task_resources(opts: Dict[str, Any]):
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
    if "CPU" not in d:
        d["CPU"] = 1.0
    return ResourceSet.from_dict(d)
