"""Dask-graph scheduler over cluster tasks
(``ray_tpu/util/dask_backend.py``).

Parity target: the reference's ray_dask_get (reference:
python/ray/util/dask/scheduler.py — a dask custom scheduler submitting
graph tasks as Ray tasks, results as ObjectRefs). The dask graph PROTOCOL
is a plain dict {key: computation} where a computation is a literal, a key
reference, or a task tuple (callable, *args) — so the scheduler works with
or without dask installed (with dask, pass
``get=ray_tpu_dask_get`` to ``.compute()`` and the same entry point runs).

Scheduling: one cluster task per graph task, submitted in topological
order with ObjectRefs as upstream arguments — the runtime's scheduler
gives inter-task parallelism for free and intermediate results live in
the object store, not the driver.
"""

from __future__ import annotations

from typing import Any, Dict, List

import ray_tpu_torch

_UNPACK_MARKER = "__rtpu_dask_unpack__"


def _is_task(x: Any) -> bool:
    return isinstance(x, tuple) and len(x) > 0 and callable(x[0])


def _is_key(x: Any, dsk: Dict) -> bool:
    if _is_task(x):
        return False
    try:
        return x in dsk  # tuples holding lists etc. are unhashable
    except TypeError:
        return False


def _toposort(dsk: Dict) -> List[Any]:
    """Graph keys in dependency order (cycle -> ValueError). Iterative
    DFS: generated graphs routinely chain thousands of tasks, far past
    Python's recursion limit."""
    order: List[Any] = []
    state: Dict[Any, int] = {}  # 1 = visiting, 2 = done

    def deps_of(expr, out):
        stack = [expr]
        while stack:
            e = stack.pop()
            if _is_task(e):
                stack.extend(e[1:])
            elif isinstance(e, list):
                stack.extend(e)
            elif _is_key(e, dsk):
                out.append(e)
        return out

    for root in dsk:
        if state.get(root) == 2:
            continue
        stack = [(root, False)]
        while stack:
            key, expanded = stack.pop()
            if expanded:
                state[key] = 2
                order.append(key)
                continue
            st = state.get(key)
            if st == 2:
                continue
            if st == 1:
                raise ValueError(f"dask graph cycle through {key!r}")
            state[key] = 1
            stack.append((key, True))
            for d in deps_of(dsk[key], []):
                st_d = state.get(d)
                if st_d == 1:
                    raise ValueError(f"dask graph cycle through {d!r}")
                if st_d != 2:
                    stack.append((d, False))
    return order


def _execute_expr(expr, resolved):
    """Worker-side: rebuild the expression with upstream VALUES.

    ``resolved`` maps key -> value for this task's dependencies (shipped
    as ObjectRefs, already materialized by arg resolution)."""
    if _is_task(expr):
        fn = expr[0]
        args = [_execute_expr(a, resolved) for a in expr[1:]]
        return fn(*args)
    if isinstance(expr, list):
        return [_execute_expr(a, resolved) for a in expr]
    if isinstance(expr, tuple) and len(expr) == 2 and expr[0] == _UNPACK_MARKER:
        return resolved[expr[1]]
    return expr


@ray_tpu_torch.remote
def _dask_task(expr, dep_keys, *dep_values):
    return _execute_expr(expr, dict(zip(dep_keys, dep_values)))


def ray_tpu_dask_get(dsk: Dict, keys, **_kwargs):
    """Evaluate dask-graph ``keys`` (a key, or arbitrarily nested lists of
    keys, per the dask get contract). Usable directly, or as dask's
    ``get=`` scheduler."""
    refs: Dict[Any, Any] = {}

    def subst(expr, deps: List[Any]):
        """Replace graph-key references with unpack markers + collect."""
        if _is_task(expr):
            return (expr[0],) + tuple(subst(a, deps) for a in expr[1:])
        if isinstance(expr, list):
            return [subst(a, deps) for a in expr]
        if _is_key(expr, dsk):
            if expr not in deps:
                deps.append(expr)
            return (_UNPACK_MARKER, expr)
        return expr

    for key in _toposort(dsk):
        expr = dsk[key]
        if _is_key(expr, dsk):
            refs[key] = refs[expr]  # pure alias
            continue
        if not _is_task(expr) and not isinstance(expr, list):
            # Literal: no task needed; ship by value where referenced.
            refs[key] = ray_tpu_torch.put(expr)
            continue
        deps: List[Any] = []
        shipped = subst(expr, deps)
        refs[key] = _dask_task.remote(shipped, list(deps),
                                      *[refs[d] for d in deps])

    # ONE batched get over every requested leaf (N sequential gets would
    # serialize the waits in completion order), then reshape.
    flat: List[Any] = []

    def gather(k):
        if isinstance(k, list):
            for x in k:
                gather(x)
        else:
            flat.append(refs[k])

    gather(keys)
    values = iter(ray_tpu_torch.get(flat))

    def rebuild(k):
        if isinstance(k, list):
            return [rebuild(x) for x in k]
        return next(values)

    return rebuild(keys)
