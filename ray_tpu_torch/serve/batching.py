"""@serve.batch: transparent dynamic request batching
(``ray_tpu/serve/batching.py``).

Parity target: reference python/ray/serve/batching.py:80 (_BatchQueue) —
calls accumulate until `max_batch_size` or `batch_wait_timeout_s`, then
the wrapped function runs ONCE on the list of inputs and must return a
list of per-input outputs. On TPU this is the difference between a matmul
per request and one batched matmul (static-shape bucketing belongs to the
model; this layer only gathers the batch).
"""

from __future__ import annotations

import functools
import threading
from concurrent.futures import Future
from typing import Any, Callable, List, Optional


class _BatchQueue:
    def __init__(self, fn: Callable, max_batch_size: int,
                 batch_wait_timeout_s: float):
        self._fn = fn
        self._max = max_batch_size
        self._timeout = batch_wait_timeout_s
        self._lock = threading.Lock()
        self._pending: List[Any] = []      # (self_obj, args, kwargs, future)
        self._timer: Optional[threading.Timer] = None

    def submit(self, self_obj, args, kwargs) -> Future:
        fut: Future = Future()
        flush_now = False
        with self._lock:
            self._pending.append((self_obj, args, kwargs, fut))
            if len(self._pending) >= self._max:
                flush_now = True
            elif self._timer is None:
                self._timer = threading.Timer(self._timeout, self._flush)
                self._timer.daemon = True
                self._timer.start()
        if flush_now:
            self._flush()
        return fut

    def _flush(self) -> None:
        with self._lock:
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
            batch = self._pending
            self._pending = []
        if not batch:
            return
        self_obj = batch[0][0]
        # First positional arg per call is the batched unit; EXTRA
        # args/kwargs are forwarded from the first call and must match
        # across the batch (mismatches fail loudly, not silently).
        extra_args = batch[0][1][1:] if batch[0][1] else ()
        extra_kwargs = batch[0][2]
        for _s, a, k, fut in batch[1:]:
            if (a[1:] if a else ()) != extra_args or k != extra_kwargs:
                e = ValueError(
                    "@serve.batch calls in one batch had differing extra "
                    "arguments; only the batched first positional may vary")
                for _s2, _a2, _k2, f2 in batch:
                    if not f2.done():
                        f2.set_exception(e)
                return
        inputs = [b[1][0] if b[1] else None for b in batch]
        try:
            if self_obj is not None:
                outputs = self._fn(self_obj, inputs, *extra_args,
                                   **extra_kwargs)
            else:
                outputs = self._fn(inputs, *extra_args, **extra_kwargs)
            if len(outputs) != len(inputs):
                raise ValueError(
                    f"@serve.batch function returned {len(outputs)} "
                    f"results for {len(inputs)} inputs")
            for (_s, _a, _k, fut), out in zip(batch, outputs):
                fut.set_result(out)
        except BaseException as e:  # noqa: BLE001 — every waiter learns
            for _s, _a, _k, fut in batch:
                if not fut.done():
                    fut.set_exception(e)


# Per-process queue registry: a _BatchQueue holds locks and timers, which
# would make decorated CLASSES unpicklable (deployments ship to replicas
# by value). Queues are created lazily in whichever process actually calls
# the function, via the module-level accessor below — dynamic closures
# must NOT reference these globals directly, or cloudpickle captures the
# registry (locks and all) by value into the shipped class.
_queues: dict = {}
_queues_lock = threading.Lock()


def _get_queue(key, fn, max_batch_size, batch_wait_timeout_s) -> _BatchQueue:
    with _queues_lock:
        q = _queues.get(key)
        if q is None:
            q = _queues[key] = _BatchQueue(fn, max_batch_size,
                                           batch_wait_timeout_s)
        return q


def _get_instance_queue(self_obj, attr, fn, max_batch_size,
                        batch_wait_timeout_s) -> _BatchQueue:
    q = getattr(self_obj, attr, None)
    if q is None:
        with _queues_lock:
            q = getattr(self_obj, attr, None)
            if q is None:
                q = _BatchQueue(fn, max_batch_size, batch_wait_timeout_s)
                object.__setattr__(self_obj, attr, q)
    return q


def batch(_fn: Optional[Callable] = None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01):
    """Decorator: calls collapse into list-in/list-out batched executions.

    Works on free functions and methods; the wrapped callable BLOCKS until
    its batch runs (replicas call it from request threads).
    """

    def wrap(fn: Callable):
        import inspect

        is_method = bool(list(inspect.signature(fn).parameters)[:1] == ["self"])
        key = (fn.__module__, fn.__qualname__)
        attr = f"__rtpu_batchq_{fn.__name__}"

        # NOTE: this dynamic wrapper must only reference module-level
        # FUNCTIONS (picklable by reference) — touching the registry lock
        # here would capture it by value into shipped deployment classes.
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if is_method and args:
                # Per-INSTANCE queue: two replicas of a deployment can
                # share one process; a per-function queue would run
                # replica B's requests against replica A's self.
                queue = _get_instance_queue(args[0], attr, fn,
                                            max_batch_size,
                                            batch_wait_timeout_s)
                fut = queue.submit(args[0], args[1:], kwargs)
            else:
                queue = _get_queue(key, fn, max_batch_size,
                                   batch_wait_timeout_s)
                fut = queue.submit(None, args, kwargs)
            return fut.result(timeout=60)

        return wrapper

    if _fn is not None:
        return wrap(_fn)
    return wrap
