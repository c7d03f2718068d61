"""ActorPool: load-balanced work distribution over a fixed actor set
(``ray_tpu/util/actor_pool.py``).

Parity target: reference python/ray/util/actor_pool.py (ActorPool —
submit/map/map_unordered/get_next over idle-actor rotation).
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Iterable, List

import ray_tpu_torch


class ActorPool:
    """Distributes tasks over actors, keeping every actor busy.

    >>> pool = ActorPool([Worker.remote() for _ in range(4)])
    >>> list(pool.map(lambda a, v: a.double.remote(v), range(100)))
    """

    def __init__(self, actors: List[Any]):
        if not actors:
            raise ValueError("ActorPool needs at least one actor")
        self._idle = collections.deque(actors)
        self._future_to_actor = {}
        self._index_to_future = {}
        self._next_task_index = 0
        self._next_return_index = 0
        self._pending_submits = collections.deque()

    # ------------------------------------------------------------- submit

    def submit(self, fn: Callable[[Any, Any], Any], value: Any) -> None:
        """fn(actor, value) -> ObjectRef; queued if every actor is busy."""
        if self._idle:
            actor = self._idle.popleft()
            ref = fn(actor, value)
            self._future_to_actor[ref] = (self._next_task_index, actor)
            self._index_to_future[self._next_task_index] = ref
            self._next_task_index += 1
        else:
            self._pending_submits.append((fn, value))

    def has_next(self) -> bool:
        return bool(self._index_to_future) or bool(self._pending_submits)

    def has_free(self) -> bool:
        return bool(self._idle) and not self._pending_submits

    def _return_actor(self, actor) -> None:
        self._idle.append(actor)
        if self._pending_submits:
            self.submit(*self._pending_submits.popleft())

    # -------------------------------------------------------------- fetch

    def get_next(self, timeout: float = None) -> Any:
        """Next result IN SUBMISSION ORDER."""
        if not self.has_next():
            raise StopIteration("no more results")
        idx = self._next_return_index
        while idx not in self._index_to_future:
            if not self._pending_submits:
                raise StopIteration("no more results")
            # Everything before idx queued behind busy actors: drain one.
            self.get_next_unordered(timeout)
        ref = self._index_to_future.pop(idx)
        self._next_return_index += 1
        _i, actor = self._future_to_actor.pop(ref)
        self._return_actor(actor)
        return ray_tpu_torch.get(ref, timeout=timeout)

    def get_next_unordered(self, timeout: float = None) -> Any:
        """Next result in COMPLETION order."""
        if not self.has_next():
            raise StopIteration("no more results")
        refs = list(self._future_to_actor)
        ready, _ = ray_tpu_torch.wait(refs, num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("no result within timeout")
        ref = ready[0]
        idx, actor = self._future_to_actor.pop(ref)
        self._index_to_future.pop(idx, None)
        if idx == self._next_return_index:
            self._next_return_index += 1
        self._return_actor(actor)
        return ray_tpu_torch.get(ref, timeout=timeout)

    # ---------------------------------------------------------------- map

    def map(self, fn: Callable[[Any, Any], Any],
            values: Iterable[Any]) -> Iterable[Any]:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable[[Any, Any], Any],
                      values: Iterable[Any]) -> Iterable[Any]:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()
