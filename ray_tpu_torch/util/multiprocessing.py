"""multiprocessing.Pool-compatible shim over cluster tasks
(``ray_tpu/util/multiprocessing.py``).

Parity target: the reference's drop-in pool
(reference: python/ray/util/multiprocessing/pool.py — Pool with
map/imap/starmap/apply_async over Ray tasks, so existing
``multiprocessing`` code scales past one machine by changing an import).
``processes`` genuinely bounds in-flight chunk tasks (windowed
submission), matching the stdlib contract for throttling rate-limited or
memory-heavy work; ``chunksize`` items ride one task.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, List, Optional

import ray_tpu_torch


@ray_tpu_torch.remote
def _run_chunk(func: Callable, chunk: list, star: bool) -> list:
    if star:
        return [func(*args) for args in chunk]
    return [func(x) for x in chunk]


def _apply_one(call):
    func, args, kwds = call
    return func(*args, **kwds)


class AsyncResult:
    """Windowed: at most `window` chunk tasks in flight; the rest submit
    as results drain (lazily on get()/wait()/ready())."""

    def __init__(self, submit_fn: Optional[Callable], chunks: List[list],
                 window: int, single: bool = False, refs=None):
        self._submit = submit_fn
        self._pending = list(chunks)
        self._window = max(1, window)
        self._refs = list(refs or [])
        self._single = single
        self._results: List[Any] = []
        self._done = False
        self._error: Optional[BaseException] = None

    def _pump(self, block: bool) -> None:
        while self._pending or self._refs:
            while self._pending and len(self._refs) < self._window:
                self._refs.append(self._submit(self._pending.pop(0)))
            if not block:
                return
            ref = self._refs.pop(0)
            self._results.append(ray_tpu_torch.get(ref))
        self._done = True

    def get(self, timeout: Optional[float] = None):
        import time

        from ray_tpu_torch.exceptions import GetTimeoutError

        if self._error is not None:
            raise self._error  # stdlib: every get() re-raises the failure
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self._done:
            while self._pending and len(self._refs) < self._window:
                self._refs.append(self._submit(self._pending.pop(0)))
            if not self._refs:
                self._done = True
                break
            ref = self._refs[0]
            t = (None if deadline is None
                 else max(0.001, deadline - time.monotonic()))
            try:
                value = ray_tpu_torch.get(ref, timeout=t)
            except (GetTimeoutError, TimeoutError):
                # Not consumed: the ref stays at the front so a later
                # get() retries instead of silently dropping the chunk.
                raise
            except BaseException as e:  # noqa: BLE001 — sticky task error
                self._error = e
                raise
            self._refs.pop(0)
            self._results.append(value)
        if self._single:
            return self._results[0][0]  # one chunk of one item
        return [x for chunk in self._results for x in chunk]

    def wait(self, timeout: Optional[float] = None) -> None:
        try:
            self.get(timeout=timeout)
        except Exception:
            pass

    def ready(self) -> bool:
        if self._done or self._error is not None:
            return True
        # Pump submissions: polling ready() on a fresh result must start
        # the work (stdlib pools run eagerly).
        while self._pending and len(self._refs) < self._window:
            self._refs.append(self._submit(self._pending.pop(0)))
        if self._pending:
            return False
        if not self._refs:
            return True
        done, _ = ray_tpu_torch.wait(self._refs, num_returns=len(self._refs),
                               timeout=0)
        return len(done) == len(self._refs)

    def successful(self) -> bool:
        # stdlib contract: raises when not ready, never conflates
        # "pending" with "failed".
        if not self.ready():
            raise ValueError("result is not ready")
        try:
            self.get(timeout=60)
            return True
        except Exception:
            return False


class Pool:
    """Tasks-backed process pool; ``processes`` bounds concurrent chunk
    tasks."""

    def __init__(self, processes: Optional[int] = None):
        import os

        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        self._processes = processes or os.cpu_count() or 1
        self._closed = False

    # ---------------------------------------------------------------- core

    def _chunks(self, iterable: Iterable, chunksize: Optional[int]):
        items = list(iterable)
        if chunksize is None:
            chunksize = max(1, len(items) // (self._processes * 4) or 1)
        return [items[i:i + chunksize]
                for i in range(0, len(items), chunksize)]

    def _async(self, func: Callable, chunks: List[list],
               star: bool) -> AsyncResult:
        return AsyncResult(
            lambda c: _run_chunk.remote(func, c, star), chunks,
            window=self._processes)

    # ----------------------------------------------------------------- API

    def map(self, func: Callable, iterable: Iterable,
            chunksize: Optional[int] = None) -> List[Any]:
        return self.map_async(func, iterable, chunksize).get()

    def map_async(self, func, iterable,
                  chunksize: Optional[int] = None) -> AsyncResult:
        self._check_open()
        return self._async(func, self._chunks(iterable, chunksize), False)

    def starmap(self, func: Callable, iterable: Iterable,
                chunksize: Optional[int] = None) -> List[Any]:
        self._check_open()
        return self._async(func, self._chunks(iterable, chunksize),
                           True).get()

    def imap(self, func: Callable, iterable: Iterable,
             chunksize: int = 1):
        self._check_open()
        pending = self._chunks(iterable, chunksize)
        refs: List[Any] = []
        while pending or refs:
            while pending and len(refs) < self._processes:
                refs.append(_run_chunk.remote(func, pending.pop(0), False))
            for x in ray_tpu_torch.get(refs.pop(0)):  # ordered
                yield x

    def imap_unordered(self, func: Callable, iterable: Iterable,
                       chunksize: int = 1):
        self._check_open()
        pending = self._chunks(iterable, chunksize)
        refs: List[Any] = []
        while pending or refs:
            while pending and len(refs) < self._processes:
                refs.append(_run_chunk.remote(func, pending.pop(0), False))
            done, refs = ray_tpu_torch.wait(refs, num_returns=1, timeout=300)
            for ref in done:
                for x in ray_tpu_torch.get(ref):
                    yield x

    def apply(self, func: Callable, args: tuple = (),
              kwds: Optional[dict] = None):
        return self.apply_async(func, args, kwds).get()

    def apply_async(self, func: Callable, args: tuple = (),
                    kwds: Optional[dict] = None) -> AsyncResult:
        self._check_open()
        kwds = dict(kwds or {})
        # One chunk of one item carrying (args, kwds): rides the shared
        # module-level task like everything else.
        call = (func, args, kwds)
        return AsyncResult(
            lambda c: _run_chunk.remote(_apply_one, c, False),
            [[call]], window=1, single=True)

    # ------------------------------------------------------------ lifecycle

    def _check_open(self):
        if self._closed:
            raise ValueError("Pool not running")

    def close(self) -> None:
        self._closed = True

    def terminate(self) -> None:
        self._closed = True

    def join(self) -> None:
        if not self._closed:
            raise ValueError("Pool is still running")

    def __enter__(self) -> "Pool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
