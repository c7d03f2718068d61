"""Streaming execution: pipelined operators over block refs
(``ray_tpu/data/_streaming.py``).

Parity target: reference python/ray/data/_internal/execution/
streaming_executor.py (:48, scheduling step :281) + operators/
(TaskPoolMapOperator, ActorPoolMapOperator) + backpressure_policy/ —
re-shaped: instead of a scheduling thread ranking operators by memory
pressure, each operator is a bounded-concurrency *pull generator* over the
upstream stream. Pulling from the sink drives the whole pipeline; blocks
flow operator-to-operator as object refs (never materialized on the
driver), and backpressure is two-tier: per-operator concurrency caps plus
a pipeline-wide MEMORY BUDGET on bytes in flight (the reference's
ResourceManager + backpressure_policy/ role, re-shaped for pull style).

The logical plan is optimized before execution (reference:
_internal/logical/rules/operator_fusion.py, limit_pushdown.py): adjacent
stateless map stages fuse into one task per block, and limits push below
row-preserving maps so work past the limit is never launched.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.data.block import Block, BlockAccessor, BlockMetadata

RefBundle = Tuple[ObjectRef, BlockMetadata]


def _apply_batch_fn(block: Block, fn: Callable, fn_kwargs: Dict[str, Any],
                    batch_size: Optional[int]) -> Block:
    """Run a user batch fn over one block (in batch_size windows)."""
    acc = BlockAccessor(block)
    n = acc.num_rows()
    if batch_size is None or batch_size >= n:
        out = fn(acc.to_batch(), **fn_kwargs)
        return BlockAccessor.normalize(out)
    outs = []
    for start in range(0, n, batch_size):
        out = fn(acc.slice(start, min(start + batch_size, n)), **fn_kwargs)
        outs.append(BlockAccessor.normalize(out))
    return BlockAccessor.concat(outs)


class MapStage:
    """One fused link of a map chain: (fn, kwargs, batch_size, pass_index)."""

    __slots__ = ("fn", "kwargs", "batch_size", "pass_index", "name")

    def __init__(self, fn: Callable, kwargs: Dict[str, Any],
                 batch_size: Optional[int], pass_index: bool, name: str):
        self.fn = fn
        self.kwargs = kwargs
        self.batch_size = batch_size
        self.pass_index = pass_index
        self.name = name


def _apply_stages(block: Block, stages: List[MapStage], index: int) -> Block:
    for st in stages:
        kw = (dict(st.kwargs, _block_index=index) if st.pass_index
              else st.kwargs)
        block = _apply_batch_fn(block, st.fn, kw, st.batch_size)
    return block


class MemoryBudget:
    """Pipeline-wide cap on bytes of blocks in flight. Admission is
    optimistic for the first block of each operator (a pipeline must never
    deadlock at zero concurrency), strict beyond."""

    def __init__(self, limit_bytes: int):
        self.limit = limit_bytes
        self._used = 0
        self._lock = threading.Lock()

    def can_admit(self, estimate: int, holding: int) -> bool:
        """holding: bytes this operator already has in flight — an operator
        with nothing in flight is always admitted (liveness)."""
        if self.limit <= 0:
            return True
        with self._lock:
            return holding == 0 or self._used + estimate <= self.limit

    def acquire(self, n: int) -> None:
        if self.limit <= 0:
            return
        with self._lock:
            self._used += n

    def release(self, n: int) -> None:
        if self.limit <= 0:
            return
        with self._lock:
            self._used -= n

    def used(self) -> int:
        with self._lock:
            return self._used


class ExecContext:
    """Per-execution shared state handed to every operator."""

    def __init__(self, memory_budget_bytes: Optional[int] = None):
        self.budget = MemoryBudget(
            cfg.data_memory_budget_bytes if memory_budget_bytes is None
            else memory_budget_bytes)
        #: Teardown hooks that must outlive individual operator
        #: generators: a streaming map stage's lane actors own blocks
        #: that DOWNSTREAM stages still read after the stage's own
        #: generator exhausts, so lanes die at pipeline close, not at
        #: stage close (execute_plan runs these on exhaustion, error, or
        #: consumer abandonment).
        self._finalizers: List[Callable[[], None]] = []
        #: Wire context of the consumer's root span (e.g. one
        #: ``iter_batches`` call) — operator spans parent to it so the
        #: whole pipeline renders as ONE timeline.
        self.trace_ctx: Optional[Dict[str, str]] = None

    def add_finalizer(self, fn: Callable[[], None]) -> None:
        self._finalizers.append(fn)

    def run_finalizers(self) -> None:
        fns, self._finalizers = self._finalizers[::-1], []
        for fn in fns:
            try:
                fn()
            except Exception:  # rtpu-lint: disable=swallowed-exception — finalizers are teardown; one failing must not mask others
                pass


class Operator:
    """One stage: transforms an upstream iterator of RefBundles."""

    name: str = "op"
    #: True when the op emits exactly the rows it receives (1:1, no
    #: reorder) — the condition for limit pushdown.
    preserves_rows: bool = False

    def execute(self, upstream: Iterator[RefBundle],
                ctx: Optional[ExecContext] = None) -> Iterator[RefBundle]:
        raise NotImplementedError


class InputOperator(Operator):
    """Source: materializes read tasks lazily (one task per input block)."""

    name = "input"

    def __init__(self, read_tasks: List[Callable[[], Block]],
                 parallelism: int = 4):
        self._tasks = read_tasks
        self._parallelism = parallelism

    def execute(self, upstream, ctx: Optional[ExecContext] = None
                ) -> Iterator[RefBundle]:
        assert upstream is None
        budget = ctx.budget if ctx else None
        est = cfg.data_block_size_estimate

        # num_returns=2: the BLOCK stays in the executing worker's store —
        # only the (tiny) metadata is fetched to the driver. Blocks move
        # worker-to-worker via the object plane, never through the driver.
        @ray_tpu_torch.remote(num_returns=2)
        def _read(task: Callable[[], Block]):
            block = BlockAccessor.normalize(task())
            return block, BlockMetadata.of(block)

        # Generator read tasks become STREAMING tasks: one task yields
        # many blocks incrementally (reads of a file's row groups, a huge
        # archive's members...) without ever materializing the whole
        # output in the worker — alternate yields of block then metadata
        # keep the blocks off the driver, matching _read's contract.
        # Mixed inputs partition: plain tasks keep the budgeted windowed
        # path, generator tasks stream (producer-side flow control bounds
        # their in-flight bytes).
        import inspect

        plain = [t for t in self._tasks
                 if not inspect.isgeneratorfunction(getattr(t, "func", t))]
        plain_ids = {id(t) for t in plain}
        gen_tasks = [t for t in self._tasks if id(t) not in plain_ids]
        if gen_tasks:
            yield from self._execute_streaming_reads(gen_tasks, ctx)
            if not plain:
                return

        pending = collections.deque(plain)
        in_flight: collections.deque = collections.deque()
        holding = 0
        while pending or in_flight:
            while pending and len(in_flight) < self._parallelism and (
                    budget is None or budget.can_admit(est, holding)):
                # Record the estimate ACQUIRED with each entry: `est` is
                # refined over time, and releasing a different value than
                # acquired would drift the shared budget counter.
                in_flight.append((_read.remote(pending.popleft()), est))
                if budget is not None:
                    budget.acquire(est)
                    holding += est
            # Preserve input order: wait on the OLDEST in-flight read.
            (block_ref, meta_ref), est0 = in_flight.popleft()
            meta = ray_tpu_torch.get(meta_ref)
            if budget is not None:
                budget.release(est0)
                holding -= est0
                # Refine the estimate with observed sizes.
                if meta.size_bytes:
                    est = max(1, (est + meta.size_bytes) // 2)
            yield block_ref, meta

    def _execute_streaming_reads(self, tasks: List[Callable],
                                 ctx: Optional[ExecContext]
                                 ) -> Iterator[RefBundle]:
        """Generator read tasks as streaming-generator tasks, up to
        `parallelism` concurrent, items consumed in yield order. Each
        task yields block, then BlockMetadata, alternating — the driver
        fetches only the metadata items. In-flight bytes are bounded by
        the producer-side stream window, SIZED from the pipeline memory
        budget (budget / (block estimate x live streams)) so big blocks
        cannot pile up 64-deep per stream regardless of their size."""
        budget_bytes = (ctx.budget.limit if ctx else 0)
        est = max(1, cfg.data_block_size_estimate)
        live_streams = max(1, min(self._parallelism, len(tasks)))
        if budget_bytes > 0:
            ahead_blocks = max(2, min(64, budget_bytes
                                      // (est * live_streams)))
        else:
            ahead_blocks = 64
        # Items alternate block/meta: 2 items per block.
        opts = {"generator_backpressure_num_objects": 2 * ahead_blocks}

        @ray_tpu_torch.remote(num_returns="streaming", **opts)
        def _read_stream(task):
            out = task()
            chunks = out if hasattr(out, "__next__") else [out]
            for chunk in chunks:
                block = BlockAccessor.normalize(chunk)
                yield block
                yield BlockMetadata.of(block)

        pending = collections.deque(tasks)
        live: collections.deque = collections.deque()
        while pending or live:
            while pending and len(live) < self._parallelism:
                live.append(_read_stream.remote(pending.popleft()))
            gen = live.popleft()
            while True:
                try:
                    block_ref = next(gen)
                except StopIteration:
                    break
                meta = ray_tpu_torch.get(next(gen))
                yield block_ref, meta


class TaskPoolMapOperator(Operator):
    """map_batches over stateless tasks, bounded in-flight, pipelined.

    Completion order is preserved (FIFO) so downstream sees deterministic
    block order; the bounded window still overlaps up to `concurrency`
    transforms with upstream reads and downstream consumption. Holds a
    CHAIN of fused stages: the optimizer merges adjacent map operators so
    one task applies the whole chain per block (reference:
    logical/rules/operator_fusion.py).

    Data locality rides for free: the input block ref is a task ARG, so
    the submitter's lease requests carry it as the pick_node locality
    hint and each transform schedules onto the node already holding its
    block (core/task_spec.py DefaultSchedulingStrategy) — shuffle/map
    stages stop shipping bytes the cluster already has, with no Data-API
    change."""

    def __init__(self, fn: Callable, *, batch_size: Optional[int] = None,
                 fn_kwargs: Optional[Dict[str, Any]] = None,
                 concurrency: int = 4, name: str = "map_batches",
                 pass_index: bool = False, preserves_rows: bool = False):
        self.stages: List[MapStage] = [MapStage(
            fn, fn_kwargs or {}, batch_size, pass_index, name)]
        self._concurrency = concurrency
        self.name = name
        self.preserves_rows = preserves_rows

    def can_fuse(self, other: "TaskPoolMapOperator") -> bool:
        return isinstance(other, TaskPoolMapOperator)

    def fused_with(self, other: "TaskPoolMapOperator") -> "TaskPoolMapOperator":
        out = TaskPoolMapOperator(
            lambda b: b, concurrency=min(self._concurrency,
                                         other._concurrency))
        out.stages = self.stages + other.stages
        out.name = "+".join(st.name for st in out.stages)
        out.preserves_rows = self.preserves_rows and other.preserves_rows
        return out

    def execute(self, upstream: Iterator[RefBundle],
                ctx: Optional[ExecContext] = None) -> Iterator[RefBundle]:
        stages = self.stages
        budget = ctx.budget if ctx else None

        @ray_tpu_torch.remote(num_returns=2)
        def _transform(block: Block, index: int):
            out = _apply_stages(block, stages, index)
            return out, BlockMetadata.of(out)

        window: collections.deque = collections.deque()
        holding = 0
        i = 0
        for ref, meta in upstream:
            est = meta.size_bytes or cfg.data_block_size_estimate
            # Byte backpressure: drain completed work until this block is
            # admissible (an operator holding nothing always admits one).
            while window and budget is not None and not budget.can_admit(
                    est, holding):
                block_ref, meta_ref, est0 = window.popleft()
                m = ray_tpu_torch.get(meta_ref)
                budget.release(est0)
                holding -= est0
                yield block_ref, m
            if budget is not None:
                budget.acquire(est)
                holding += est
            window.append((*_transform.remote(ref, i), est))
            i += 1
            if len(window) >= self._concurrency:
                block_ref, meta_ref, est0 = window.popleft()
                m = ray_tpu_torch.get(meta_ref)
                if budget is not None:
                    budget.release(est0)
                    holding -= est0
                yield block_ref, m
        while window:
            block_ref, meta_ref, est0 = window.popleft()
            m = ray_tpu_torch.get(meta_ref)
            if budget is not None:
                budget.release(est0)
                holding -= est0
            yield block_ref, m


class ActorPoolMapOperator(Operator):
    """map_batches over a pool of stateful actors (the reference's GPU
    inference pattern: construct the model once per actor, stream batches
    through it). ``fn`` is a class; each actor calls it once per block.

    ``pool_size`` may be an (min, max) tuple: the pool AUTOSCALES between
    the bounds on queue pressure (reference: ActorPoolStrategy(min_size,
    max_size) + execution/autoscaler's op-level scaling) — upscale when
    the in-flight window saturates for consecutive dispatches, downscale
    an idle actor when pressure stays low."""

    def __init__(self, fn_cls: type, *, batch_size: Optional[int] = None,
                 fn_constructor_kwargs: Optional[Dict[str, Any]] = None,
                 fn_kwargs: Optional[Dict[str, Any]] = None,
                 pool_size: Any = 2, num_cpus: float = 1.0,
                 resources: Optional[Dict[str, float]] = None,
                 name: str = "map_batches(actors)"):
        self._fn_cls = fn_cls
        self._ctor_kwargs = fn_constructor_kwargs or {}
        self._kwargs = fn_kwargs or {}
        self._batch_size = batch_size
        if isinstance(pool_size, (tuple, list)):
            self._pool_min, self._pool_max = int(pool_size[0]), int(
                pool_size[1])
        else:
            self._pool_min = self._pool_max = int(pool_size)
        if not (1 <= self._pool_min <= self._pool_max):
            raise ValueError(f"invalid pool bounds {pool_size!r}")
        self._num_cpus = num_cpus
        self._resources = resources
        self.name = name

    def execute(self, upstream: Iterator[RefBundle],
                ctx: Optional[ExecContext] = None) -> Iterator[RefBundle]:
        fn_cls, ctor, kwargs, bs = (self._fn_cls, self._ctor_kwargs,
                                    self._kwargs, self._batch_size)
        budget = ctx.budget if ctx else None

        class _MapWorker:
            def __init__(self):
                self._fn = fn_cls(**ctor)

            def transform(self, block: Block):
                out = _apply_batch_fn(block, self._fn, kwargs, bs)
                return out, BlockMetadata.of(out)

            def __ray_shutdown__(self):
                # The local runtime's kill hook (a worker process just
                # exits): run the UDF's ``__del__``, as a serve replica
                # does, so an engine it holds stops its thread.
                hook = getattr(self._fn, "__del__", None)
                if hook is not None:
                    hook()

        actor_cls = ray_tpu_torch.remote(_MapWorker)
        opts: Dict[str, Any] = {"num_cpus": self._num_cpus}
        if self._resources:
            opts["resources"] = self._resources
        pool = [actor_cls.options(**opts).remote()
                for _ in range(self._pool_min)]
        try:
            # Round-robin dispatch, FIFO completion (per-actor ordering is
            # guaranteed by the actor runtime, cross-actor by the window).
            # num_returns=2 as above: blocks stay off the driver.
            window: collections.deque = collections.deque()
            retired: list = []
            holding = 0
            i = 0
            saturated_rounds = 0
            idle_rounds = 0

            def reap_retired():
                # A retired actor dies only after its in-flight
                # transforms drained (killing earlier would fail them).
                if not retired:
                    return  # common fixed-pool case: free
                live = {id(a) for _b, _m, _e, a in window}
                for a in list(retired):
                    if id(a) not in live:
                        retired.remove(a)
                        try:
                            ray_tpu_torch.kill(a)
                        except Exception:
                            pass

            def pop_one():
                nonlocal holding
                block_ref, meta_ref, est0, _actor = window.popleft()
                m = ray_tpu_torch.get(meta_ref)
                if budget is not None:
                    budget.release(est0)
                    holding -= est0
                reap_retired()
                return block_ref, m

            for ref, meta in upstream:
                est = meta.size_bytes or cfg.data_block_size_estimate
                while window and budget is not None and not budget.can_admit(
                        est, holding):
                    yield pop_one()
                if budget is not None:
                    budget.acquire(est)
                    holding += est
                actor = pool[i % len(pool)]
                window.append((*actor.transform.options(
                    num_returns=2).remote(ref), est, actor))
                i += 1
                # Op-level autoscaling on queue pressure (reference:
                # execution/autoscaler + ActorPoolStrategy bounds).
                if len(window) >= 2 * len(pool):
                    saturated_rounds += 1
                    idle_rounds = 0
                    if (saturated_rounds >= 3
                            and len(pool) < self._pool_max):
                        pool.append(actor_cls.options(**opts).remote())
                        saturated_rounds = 0
                else:
                    saturated_rounds = 0
                    if len(window) <= len(pool) // 2:
                        idle_rounds += 1
                        if idle_rounds >= 8 and len(pool) > self._pool_min:
                            retired.append(pool.pop())  # kill on drain
                            idle_rounds = 0
                    else:
                        idle_rounds = 0
                if len(window) >= 2 * len(pool):
                    yield pop_one()
            while window:
                yield pop_one()
        finally:
            for a in pool + retired:
                try:
                    ray_tpu_torch.kill(a)
                except Exception:
                    pass


class DriverOperator(Operator):
    """Order-preserving driver-side transform (limit, local filter...)."""

    def __init__(self, gen_fn: Callable[[Iterator[RefBundle]],
                                        Iterator[RefBundle]],
                 name: str = "driver"):
        self._gen = gen_fn
        self.name = name

    def execute(self, upstream: Iterator[RefBundle],
                ctx: Optional[ExecContext] = None) -> Iterator[RefBundle]:
        tctx = ctx.trace_ctx if ctx is not None else None
        if tctx is None:
            return self._gen(upstream)
        from ray_tpu_torch.util import tracing

        def traced() -> Iterator[RefBundle]:
            # Driver-side work (e.g. an exchange) runs while this
            # generator is being advanced: attach the consumer's root
            # context so its spans join the pipeline's timeline.
            with tracing.attach(tctx):
                yield from self._gen(upstream)

        return traced()


class LimitOperator(Operator):
    """Truncate the stream to n rows. A distinct class (not a bare
    DriverOperator) so the optimizer can recognize and push it below
    row-preserving maps (reference: logical/rules/limit_pushdown.py)."""

    preserves_rows = False  # it drops rows — but commutes with 1:1 maps

    def __init__(self, n: int):
        self.n = n
        self.name = f"limit({n})"

    def execute(self, upstream: Iterator[RefBundle],
                ctx: Optional[ExecContext] = None) -> Iterator[RefBundle]:
        remaining = self.n
        for ref, meta in upstream:
            if remaining <= 0:
                return
            if meta.num_rows <= remaining:
                remaining -= meta.num_rows
                yield ref, meta
            else:
                block = BlockAccessor(ray_tpu_torch.get(ref)).slice(
                    0, remaining)
                remaining = 0
                yield ray_tpu_torch.put(block), BlockMetadata.of(block)


# --------------------------------------------------------------------------
# Plan optimizer
# --------------------------------------------------------------------------


def optimize_plan(ops: List[Operator]) -> List[Operator]:
    """Rule passes over the operator chain (reference:
    logical/interfaces/optimizer.py Rule/Optimizer):
      1. limit pushdown — move LimitOperator below row-preserving maps so
         the limit truncates the stream BEFORE transform work launches;
      2. map fusion — merge adjacent stateless TaskPoolMapOperators into
         one operator applying the fused stage chain (one task per block
         instead of one per stage)."""
    ops = list(ops)

    # Rule 1: limit pushdown. Repeatedly swap (row-preserving map, limit)
    # pairs — the limit also STAYS nowhere else: a 1:1 map emits exactly
    # the rows it gets, so limit-then-map == map-then-limit.
    changed = True
    while changed:
        changed = False
        for i in range(len(ops) - 1):
            if (isinstance(ops[i + 1], LimitOperator)
                    and ops[i].preserves_rows):
                ops[i], ops[i + 1] = ops[i + 1], ops[i]
                changed = True

    # Rule 2: fuse adjacent task-pool maps.
    fused: List[Operator] = []
    for op in ops:
        if (fused and isinstance(op, TaskPoolMapOperator)
                and isinstance(fused[-1], TaskPoolMapOperator)
                and fused[-1].can_fuse(op)):
            fused[-1] = fused[-1].fused_with(op)
        else:
            fused.append(op)
    return fused


def execute_plan(input_op: InputOperator,
                 operators: List[Operator],
                 memory_budget_bytes: Optional[int] = None,
                 trace_ctx: Optional[Dict[str, str]] = None,
                 ) -> Iterator[RefBundle]:
    """Run the optimized plan. Two physical executors share this seam:

    - **streaming** (default on a cluster runtime): map stages run on
      long-lived operator actors connected by bounded channel queues
      (``_executor.py``) — per-block steady-state cost is a channel hop
      plus a store get/put instead of a task RPC;
    - **pull** (``data_executor='pull'``, non-cluster runtimes, or
      worker-hosted pipelines): the original task-per-block generator
      chain below.

    Both produce row-identical output for the same plan: the streaming
    executor dispatches and gathers blocks in global index order.
    """
    ctx = ExecContext(memory_budget_bytes)
    ctx.trace_ctx = trace_ctx
    ops = optimize_plan(operators)
    from ray_tpu_torch.data._executor import adapt_plan, streaming_available

    if streaming_available():
        ops = adapt_plan(ops)
    stream = input_op.execute(None, ctx)
    for op in ops:
        stream = op.execute(stream, ctx)

    def _with_finalizers():
        try:
            yield from stream
        finally:
            ctx.run_finalizers()

    return _with_finalizers()


def explain_plan(input_op: InputOperator,
                 operators: List[Operator]) -> str:
    """The optimized plan, one operator per line (reference: the logical
    plan dump users get from Dataset.explain())."""
    lines = [f"input[{len(input_op._tasks)} read tasks, "
             f"parallelism={input_op._parallelism}]"]
    for op in optimize_plan(operators):
        if isinstance(op, TaskPoolMapOperator) and len(op.stages) > 1:
            lines.append(f"fused_map[{op.name}]")
        else:
            lines.append(op.name)
    return " -> ".join(lines)
