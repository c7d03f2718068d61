"""Dataset: lazy, streaming, block-distributed data pipelines
(``ray_tpu/data/dataset.py`` without the tracing span of
``iter_batches``; ``device_put`` takes a torch device).

Parity target: reference python/ray/data/dataset.py (Dataset :153,
map_batches :408, streaming_split :1569, iter_batches :4127, materialize
:5089) + read_api.py. Execution is the pull-based streaming pipeline in
`_streaming.py`; nothing runs until a sink (iter_batches/take/...) pulls.

`iter_batches(device_put=...)` keeps `device_prefetch_depth` batches on
the device ahead of the consumer, staged through pinned host memory and
copied on a side stream (`_ingest.py`), so the train step's host->device
copy overlaps compute.

Block refs flow through map/shuffle tasks as plain args, which makes
every stage locality-aware automatically: the scheduler scores candidate
nodes by locally-resident input bytes and places each transform next to
its block (see core/task_spec.py and the "Scheduling & data locality"
README section), so pipelines pull bytes over the (simulated DCN)
network only when a stage genuinely migrates data.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

_range = range  # the module-level `range` READER below shadows the builtin

import ray_tpu_torch
from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg
from ray_tpu_torch.data._streaming import (ActorPoolMapOperator,
                                           DriverOperator, InputOperator,
                                           LimitOperator, Operator,
                                           RefBundle, TaskPoolMapOperator,
                                           execute_plan, explain_plan)
from ray_tpu_torch.data.block import (Block, BlockAccessor, BlockMetadata,
                                      col_take, col_unique_inverse,
                                      rows_view)


class Dataset:
    def __init__(self, read_tasks: List[Callable[[], Block]],
                 ops: Optional[List[Operator]] = None,
                 read_parallelism: int = 4):
        self._read_tasks = read_tasks
        self._ops: List[Operator] = list(ops or [])
        self._read_parallelism = read_parallelism

    # ------------------------------------------------------------ plan ops

    def _with_op(self, op: Operator) -> "Dataset":
        return Dataset(self._read_tasks, self._ops + [op],
                       self._read_parallelism)

    def map_batches(self, fn, *, batch_size: Optional[int] = None,
                    fn_kwargs: Optional[Dict[str, Any]] = None,
                    fn_constructor_kwargs: Optional[Dict[str, Any]] = None,
                    concurrency: Optional[int] = None,
                    num_cpus: float = 1.0,
                    resources: Optional[Dict[str, float]] = None) -> "Dataset":
        """Stateless fn -> task pool; class fn -> actor pool (the
        reference's `compute=ActorPoolStrategy` fork, chosen by fn type)."""
        if isinstance(fn, type):
            # concurrency may be (min, max): the actor pool AUTOSCALES
            # between the bounds on queue pressure (reference:
            # ActorPoolStrategy(min_size, max_size)).
            return self._with_op(ActorPoolMapOperator(
                fn, batch_size=batch_size,
                fn_constructor_kwargs=fn_constructor_kwargs,
                fn_kwargs=fn_kwargs, pool_size=concurrency or 2,
                num_cpus=num_cpus, resources=resources))
        if isinstance(concurrency, (tuple, list)):
            raise ValueError(
                "(min, max) concurrency autoscales ACTOR pools — pass a "
                "class to map_batches, or an int for stateless tasks")
        return self._with_op(TaskPoolMapOperator(
            fn, batch_size=batch_size, fn_kwargs=fn_kwargs,
            concurrency=concurrency or 4))

    def map(self, fn) -> "Dataset":
        def batch_fn(batch: Block) -> Block:
            rows = [fn(r) for r in BlockAccessor(batch).iter_rows()]
            return BlockAccessor.normalize(rows)

        return self._with_op(TaskPoolMapOperator(batch_fn, name="map",
                                                 preserves_rows=True))

    def filter(self, fn) -> "Dataset":
        def batch_fn(batch: Block) -> Block:
            rows = [r for r in BlockAccessor(batch).iter_rows() if fn(r)]
            return BlockAccessor.normalize(rows) if rows else \
                {k: v[:0] for k, v in batch.items()}

        return self._with_op(TaskPoolMapOperator(batch_fn, name="filter"))

    def flat_map(self, fn) -> "Dataset":
        def batch_fn(batch: Block) -> Block:
            rows = []
            for r in BlockAccessor(batch).iter_rows():
                rows.extend(fn(r))
            return BlockAccessor.normalize(rows) if rows else \
                {k: v[:0] for k, v in batch.items()}

        return self._with_op(TaskPoolMapOperator(batch_fn, name="flat_map"))

    def limit(self, n: int) -> "Dataset":
        return self._with_op(LimitOperator(n))

    def union(self, *others: "Dataset") -> "Dataset":
        """Concatenate datasets (this one's blocks, then each other's —
        reference: Dataset.union). Plans concatenate lazily: each input
        keeps its own op chain, materialized per-branch at iteration."""
        branches = [self] + list(others)

        def gen(upstream: Iterator[RefBundle]) -> Iterator[RefBundle]:
            yield from upstream
            for ds in branches[1:]:
                yield from ds._stream()

        return self._with_op(DriverOperator(
            gen, name=f"union({len(branches)})"))

    def zip(self, other: "Dataset") -> "Dataset":
        """Column-wise zip of two datasets row-by-row (reference:
        Dataset.zip); right columns clashing with left names get an
        ``_1`` suffix. Row counts must match."""

        def gen(upstream: Iterator[RefBundle]) -> Iterator[RefBundle]:
            import itertools as _it

            left_rows = _rows_of(upstream)
            right_rows = _rows_of(other._stream())
            sentinel = object()
            batch: List[Dict[str, Any]] = []
            for l, r in _it.zip_longest(left_rows, right_rows,
                                        fillvalue=sentinel):
                if l is sentinel or r is sentinel:
                    raise ValueError(
                        "zip() requires equal row counts")
                row = dict(l)
                for k, v in r.items():
                    row[k if k not in row else f"{k}_1"] = v
                batch.append(row)
                if len(batch) >= 4096:
                    blk = BlockAccessor.normalize(batch)
                    yield ray_tpu_torch.put(blk), BlockMetadata.of(blk)
                    batch = []
            if batch:
                blk = BlockAccessor.normalize(batch)
                yield ray_tpu_torch.put(blk), BlockMetadata.of(blk)

        return self._with_op(DriverOperator(gen, name="zip"))

    def explain(self) -> str:
        """The OPTIMIZED execution plan as a string — fused map chains
        appear as one ``fused_map[...]`` stage, pushed-down limits appear
        below the maps they commuted past (reference: the logical-plan
        dump after rules in _internal/logical/optimizers.py)."""
        return explain_plan(
            InputOperator(self._read_tasks,
                          parallelism=self._read_parallelism),
            self._ops)

    # ------------------------------------------------- all-to-all exchanges

    def _exchange_op(self, name: str, fn) -> "Dataset":
        """Barrier op: materialize upstream bundles, run a two-stage block
        exchange over the object plane, stream the outputs."""

        def gen(upstream: Iterator[RefBundle]) -> Iterator[RefBundle]:
            bundles = list(upstream)
            yield from fn(bundles)

        return self._with_op(DriverOperator(gen, name=name))

    def repartition(self, num_blocks: int) -> "Dataset":
        """Redistribute rows into exactly `num_blocks` even blocks
        (reference: Dataset.repartition, dataset.py)."""
        from ray_tpu_torch.data._exchange import repartition_exchange

        return self._exchange_op(
            f"repartition({num_blocks})",
            lambda b: repartition_exchange(b, num_blocks))

    def sort(self, key: str, *, descending: bool = False,
             num_partitions: Optional[int] = None) -> "Dataset":
        """Global sort by column: sample -> range partition -> local sort
        (reference: Dataset.sort, python/ray/data/dataset.py:2532 +
        exchange/sort_task_spec.py). Streaming the result in order yields
        globally sorted rows; out-of-core via store spilling."""
        from ray_tpu_torch.data._exchange import sort_exchange

        return self._exchange_op(
            f"sort({key})",
            lambda b: sort_exchange(b, key, descending,
                                    num_partitions or max(1, len(b))))

    def groupby(self, key: str) -> "GroupedData":
        """Group rows by column (reference: Dataset.groupby ->
        GroupedData, python/ray/data/grouped_data.py)."""
        return GroupedData(self, key)

    def random_shuffle(self, *, seed: Optional[int] = None,
                       num_blocks: Optional[int] = None) -> "Dataset":
        """GLOBAL random shuffle: an all-to-all exchange assigns every row
        a uniformly random output partition, then each partition applies a
        local permutation — rows cross blocks (reference:
        Dataset.random_shuffle -> shuffle_task_spec.py). For the cheaper
        block-local tier use `local_shuffle`."""
        from ray_tpu_torch.data._exchange import shuffle_exchange

        return self._exchange_op(
            "random_shuffle",
            lambda b: shuffle_exchange(b, num_blocks or max(1, len(b)),
                                       seed))

    def local_shuffle(self, *, seed: Optional[int] = None,
                      block_window: int = 16) -> "Dataset":
        """Block-local row shuffle (per-block seeds) + windowed block-order
        shuffle — the reference's `local_shuffle_buffer` tier: cheaper than
        the global exchange, sufficient for training-epoch decorrelation."""
        rng_seed = seed

        def batch_fn(batch: Block, _block_index: int = 0) -> Block:
            acc = BlockAccessor(batch)
            n = acc.num_rows()
            # Distinct permutation per block — one shared seed would move
            # row i identically in every block (structured, not shuffled).
            rng = (np.random.default_rng([rng_seed, _block_index])
                   if rng_seed is not None else np.random.default_rng())
            perm = rng.permutation(n)
            return {k: col_take(v, perm) for k, v in batch.items()}

        ds = self._with_op(TaskPoolMapOperator(batch_fn, name="shuffle",
                                               pass_index=True))

        def reorder(upstream):
            import random as _random

            rng = _random.Random(rng_seed)
            window = []
            for bundle in upstream:
                window.append(bundle)
                if len(window) >= block_window:
                    rng.shuffle(window)
                    while len(window) > block_window // 2:
                        yield window.pop()
            rng.shuffle(window)
            yield from window

        return ds._with_op(DriverOperator(reorder, name="shuffle-order"))

    # ------------------------------------------------------------ execution

    def _stream(self) -> Iterator[RefBundle]:
        return execute_plan(
            InputOperator(self._read_tasks,
                          parallelism=self._read_parallelism),
            self._ops)

    def iter_block_refs(self) -> Iterator[RefBundle]:
        return self._stream()

    def iter_batches(self, *, batch_size: Optional[int] = 256,
                     drop_last: bool = False,
                     device_put: Optional[Any] = None,
                     prefetch_depth: Optional[int] = None,
                     ) -> Iterator[Block]:
        """Stream batches, re-chunking blocks to exactly ``batch_size`` rows.

        ``device_put``: a torch device (or its name) — numeric columns
        become tensors on it, double-buffered through a background loader
        thread: ``prefetch_depth`` (default: config
        `device_prefetch_depth`) pinned-memory copies are issued on a side
        stream ahead of the consumer, so host block loading overlaps
        device steps (see ``_ingest.py``).
        """

        def host_batches() -> Iterator[Block]:
            buf: List[Block] = []
            buffered = 0
            for ref, _meta in self._stream():
                block = ray_tpu_torch.get(ref)
                n = BlockAccessor(block).num_rows()
                if n == 0:
                    continue
                if batch_size is None:
                    yield block
                    continue
                buf.append(block)
                buffered += n
                while buffered >= batch_size:
                    merged = BlockAccessor.concat(buf)
                    out = BlockAccessor(merged).slice(0, batch_size)
                    rest = BlockAccessor(merged).slice(
                        batch_size, BlockAccessor(merged).num_rows())
                    buf = [rest] if BlockAccessor(rest).num_rows() else []
                    buffered -= batch_size
                    yield out
            if buf and batch_size is not None:
                tail = BlockAccessor.concat(buf)
                if BlockAccessor(tail).num_rows() and not drop_last:
                    yield tail

        if device_put is None:
            yield from host_batches()
        else:
            from ray_tpu_torch.data._ingest import device_batches

            yield from device_batches(
                host_batches(), device_put,
                prefetch_depth or cfg.device_prefetch_depth)

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        yield from _rows_of(self._stream())

    def iter_torch_batches(self, *, batch_size: Optional[int] = 256,
                           drop_last: bool = False,
                           device: Optional[str] = None
                           ) -> Iterator[Dict[str, Any]]:
        """Batches as torch tensors (reference: iter_torch_batches,
        dataset.py:4198) — numeric columns convert zero-copy via
        from_numpy; object columns pass through untouched."""
        import numpy as _np
        import torch

        for batch in self.iter_batches(batch_size=batch_size,
                                       drop_last=drop_last):
            out = {}
            for k, v in batch.items():
                if isinstance(v, _np.ndarray) and v.dtype.kind in "biufc":
                    t = torch.from_numpy(_np.ascontiguousarray(v))
                    out[k] = t.to(device) if device else t
                else:
                    out[k] = v
            yield out

    def take(self, n: int = 20) -> List[Dict[str, Any]]:
        out = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= n:
                break
        return out

    def take_all(self) -> List[Dict[str, Any]]:
        return list(self.iter_rows())

    def count(self) -> int:
        return sum(meta.num_rows for _ref, meta in self._stream())

    def schema(self) -> Optional[Dict[str, Any]]:
        for ref, _meta in self._stream():
            return BlockAccessor(ray_tpu_torch.get(ref)).schema()
        return None

    def materialize(self) -> "MaterializedDataset":
        bundles = list(self._stream())
        return MaterializedDataset(bundles)

    # ------------------------------------------------------------- writers

    def _write(self, path: str, writer: Callable[[Block, str], None],
               suffix: str, concurrency: int = 4) -> List[str]:
        """Distributed write: one task per block emits one part file
        (reference: Dataset.write_* -> per-block write tasks). Returns the
        written file paths."""
        import os

        os.makedirs(path, exist_ok=True)

        @ray_tpu_torch.remote
        def _write_block(ref_block: Block, out_path: str) -> str:
            writer(ref_block, out_path)
            return out_path

        window: List[Any] = []
        out_paths: List[str] = []
        for i, (ref, _meta) in enumerate(self._stream()):
            part = os.path.join(path, f"part-{i:05d}{suffix}")
            window.append(_write_block.remote(ref, part))
            if len(window) >= concurrency:
                out_paths.append(ray_tpu_torch.get(window.pop(0)))
        out_paths.extend(ray_tpu_torch.get(window))
        return out_paths

    def write_parquet(self, path: str) -> List[str]:
        def writer(block: Block, out: str) -> None:
            import pyarrow as pa
            import pyarrow.parquet as pq

            pq.write_table(
                pa.table(dict(block)), out)  # numpy + arrow cols both ok

        return self._write(path, writer, ".parquet")

    def write_csv(self, path: str) -> List[str]:
        def writer(block: Block, out: str) -> None:
            import csv

            rows = rows_view(block)
            cols = list(rows.keys())
            with open(out, "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(cols)
                for row in zip(*(rows[c] for c in cols)):
                    w.writerow(row)

        return self._write(path, writer, ".csv")

    def write_json(self, path: str) -> List[str]:
        def writer(block: Block, out: str) -> None:
            import json

            rows = rows_view(block)
            cols = list(rows.keys())
            with open(out, "w") as f:
                for row in zip(*(rows[c] for c in cols)):
                    f.write(json.dumps({c: (v.item()
                                            if hasattr(v, "item") else v)
                                        for c, v in zip(cols, row)}) + "\n")

        return self._write(path, writer, ".jsonl")

    def write_numpy(self, path: str, column: str) -> List[str]:
        def writer(block: Block, out: str) -> None:
            np.save(out, block[column])

        return self._write(path, writer, ".npy")

    def write_tfrecords(self, path: str) -> List[str]:
        """One .tfrecords file per block; rows serialize as
        tf.train.Example (reference write_tfrecords — here via the native
        codec in data/formats.py, no tensorflow)."""
        def writer(block: Block, out: str) -> None:
            from ray_tpu_torch.data import formats

            formats.write_tfrecord_file(
                out, formats.block_to_examples(block))

        return self._write(path, writer, ".tfrecords")

    def write_webdataset(self, path: str) -> List[str]:
        """One .tar shard per block; columns become per-sample files named
        <key>.<column> (reference write_webdataset)."""
        def writer(block: Block, out: str) -> None:
            from ray_tpu_torch.data import formats

            formats.write_webdataset_shard(out, block)

        return self._write(path, writer, ".tar")

    # ------------------------------------------------------------ splits

    def split(self, n: int) -> List["MaterializedDataset"]:
        """Materialize into n row-balanced shards (reference dataset.split)."""
        bundles = list(self._stream())
        shards: List[List[RefBundle]] = [[] for _ in _range(n)]
        rows = [0] * n
        for ref, meta in sorted(bundles, key=lambda b: -b[1].num_rows):
            i = rows.index(min(rows))
            shards[i].append((ref, meta))
            rows[i] += meta.num_rows
        return [MaterializedDataset(s) for s in shards]

    def streaming_split(self, n: int) -> List["StreamSplitIterator"]:
        """One shared streaming execution, n consumers (reference
        streaming_split :1569 + stream_split_iterator.py): a coordinator
        actor runs the pipeline and hands each arriving block to whichever
        consumer asks next (dynamic load balancing)."""
        import uuid

        coordinator = _SplitCoordinator.options(
            name=f"split-coordinator-{uuid.uuid4().hex[:8]}",
            max_concurrency=n + 1,
        ).remote(self._read_tasks, self._ops, self._read_parallelism, n)
        return [StreamSplitIterator(coordinator, i, n) for i in _range(n)]


class GroupedData:
    """Deferred group-by: terminal aggregation methods return Datasets
    (reference: python/ray/data/grouped_data.py GroupedData.count/sum/...).
    Aggregations run as a hash exchange: every group lands whole in one
    partition, aggregated locally there."""

    def __init__(self, ds: Dataset, key: str):
        self._ds = ds
        self._key = key

    def _agg(self, specs) -> Dataset:
        from ray_tpu_torch.data._exchange import (groupby_exchange,
                                                  make_group_aggregator)

        key = self._key
        agg = make_group_aggregator(specs)
        return self._ds._exchange_op(
            f"groupby({key})",
            lambda b: groupby_exchange(b, key, max(1, len(b)), agg))

    def count(self) -> Dataset:
        return self._agg([("count", None, "count()")])

    def sum(self, col: str) -> Dataset:
        return self._agg([("sum", col, f"sum({col})")])

    def mean(self, col: str) -> Dataset:
        return self._agg([("mean", col, f"mean({col})")])

    def min(self, col: str) -> Dataset:
        return self._agg([("min", col, f"min({col})")])

    def max(self, col: str) -> Dataset:
        return self._agg([("max", col, f"max({col})")])

    def std(self, col: str) -> Dataset:
        return self._agg([("std", col, f"std({col})")])

    def aggregate(self, *specs) -> Dataset:
        """specs: (agg_name, value_col, output_col) triples — several
        aggregations in one exchange pass."""
        return self._agg(list(specs))

    def map_groups(self, fn) -> Dataset:
        """Apply `fn(block) -> block` to each whole group (reference:
        GroupedData.map_groups)."""
        from ray_tpu_torch.data._exchange import groupby_exchange

        key = self._key

        def per_partition(block: Block, k: str) -> Block:
            acc = BlockAccessor(block)
            if acc.num_rows() == 0:
                return block
            keys = block[k]
            uniq, inverse = col_unique_inverse(keys)
            outs = []
            for gi in _range(len(uniq)):
                idx = np.flatnonzero(inverse == gi)
                outs.append(BlockAccessor.normalize(
                    fn({c: col_take(v, idx) for c, v in block.items()})))
            return BlockAccessor.concat(outs)

        return self._ds._exchange_op(
            f"map_groups({key})",
            lambda b: groupby_exchange(b, key, max(1, len(b)),
                                       per_partition))


class MaterializedDataset(Dataset):
    """A fully-executed dataset: blocks pinned in the object store."""

    def __init__(self, bundles: List[RefBundle]):
        self._bundles = bundles
        super().__init__(read_tasks=[], ops=[])

    def _stream(self) -> Iterator[RefBundle]:
        return iter(self._bundles)

    def num_blocks(self) -> int:
        return len(self._bundles)

    def size_bytes(self) -> int:
        return sum(m.size_bytes for _r, m in self._bundles)


@ray_tpu_torch.remote
class _SplitCoordinator:
    """Runs one streaming execution; serves blocks to n consumers.

    Self-terminates (releasing its CPU slot) once every consumer has seen
    exhaustion — a long-lived test/session would otherwise leak one worker
    per streaming_split call."""

    def __init__(self, read_tasks, ops, read_parallelism, n_consumers: int):
        import threading

        ds = Dataset(read_tasks, ops, read_parallelism)
        self._stream = ds._stream()
        self._lock = threading.Lock()
        self._done = False
        self._n = n_consumers
        self._drained: set = set()

    def _self_destruct(self) -> None:
        import threading

        from ray_tpu_torch.core.runtime_context import get_runtime

        rt = get_runtime()
        actor_id = rt.current_actor_id() if rt else None
        if rt is None or actor_id is None:
            return

        def later():
            import time

            time.sleep(0.5)  # let the final next_block replies flush
            try:
                rt.kill_actor(actor_id, no_restart=True)
            except Exception:
                pass

        threading.Thread(target=later, daemon=True).start()

    def next_block(self, consumer: int):
        """Next (block, num_rows) for any consumer, or None at exhaustion."""
        with self._lock:
            if not self._done:
                try:
                    ref, meta = next(self._stream)
                    return ref, meta.num_rows
                except StopIteration:
                    self._done = True
            self._drained.add(consumer)
            if len(self._drained) >= self._n:
                self._self_destruct()
            return None


class StreamSplitIterator:
    """Per-consumer handle from streaming_split (lives on train workers)."""

    def __init__(self, coordinator, index: int, n: int):
        self._coord = coordinator
        self._index = index
        self._n = n

    def iter_batches(self, *, batch_size: Optional[int] = 256,
                     drop_last: bool = False,
                     device_put: Optional[Any] = None,
                     prefetch_depth: Optional[int] = None,
                     ) -> Iterator[Block]:
        def blocks() -> Iterator[Block]:
            while True:
                out = ray_tpu_torch.get(
                    self._coord.next_block.remote(self._index))
                if out is None:
                    return
                ref, _n = out
                yield ray_tpu_torch.get(ref)

        def host_batches() -> Iterator[Block]:
            buf: List[Block] = []
            buffered = 0
            for block in blocks():
                n = BlockAccessor(block).num_rows()
                if n == 0:
                    continue
                if batch_size is None:
                    yield block
                    continue
                buf.append(block)
                buffered += n
                while buffered >= batch_size:
                    merged = BlockAccessor.concat(buf)
                    out = BlockAccessor(merged).slice(0, batch_size)
                    rest = BlockAccessor(merged).slice(
                        batch_size, BlockAccessor(merged).num_rows())
                    buf = [rest] if BlockAccessor(rest).num_rows() else []
                    buffered -= batch_size
                    yield out
            if buf and not drop_last:
                tail = BlockAccessor.concat(buf)
                if BlockAccessor(tail).num_rows():
                    yield tail

        if device_put is None:
            yield from host_batches()
            return
        from ray_tpu_torch.data._ingest import device_batches

        # Same double-buffered feed as Dataset.iter_batches: each train
        # worker's split overlaps its coordinator pulls + H2D transfers
        # with its own device steps.
        yield from device_batches(
            host_batches(), device_put,
            prefetch_depth or cfg.device_prefetch_depth)


# ---------------------------------------------------------------- read API

def range(n: int, *, parallelism: int = 4) -> Dataset:  # noqa: A001
    per = max(1, (n + parallelism - 1) // parallelism)
    tasks = []
    for start in _range(0, n, per):
        end = min(start + per, n)
        tasks.append(functools.partial(
            lambda s, e: {"id": np.arange(s, e)}, start, end))
    return Dataset(tasks, read_parallelism=parallelism)


def from_items(items: Sequence[Any], *, parallelism: int = 4) -> Dataset:
    items = list(items)
    per = max(1, (len(items) + parallelism - 1) // parallelism)
    chunks = [items[i:i + per] for i in _range(0, len(items), per)]
    return Dataset([functools.partial(BlockAccessor.normalize, c)
                    for c in chunks], read_parallelism=parallelism)


def from_generators(gen_fns: Sequence[Callable], *,
                    parallelism: int = 4) -> Dataset:
    """Each ``gen_fn`` is a GENERATOR FUNCTION yielding blocks (row-dicts
    or column dicts); it runs as ONE streaming-generator task whose chunks
    ship incrementally — the natural constructor for sources much larger
    than worker memory (reference analog: generator UDF read tasks over
    `num_returns="streaming"`)."""
    import inspect

    for fn in gen_fns:
        if not inspect.isgeneratorfunction(getattr(fn, "func", fn)):
            raise TypeError(f"from_generators expects generator "
                            f"functions, got {fn!r}")
    return Dataset(list(gen_fns), read_parallelism=parallelism)


def from_numpy(arrays: Dict[str, np.ndarray], *,
               parallelism: int = 4) -> Dataset:
    n = len(next(iter(arrays.values())))
    per = max(1, (n + parallelism - 1) // parallelism)
    tasks = []
    for start in _range(0, n, per):
        end = min(start + per, n)
        tasks.append(functools.partial(
            lambda s, e: {k: v[s:e] for k, v in arrays.items()}, start, end))
    return Dataset(tasks, read_parallelism=parallelism)


def read_parquet(paths, *, columns: Optional[List[str]] = None,
                 parallelism: int = 4) -> Dataset:
    """One read task per file (reference read_api.read_parquet)."""
    files = _expand_paths(paths, (".parquet",))

    def read_one(path: str) -> Block:
        import pyarrow.parquet as pq

        table = pq.read_table(path, columns=columns)
        return _arrow_table_to_block(table)

    return Dataset([functools.partial(read_one, f) for f in files],
                   read_parallelism=parallelism)


def read_csv(paths, *, parallelism: int = 4, **np_kwargs) -> Dataset:
    files = _expand_paths(paths, (".csv",))

    def read_one(path: str) -> Block:
        import csv

        with open(path, newline="") as f:
            rows = list(csv.DictReader(f))
        block = BlockAccessor.normalize(rows)
        # Numeric columns arrive as strings; coerce when cleanly parseable.
        out = {}
        for k, v in block.items():
            try:
                out[k] = v.astype(np.float64)
            except ValueError:
                out[k] = v
        return out

    return Dataset([functools.partial(read_one, f) for f in files],
                   read_parallelism=parallelism)


def read_json(paths, *, parallelism: int = 4) -> Dataset:
    """JSONL files, one task per file."""
    files = _expand_paths(paths, (".json", ".jsonl"))

    def read_one(path: str) -> Block:
        import json

        with open(path) as f:
            rows = [json.loads(line) for line in f if line.strip()]
        return BlockAccessor.normalize(rows)

    return Dataset([functools.partial(read_one, f) for f in files],
                   read_parallelism=parallelism)


def read_text(paths, *, parallelism: int = 4,
              encoding: str = "utf-8") -> Dataset:
    """One row per line, column ``text`` (reference read_api.read_text)."""
    files = _expand_paths(paths, (".txt", ".text"))

    def read_one(path: str) -> Block:
        with open(path, encoding=encoding) as f:
            lines = [ln.rstrip("\n") for ln in f]
        return {"text": np.array(lines, dtype=object)}

    return Dataset([functools.partial(read_one, f) for f in files],
                   read_parallelism=parallelism)


def read_numpy(paths, *, parallelism: int = 4) -> Dataset:
    """.npy -> column ``data``; .npz -> one column per archive member
    (reference read_api.read_numpy)."""
    files = _expand_paths(paths, (".npy", ".npz"))

    def read_one(path: str) -> Block:
        loaded = np.load(path, allow_pickle=False)
        if isinstance(loaded, np.ndarray):
            return {"data": loaded}
        return {k: loaded[k] for k in loaded.files}

    return Dataset([functools.partial(read_one, f) for f in files],
                   read_parallelism=parallelism)


def read_binary_files(paths, *, parallelism: int = 4,
                      include_paths: bool = True) -> Dataset:
    """Whole files as rows: columns ``bytes`` (+ ``path``) — the
    reference's read_binary_files, the escape hatch every custom format
    starts from."""
    files = _expand_paths(paths, ("",))

    def read_one(path: str) -> Block:
        with open(path, "rb") as f:
            data = f.read()
        out: Dict[str, np.ndarray] = {
            "bytes": np.array([data], dtype=object)}
        if include_paths:
            out["path"] = np.array([path], dtype=object)
        return out

    return Dataset([functools.partial(read_one, f) for f in files],
                   read_parallelism=parallelism)


def read_images(paths, *, parallelism: int = 4,
                include_paths: bool = False) -> Dataset:
    """Decoded images as HWC uint8 arrays in column ``image`` (reference
    read_api.read_images). Requires PIL; raises ImportError without it."""
    from PIL import Image  # noqa: F401 — fail fast at plan build time

    files = _expand_paths(paths, (".png", ".jpg", ".jpeg", ".bmp", ".gif"))

    def read_one(path: str) -> Block:
        from PIL import Image as _Image

        arr = np.asarray(_Image.open(path).convert("RGB"))
        out: Dict[str, np.ndarray] = {
            "image": np.empty(1, dtype=object)}
        out["image"][0] = arr
        if include_paths:
            out["path"] = np.array([path], dtype=object)
        return out

    return Dataset([functools.partial(read_one, f) for f in files],
                   read_parallelism=parallelism)


def read_tfrecords(paths, *, parallelism: int = 4) -> Dataset:
    """TFRecord files of tf.train.Example protos -> columnar blocks, one
    task per file (reference read_tfrecords; native codec, no tensorflow:
    data/formats.py)."""
    files = _expand_paths(paths, (".tfrecords", ".tfrecord"))

    def read_one(path: str) -> Block:
        from ray_tpu_torch.data import formats

        return formats.examples_to_block(
            list(formats.read_tfrecord_file(path)))

    return Dataset([functools.partial(read_one, f) for f in files],
                   read_parallelism=parallelism)


def read_webdataset(paths, *, parallelism: int = 4) -> Dataset:
    """WebDataset .tar shards -> one row per sample, columns = file
    extensions + ``__key__``, values = raw bytes (decode in a map stage,
    per webdataset convention). Reference read_webdataset."""
    files = _expand_paths(paths, (".tar",))

    def read_one(path: str) -> Block:
        from ray_tpu_torch.data import formats

        return formats.read_webdataset_shard(path)

    return Dataset([functools.partial(read_one, f) for f in files],
                   read_parallelism=parallelism)


def read_avro(paths, *, parallelism: int = 4) -> Dataset:
    """Avro object-container files, one task per file (reference
    read_avro; native schema-driven decoder, no fastavro)."""
    files = _expand_paths(paths, (".avro",))

    def read_one(path: str) -> Block:
        from ray_tpu_torch.data import formats

        return BlockAccessor.normalize(formats.read_avro_file(path))

    return Dataset([functools.partial(read_one, f) for f in files],
                   read_parallelism=parallelism)


def from_torch(torch_dataset, *, parallelism: int = 4) -> Dataset:
    """Materialize a torch dataset (reference from_torch). Rows may be
    dicts (kept) or tuples (columns item_0..item_{n-1}).

    Map-style datasets are walked by index over ``len()`` — bare
    ``for row in ds`` falls back to Python's legacy __getitem__ protocol,
    which never terminates on datasets that compute rather than index
    (they raise no IndexError). Iterable-style datasets iterate."""
    if hasattr(torch_dataset, "__len__") and hasattr(torch_dataset,
                                                     "__getitem__"):
        rows = (torch_dataset[i] for i in _range(len(torch_dataset)))
    else:
        rows = iter(torch_dataset)
    items = []
    for row in rows:
        if isinstance(row, dict):
            items.append(row)
        elif isinstance(row, (tuple, list)):
            items.append({f"item_{i}": v for i, v in enumerate(row)})
        else:
            items.append({"item": row})
    return from_items(items, parallelism=parallelism)


def from_huggingface(hf_dataset, *, parallelism: int = 4) -> Dataset:
    """A huggingface datasets.Dataset (or anything with to_pandas/iter)
    -> Dataset (reference from_huggingface).

    A DatasetDict (load_dataset's default return) is rejected explicitly:
    iterating it yields split NAMES, which would silently become the
    data. Select a split first (the reference raises the same way)."""
    to_pandas = getattr(hf_dataset, "to_pandas", None)
    if to_pandas is not None:
        return from_pandas(to_pandas(), parallelism=parallelism)
    if isinstance(hf_dataset, dict) or (
            hasattr(hf_dataset, "keys") and hasattr(hf_dataset, "values")):
        raise TypeError(
            "from_huggingface got a DatasetDict-like object; pick a split "
            "first, e.g. from_huggingface(ds['train'])")
    return from_items(list(hf_dataset), parallelism=parallelism)


def from_pandas(df, *, parallelism: int = 4) -> Dataset:
    """One Dataset from a pandas DataFrame (reference from_pandas)."""
    return from_numpy({c: df[c].to_numpy() for c in df.columns},
                      parallelism=parallelism)


def _arrow_table_to_block(table) -> Block:
    """Auto-select the per-column representation (reference:
    block.py:57's Arrow-vs-numeric BlockAccessor split): numeric/bool
    null-free columns become numpy (zero-copy, device-ready);
    string/binary/nested/nullable columns stay pyarrow Arrays — never
    numpy object arrays."""
    import pyarrow.types as pt

    out: Block = {}
    for name, col in zip(table.column_names, table.columns):
        t = col.type
        numericish = (pt.is_integer(t) or pt.is_floating(t)
                      or pt.is_boolean(t) or pt.is_temporal(t))
        if numericish and col.null_count == 0:
            out[name] = np.asarray(col)
        elif (pt.is_integer(t) or pt.is_floating(t)) and col.null_count:
            # Nullable numerics stay NUMPY (NaN-filled float64): every
            # numeric consumer — aggregations, device_put — keeps
            # working; only string/binary/nested/temporal-null columns
            # take the arrow representation.
            out[name] = col.to_numpy(zero_copy_only=False).astype(
                np.float64)
        else:
            out[name] = col.combine_chunks()
    return out


def from_arrow(table, *, parallelism: int = 4) -> Dataset:
    """One Dataset from a pyarrow Table (reference from_arrow). Column
    representation follows the reader auto-selection: numeric -> numpy,
    string/nested/nullable -> pyarrow."""
    block = _arrow_table_to_block(table)
    n = BlockAccessor(block).num_rows()
    per = max(1, (n + parallelism - 1) // parallelism)
    tasks = []
    for start in _range(0, n, per):
        end = min(start + per, n)
        tasks.append(functools.partial(
            lambda s, e: BlockAccessor(block).slice(s, e), start, end))
    return Dataset(tasks, read_parallelism=parallelism)



def _rows_of(stream) -> Iterator[Dict[str, Any]]:
    for ref, _meta in stream:
        yield from BlockAccessor(ray_tpu_torch.get(ref)).iter_rows()


def _expand_paths(paths, suffixes) -> List[str]:
    import glob as _glob
    import os

    if isinstance(paths, str):
        paths = [paths]
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for suf in suffixes:
                files.extend(sorted(_glob.glob(os.path.join(p, f"*{suf}"))))
        elif any(ch in p for ch in "*?["):
            files.extend(sorted(_glob.glob(p)))
        else:
            files.append(p)
    if not files:
        raise FileNotFoundError(f"no input files under {paths}")
    return files
