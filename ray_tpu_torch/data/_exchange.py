"""All-to-all block exchange: the engine under shuffle/sort/groupby/repartition
(``ray_tpu/data/_exchange.py`` without the ``res_debug``
registrations).

Parity target: the reference's exchange planner
(reference: python/ray/data/_internal/planner/exchange/
exchange_task_scheduler.py, sort_task_spec.py, shuffle_task_spec.py,
push_based_shuffle_task_scheduler.py) re-designed small: one generic
two-stage exchange with TWO transports under one seam —

**channel transport** (default on a cluster, ``data_exchange_transport``):
long-lived mapper and reducer actors wired into an M x R mesh of bounded
channel queues (``dag/ring.py`` shm rings same-node, ``dag/peer.py``
peer sockets cross-node). Steady-state partition traffic is channel
scatter frames — a mapper splits each block and streams piece
``(block_index, partition, rows)`` frames straight to the owning
reducer, no per-piece task RPC, no driver involvement. Reducers merge +
finalize, and hand results back as actor-task returns so output blocks
are driver-owned. The push-based-shuffle role, on the ``dag`` channels.

**task transport** (fallback): the original wave-admitted task pipeline —

    map stage:    one task per input block -> N partition blocks
                  (num_returns=N; partitions stay in the shm store, rows
                  ride zero-copy numpy buffers)
    reduce stage: one task per output partition, merging its N pieces

The task path stays the OUT-OF-CORE path: its wave admission sizes work
to live store capacity and spilling walks a 2x-store sort through disk.
The channel path bounds itself to in-memory working sets and falls back
to tasks beyond that (or on any mid-exchange failure — both transports
produce row-identical output for the same seed, so the fallback is
invisible to results).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import (Block, BlockAccessor, BlockMetadata,
                                      col_len, col_slice, col_sort_indices,
                                      col_sorted_sample, col_take, col_tolist,
                                      col_unique_inverse, is_arrow_col)

# --------------------------------------------------------------------------
# Pure stage kernels (shared verbatim by both transports: row identity
# between channel and task exchanges is BY CONSTRUCTION)
# --------------------------------------------------------------------------


def partition_rows(block: Block, assignment_fn_blob, n: int,
                   block_index: int = 0):
    """Split `block` into n partition blocks by row assignment.
    assignment_fn_blob: callable (block, block_index) -> [num_rows] int
    partition ids (the index gives shuffles a distinct deterministic
    stream per block — content-derived seeds collapse for equal blocks)."""
    acc = BlockAccessor(block)
    rows = acc.num_rows()
    if rows == 0:
        empty = {k: col_slice(v, 0, 0) for k, v in block.items()}
        return tuple(empty for _ in range(n)) if n > 1 else empty
    part_ids = assignment_fn_blob(block, block_index)
    out = []
    for j in range(n):
        idx = np.flatnonzero(part_ids == j)
        out.append({k: col_take(v, idx) for k, v in block.items()})
    return tuple(out) if n > 1 else out[0]


def merge_pieces(pieces: Sequence[Block], finalize_fn_blob) -> Block:
    """Concat one partition's pieces (in block-index order) + finalize
    (sort the partition, local shuffle, aggregate, ...)."""
    merged = BlockAccessor.concat(list(pieces))
    if not merged and pieces:
        merged = {k: col_slice(v, 0, 0) for k, v in pieces[0].items()}
    if finalize_fn_blob:
        merged = finalize_fn_blob(merged)
    return merged


# --------------------------------------------------------------------------
# Remote stage functions (module-level: pickled by reference, tiny specs)
# --------------------------------------------------------------------------


@ray_tpu_torch.remote(max_retries=3, retry_exceptions=True)
def _partition_block(block: Block, assignment_fn_blob, n: int,
                     block_index: int = 0):
    return partition_rows(block, assignment_fn_blob, n, block_index)


@ray_tpu_torch.remote(max_retries=3, retry_exceptions=True)
def _merge_blocks(finalize_fn_blob, *pieces: Block):
    """Returns (block, metadata): the block lands in the store, the
    metadata rides the completion push inline so the driver never
    fetches block bytes for bookkeeping."""
    merged = merge_pieces(pieces, finalize_fn_blob)
    return merged, BlockMetadata.of(merged)


@ray_tpu_torch.remote
def _sample_keys(block: Block, key: str, k: int):
    """Sort sample stage: up to k evenly-spaced key values (numpy array
    or, for arrow key columns, a sorted python list)."""
    return col_sorted_sample(block[key], k)


# --------------------------------------------------------------------------
# The generic exchange
# --------------------------------------------------------------------------


def exchange(bundles: List[Tuple[Any, BlockMetadata]],
             assignment_fn: Callable[[Block], np.ndarray],
             num_outputs: int,
             finalize_fn: Optional[Callable[[Block], Block]] = None,
             ) -> List[Tuple[Any, BlockMetadata]]:
    """Runs the two-stage exchange; returns the output bundles in
    partition order. Refs only — no block bytes touch the driver.

    Transport dispatch: the channel mesh when configured, on a cluster,
    and within the in-memory working-set bound; the task pipeline
    otherwise (out-of-core sizes, non-cluster runtimes, worker-hosted
    pipelines) and as the fallback when a channel exchange fails
    mid-flight (both transports share the partition/merge kernels, so a
    fallback rerun is row-identical)."""
    if not bundles:
        return []
    from ray_tpu_torch.core.config import GLOBAL_CONFIG as _cfg

    if _cfg.data_exchange_transport == "channel":
        from ray_tpu_torch.data._executor import streaming_available

        if streaming_available() and _within_memory_bound(bundles):
            try:
                return _channel_exchange(bundles, assignment_fn,
                                         num_outputs, finalize_fn)
            except Exception as e:
                print(f"RTPU_DATA: channel exchange failed ({e!r}); "
                      "falling back to task exchange", flush=True)
    return _task_exchange(bundles, assignment_fn, num_outputs,
                          finalize_fn)


def _within_memory_bound(bundles) -> bool:
    """The channel exchange accumulates partition pieces in reducer
    heaps — in-memory by design. Exchanges bigger than a third of live
    store capacity keep the task path, whose wave admission + store
    spilling is the out-of-core story."""
    from ray_tpu_torch.core.config import GLOBAL_CONFIG as _cfg
    from ray_tpu_torch.core.runtime_context import require_runtime

    total = sum(m.size_bytes for _r, m in bundles if m)
    try:
        _used, store_bytes, _n, _e = require_runtime().store.stats()
    except Exception:  # rtpu-lint: disable=swallowed-exception — config-default fallback when the store has no stats endpoint
        store_bytes = _cfg.object_store_memory_bytes
    return total <= store_bytes // 3


def _task_exchange(bundles: List[Tuple[Any, BlockMetadata]],
                   assignment_fn: Callable[[Block], np.ndarray],
                   num_outputs: int,
                   finalize_fn: Optional[Callable[[Block], Block]] = None,
                   ) -> List[Tuple[Any, BlockMetadata]]:
    """The wave-admitted per-task-RPC pipeline (out-of-core capable)."""
    # Memory admission control for BOTH stages (reference: pull admission
    # in pull_manager.h + the push-based shuffle's staged merges): a task
    # pins its inputs and creates outputs (~2-3x block bytes of store
    # working set), and pinned pages cannot spill — unthrottled submission
    # can pin more than the whole arena at out-of-core sizes, livelocking
    # every restore. Submit in waves sized to the live store capacity.
    from ray_tpu_torch.core.config import GLOBAL_CONFIG as _cfg
    from ray_tpu_torch.core.runtime_context import require_runtime

    total_bytes = sum(m.size_bytes for _r, m in bundles if m) or 1
    in_bytes = max(1, total_bytes // len(bundles))
    part_bytes = max(1, total_bytes // num_outputs)
    try:  # the LIVE store capacity (init's object_store_memory argument)
        _used, store_bytes, _n, _e = require_runtime().store.stats()
    except Exception:  # rtpu-lint: disable=swallowed-exception — config-default fallback when the store has no stats endpoint
        store_bytes = _cfg.object_store_memory_bytes

    map_wave = int(max(1, min(len(bundles),
                              store_bytes // (3 * in_bytes))))
    part_refs: List[Sequence] = []
    for start in range(0, len(bundles), map_wave):
        wave_parts = []
        for idx in range(start, min(start + map_wave, len(bundles))):
            ref, _meta = bundles[idx]
            refs = _partition_block.options(num_returns=num_outputs).remote(
                ref, assignment_fn, num_outputs, idx)
            wave_parts.append(refs if num_outputs > 1 else [refs])
        flat = [r for parts in wave_parts for r in parts]
        ray_tpu_torch.wait(flat, num_returns=len(flat), timeout=600.0)
        part_refs.extend(wave_parts)
    wave = int(max(1, min(num_outputs, store_bytes // (3 * part_bytes))))
    block_refs: list = []
    metas: list = []
    for start in range(0, num_outputs, wave):
        wave_meta_refs = []
        for j in range(start, min(start + wave, num_outputs)):
            pieces = [parts[j] for parts in part_refs]
            b_ref, m_ref = _merge_blocks.options(num_returns=2).remote(
                finalize_fn, *pieces)
            block_refs.append(b_ref)
            wave_meta_refs.append(m_ref)
        metas.extend(ray_tpu_torch.get(wave_meta_refs))
    return list(zip(block_refs, metas))


# --------------------------------------------------------------------------
# The channel transport: an M x R mapper/reducer mesh
# --------------------------------------------------------------------------


class _ExchangeMapper:
    """Map side of the channel exchange: splits assigned blocks with the
    shared ``partition_rows`` kernel and streams each piece to the
    reducer owning its partition as one channel frame
    ``(block_index, partition, piece)``. Empty pieces ship too — the
    reducer needs every (block, partition) cell to reconstruct the task
    transport's exact concat order (and a schema for empty outputs)."""

    def __init__(self):
        self._queues = None

    def whereami(self):
        try:
            return ray_tpu_torch.get_runtime_context().node_id
        except Exception:  # rtpu-lint: disable=swallowed-exception — placement is a hint; None means same-node
            return None

    def attach(self, out_queues, payload) -> bool:
        self._queues = out_queues  # reducer r reads queue r
        self._assign = payload["assignment_fn"]
        self._n = payload["num_outputs"]
        self._trace_ctx = payload.get("trace_ctx")
        return True

    def run(self, assigned) -> int:
        """assigned: [(block_index, ref)] — refs resolved here (nested
        refs stay refs across the actor call; the borrow registration
        keeps them alive in flight)."""
        from ray_tpu_torch.util import tracing

        sent = 0
        t0 = time.time()
        try:
            for block_index, ref in assigned:
                block = ray_tpu_torch.get(ref)
                parts = partition_rows(block, self._assign, self._n,
                                       block_index)
                if self._n == 1:
                    parts = (parts,)
                for j, piece in enumerate(parts):
                    self._queues[j % len(self._queues)].put(
                        (block_index, j, piece), timeout=600.0)
                    sent += 1
        finally:
            for q in self._queues:
                try:
                    q.put_stop()
                except Exception:  # rtpu-lint: disable=swallowed-exception — best-effort EOS on an already-failed stream
                    pass
            if tracing.enabled():
                tracing.emit_span("data.op.exchange", t0, time.time(),
                                  parent=self._trace_ctx,
                                  attrs={"phase": "exec",
                                         "role": "map", "pieces": sent})
                tracing.flush()
        return sent


class _ExchangeReducer:
    """Reduce side: drains all M mapper streams (round-robin polling —
    a reducer pinned to one silent mapper while others' rings fill is
    the classic mesh deadlock), then merges + finalizes each owned
    partition with the shared kernel. Results return via per-partition
    actor-task returns so output blocks are DRIVER-owned — they outlive
    the mesh teardown."""

    def __init__(self):
        self._pieces: Dict[int, Dict[int, Block]] = {}

    def whereami(self):
        try:
            return ray_tpu_torch.get_runtime_context().node_id
        except Exception:  # rtpu-lint: disable=swallowed-exception — placement is a hint; None means same-node
            return None

    def attach(self, in_queues, payload) -> bool:
        self._queues = list(in_queues)
        self._finalize = payload["finalize_fn"]
        self._trace_ctx = payload.get("trace_ctx")
        for q in self._queues:
            q.prepare_read()
        return True

    def run(self) -> int:
        from ray_tpu_torch.data._queues import QueueStopped
        from ray_tpu_torch.util import tracing

        t0 = time.time()
        live = list(self._queues)
        got = 0
        deadline = time.monotonic() + 600.0
        while live:
            progressed = False
            for q in list(live):
                try:
                    block_index, j, piece = q.get(timeout=0.05)
                except TimeoutError:
                    continue
                except QueueStopped:
                    live.remove(q)
                    progressed = True
                    continue
                self._pieces.setdefault(j, {})[block_index] = piece
                got += 1
                progressed = True
            if progressed:
                deadline = time.monotonic() + 600.0
            elif time.monotonic() > deadline:
                raise TimeoutError(
                    f"exchange reducer: no frames for 600s "
                    f"({len(live)} mapper streams still open)")
        if tracing.enabled():
            tracing.emit_span("data.op.exchange", t0, time.time(),
                              parent=self._trace_ctx,
                              attrs={"phase": "exec", "role": "reduce",
                                     "pieces": got})
            tracing.flush()
        return got

    def finish(self, j: int):
        """Merge + finalize partition j. num_returns=2 at the call site:
        the block ref is a task return (driver-owned), the metadata
        rides the completion push."""
        cells = self._pieces.pop(j, {})
        pieces = [cells[i] for i in sorted(cells)]
        merged = merge_pieces(pieces, self._finalize)
        return merged, BlockMetadata.of(merged)


def _channel_exchange(bundles, assignment_fn, num_outputs: int,
                      finalize_fn) -> List[Tuple[Any, BlockMetadata]]:
    from ray_tpu_torch.core.config import GLOBAL_CONFIG as _cfg
    from ray_tpu_torch.core.runtime_context import require_runtime
    from ray_tpu_torch.dag.channel import open_edge
    from ray_tpu_torch.data._queues import ChannelQueue
    from ray_tpu_torch.devtools import res_debug
    from ray_tpu_torch.util import tracing

    rt = require_runtime()
    node_addr = {n["node_id"]: n["address"] for n in rt.nodes()}
    n_map = max(1, min(_cfg.data_exchange_mappers, len(bundles)))
    n_red = max(1, min(_cfg.data_exchange_reducers, num_outputs))
    trace_ctx = tracing.current() if tracing.enabled() else None

    import uuid as _uuid

    mapper_cls = ray_tpu_torch.remote(_ExchangeMapper)
    reducer_cls = ray_tpu_torch.remote(_ExchangeReducer)
    mappers = [mapper_cls.options(num_cpus=0).remote()
               for _ in range(n_map)]
    reducers = [reducer_cls.options(num_cpus=0).remote()
                for _ in range(n_red)]
    actors = mappers + reducers
    res_keys = [res_debug.note_acquire("data_operator", owner=a,
                                       note="exchange")
                for a in actors]
    map_nodes = ray_tpu_torch.get([m.whereami.remote() for m in mappers],
                            timeout=60.0)
    red_nodes = ray_tpu_torch.get([r.whereami.remote() for r in reducers],
                            timeout=60.0)

    # The M x R mesh: queue[m][r], SPSC per edge (one mapper writer, one
    # reducer reader), bounded by the channel's own backpressure.
    cap = _cfg.data_queue_capacity
    mesh = [[ChannelQueue(open_edge(
        _uuid.uuid4().bytes[:12], writer_node=map_nodes[m],
        reader_node=red_nodes[r],
        writer_addr=node_addr.get(map_nodes[m]),
        reader_addr=node_addr.get(red_nodes[r]),
        capacity=cap, edge=f"xchg.m{m}->r{r}"),
        name=f"xchg.m{m}.r{r}") for r in range(n_red)]
        for m in range(n_map)]
    try:
        # Reducers attach first (reader rendezvous before any writer).
        ray_tpu_torch.get([reducers[r].attach.remote(
            [mesh[m][r] for m in range(n_map)],
            {"finalize_fn": finalize_fn, "trace_ctx": trace_ctx})
            for r in range(n_red)], timeout=60.0)
        ray_tpu_torch.get([mappers[m].attach.remote(
            mesh[m], {"assignment_fn": assignment_fn,
                      "num_outputs": num_outputs,
                      "trace_ctx": trace_ctx})
            for m in range(n_map)], timeout=60.0)
        red_runs = [r.run.remote() for r in reducers]
        map_runs = [mappers[m].run.remote(
            [(i, ref) for i, (ref, _meta) in enumerate(bundles)
             if i % n_map == m]) for m in range(n_map)]
        ray_tpu_torch.get(map_runs, timeout=600.0)
        ray_tpu_torch.get(red_runs, timeout=600.0)
        out: List[Tuple[Any, BlockMetadata]] = []
        for start in range(0, num_outputs, 16):
            js = range(start, min(start + 16, num_outputs))
            pairs = [reducers[j % n_red].finish.options(
                num_returns=2).remote(j) for j in js]
            metas = ray_tpu_torch.get([m for _b, m in pairs], timeout=600.0)
            out.extend((b, meta)
                       for (b, _m), meta in zip(pairs, metas))
        return out
    finally:
        for a, key in zip(actors, res_keys):
            try:
                ray_tpu_torch.kill(a)
            except Exception:  # rtpu-lint: disable=swallowed-exception — best-effort teardown
                pass
            res_debug.note_release("data_operator", key)
        for row in mesh:
            for q in row:
                q.shutdown(unlink=True)


# --------------------------------------------------------------------------
# Concrete exchanges
# --------------------------------------------------------------------------


def repartition_exchange(bundles, num_outputs: int, seed=0):
    """Round-robin row redistribution into exactly num_outputs blocks."""

    def assign(block: Block, block_index: int) -> np.ndarray:
        n = BlockAccessor(block).num_rows()
        return np.arange(n) % num_outputs

    return exchange(bundles, assign, num_outputs)


def shuffle_exchange(bundles, num_outputs: int, seed: Optional[int]):
    """Global random shuffle: every row lands in a uniformly random output
    partition, and each partition applies a final local permutation — rows
    cross blocks (the reference's full shuffle, not local_shuffle)."""
    base = seed if seed is not None else np.random.SeedSequence().entropy

    def assign(block: Block, block_index: int) -> np.ndarray:
        # Per-block deterministic stream keyed by the block's POSITION:
        # stable across lineage-recovery retries of the same block,
        # distinct for every block (content-derived seeds collapse when
        # blocks are equal-sized or equal-valued).
        n = BlockAccessor(block).num_rows()
        rng = np.random.default_rng([int(base) & 0xFFFFFFFF, block_index])
        return rng.integers(0, num_outputs, n)

    def finalize(block: Block) -> Block:
        n = BlockAccessor(block).num_rows()
        # Partition content (crc of the key-independent row count alone
        # collapses for equal partitions): mix the first column's bytes.
        import zlib

        mix = 0
        if block:
            first = next(iter(block.values()))
            if is_arrow_col(first):
                mix = zlib.crc32(repr(col_tolist(
                    col_slice(first, 0, 64))).encode())
            else:
                mix = zlib.crc32(np.ascontiguousarray(first[:64]).tobytes())
        rng = np.random.default_rng([int(base) & 0xFFFFFFFF, 7, n, mix])
        perm = rng.permutation(n)
        return {k: col_take(v, perm) for k, v in block.items()}

    return exchange(bundles, assign, num_outputs, finalize)


def sort_exchange(bundles, key: str, descending: bool, num_outputs: int):
    """Sample -> range-partition -> per-partition sort (the reference's
    SortTaskSpec pipeline). Output partition j holds keys in range j, so
    concatenating partitions in order is globally sorted."""
    # Chunked sampling: every sample task pins its whole block; all N at
    # once can pin more than the store at out-of-core sizes.
    samples = []
    for start in range(0, len(bundles), 8):
        samples.extend(ray_tpu_torch.get(
            [_sample_keys.remote(ref, key, 64)
             for ref, _m in bundles[start:start + 8]]))
    nonempty = [s for s in samples if len(s)]
    if not nonempty:
        return bundles  # no rows anywhere: nothing to sort
    # Arrow key columns sample as python lists (kept as a python
    # boundary list — no numpy coercion, which would stringify or
    # width-truncate); numpy keys stay numpy arrays.
    arrow_mode = any(isinstance(s, list) for s in nonempty)
    if arrow_mode:
        merged = sorted(v for s in nonempty
                        for v in (s if isinstance(s, list) else s.tolist()))
        n_keys = len(merged)
    else:
        allkeys = np.sort(np.concatenate(nonempty))
        n_keys = len(allkeys)
    # Positional sample quantiles, not np.quantile: interpolation rejects
    # non-numeric dtypes, but sort keys may be strings/datetimes.
    pos = np.linspace(0, n_keys - 1,
                      num_outputs + 1)[1:-1].astype(np.int64)
    boundaries = ([merged[i] for i in pos] if arrow_mode
                  else allkeys[pos])

    def assign(block: Block, block_index: int) -> np.ndarray:
        col = block[key]
        if is_arrow_col(col):
            # bisect over the python boundary list: correct for any
            # comparable key type (strings, datetimes, decimals) with no
            # dtype coercion; nulls sort last globally -> the final
            # output partition.
            import bisect

            bounds = (list(boundaries) if not isinstance(boundaries, list)
                      else boundaries)
            part = np.empty(col_len(col), np.int64)
            for i, v in enumerate(col_tolist(col)):
                if v is None:
                    part[i] = num_outputs - 1
                elif descending:
                    part[i] = ((num_outputs - 1)
                               - bisect.bisect_right(bounds, v))
                else:
                    part[i] = bisect.bisect_right(bounds, v)
            return part
        part = np.searchsorted(boundaries, col, side="right")
        if descending:
            part = (num_outputs - 1) - part
        return part

    def finalize(block: Block) -> Block:
        if not block:
            return block
        order = col_sort_indices(block[key], descending)
        return {k: col_take(v, order) for k, v in block.items()}

    return exchange(bundles, assign, num_outputs, finalize)


def groupby_exchange(bundles, key: str, num_outputs: int,
                     agg_fn: Callable[[Block, str], Block]):
    """Hash-partition by key so every group lands whole in one partition,
    then aggregate each partition locally (reference: hash shuffle +
    per-partition GroupedData aggregation)."""

    def assign(block: Block, block_index: int) -> np.ndarray:
        # Partition assignment must be identical no matter which worker
        # process hashes a key (map tasks for different blocks run in
        # different processes, and retried tasks may re-run anywhere), so
        # Python hash() is unusable: str hashes are salted per process.
        # crc32 over the value bytes is process-stable and deterministic.
        import zlib

        def scalar_hash(x) -> int:
            # Equal-comparing numerics (1, 1.0, True) must co-partition,
            # and arbitrary objects (default repr embeds the instance id,
            # different per process) cannot be partitioned correctly —
            # reject them rather than silently splitting groups.
            if isinstance(x, bool):
                x = int(x)
            if isinstance(x, (int, float, np.integer, np.floating)):
                f = float(x)
                if f == int(f) and abs(f) < 2**53:
                    return int(f)
                return int(np.float64(0.0 if f == 0.0 else f)
                           .view(np.int64))
            if isinstance(x, bytes):
                return zlib.crc32(x)
            if isinstance(x, str):
                return zlib.crc32(x.encode("utf-8", "surrogatepass"))
            if x is None:
                return -0x5DB1_57E5  # nulls form their own group
            raise TypeError(
                f"groupby key values must be str/bytes/numeric, got "
                f"{type(x).__name__}: partition assignment for arbitrary "
                f"objects is not process-stable")

        col = block[key]
        if is_arrow_col(col):
            h = np.array([scalar_hash(x) for x in col_tolist(col)],
                         np.int64)
        elif col.dtype.kind in "iub":
            h = col.astype(np.int64)
        elif col.dtype.kind == "f":
            # -0.0 == 0.0 must land in one partition: normalize the bit
            # pattern before viewing as int64. Whole floats co-partition
            # with equal ints via the same integer mapping as scalar_hash.
            f = col.astype(np.float64)
            f = np.where(f == 0.0, 0.0, f)
            whole = np.isfinite(f) & (f == np.floor(f)) & (np.abs(f) < 2**53)
            as_int = np.where(whole, f, 0.0).astype(np.int64)
            h = np.where(whole, as_int, f.view(np.int64))
        else:
            h = np.array([scalar_hash(x) for x in col.tolist()], np.int64)
        return (h % num_outputs + num_outputs) % num_outputs

    def finalize(block: Block) -> Block:
        return agg_fn(block, key)

    return exchange(bundles, assign, num_outputs, finalize)


# --------------------------------------------------------------------------
# Local group aggregation kernels (run inside reduce tasks)
# --------------------------------------------------------------------------

def make_group_aggregator(specs: List[Tuple[str, Optional[str], str]]):
    """specs: [(agg_name, value_col_or_None, output_col)]. Returns the
    reduce-side finalize fn: one output row per group key."""

    def aggregate(block: Block, key: str) -> Block:
        if not block or BlockAccessor(block).num_rows() == 0:
            cols: Dict[str, np.ndarray] = {key: np.empty(0)}
            for _a, _v, out_name in specs:
                cols[out_name] = np.empty(0)
            return cols
        keys = block[key]
        uniq, inverse = col_unique_inverse(keys)
        g = len(uniq)
        out: Dict[str, np.ndarray] = {key: uniq}
        for agg, vcol, out_name in specs:
            if agg == "count":
                out[out_name] = np.bincount(inverse, minlength=g)
                continue
            vcol_raw = block[vcol]
            if is_arrow_col(vcol_raw):
                # e.g. map_groups outputs or exotic schemas: null -> NaN.
                vals = vcol_raw.to_numpy(zero_copy_only=False).astype(
                    np.float64)
            else:
                vals = vcol_raw.astype(np.float64)
            if agg == "sum":
                out[out_name] = np.bincount(inverse, weights=vals,
                                            minlength=g)
            elif agg == "mean":
                s = np.bincount(inverse, weights=vals, minlength=g)
                c = np.bincount(inverse, minlength=g)
                out[out_name] = s / np.maximum(c, 1)
            elif agg == "min":
                acc = np.full(g, np.inf)
                np.minimum.at(acc, inverse, vals)
                out[out_name] = acc
            elif agg == "max":
                acc = np.full(g, -np.inf)
                np.maximum.at(acc, inverse, vals)
                out[out_name] = acc
            elif agg == "std":
                s = np.bincount(inverse, weights=vals, minlength=g)
                c = np.maximum(np.bincount(inverse, minlength=g), 1)
                mean = s / c
                sq = np.bincount(inverse, weights=vals * vals, minlength=g)
                var = np.maximum(sq / c - mean * mean, 0.0)
                out[out_name] = np.sqrt(var)
            else:
                raise ValueError(f"unknown aggregation {agg!r}")
        return out

    return aggregate
