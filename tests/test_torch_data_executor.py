"""The port's streaming Dataset executor against ``ray_tpu``'s on the CPU:
the counterparts of ``tests/test_data_executor.py``.

The top half needs no runtime: the physical plan (the same rewrite as
``ray_tpu``'s, described by the same string), the bounded queues, the
exchange kernels (the port's partitions and merges equal to ``ray_tpu``'s
on the same blocks) and the train session's ingest helper. The cluster
half runs on one module cluster of the port: the streaming executor
against the pull executor, channel against task exchanges (the channel
exchange counted, so a silent fallback to tasks fails), a lane killed
mid-stream, each against ``ray_tpu``'s rows on its in-process runtime.
"""

import threading
import time
import uuid

import numpy as np
import pytest

import ray_tpu.data as jdata
import ray_tpu_torch
import ray_tpu_torch.data as tdata
from ray_tpu.data import _exchange as jexchange
from ray_tpu.data._executor import adapt_plan as jadapt
from ray_tpu.data._executor import describe_physical as jdescribe
from ray_tpu.data._streaming import optimize_plan as joptimize
from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg
from ray_tpu_torch.dag.ring import RingChannel
from ray_tpu_torch.data import _exchange as texchange
from ray_tpu_torch.data._executor import (ChannelMapStage, adapt_plan,
                                          describe_physical)
from ray_tpu_torch.data._queues import ChannelQueue, LocalQueue, QueueStopped
from ray_tpu_torch.data._streaming import (ExecContext, InputOperator,
                                           LimitOperator, optimize_plan)
from tests.torch_data_common import (AddBias, assert_same_block,
                                     assert_same_rows, both, slow_triple)


# ------------------------------------------------- physical plan (no runtime)


def _physical(d, make):
    ds = make(d)
    return ds, (adapt_plan if d is tdata else jadapt)(
        (optimize_plan if d is tdata else joptimize)(ds._ops))


def test_adapt_plan_builds_channel_stages():
    def make(d):
        return (d.range(32)
                .map_batches(lambda b: {"id": b["id"] * 2})
                .map_batches(lambda b: {"id": b["id"] + 1})
                .map_batches(lambda b: {"id": b["id"] * 10}))

    _, ops = _physical(tdata, make)
    _, jops = _physical(jdata, make)
    stages = [op for op in ops if isinstance(op, ChannelMapStage)]
    assert len(stages) == 1
    assert len(stages[0].payload["stages"]) == 3
    assert stages[0].lanes >= 1
    desc = describe_physical(ops)
    assert desc.startswith("channel_map[") and "+" in desc, desc
    assert desc == jdescribe(jops)


def test_limit_pushdown_survives_adapt():
    def make(d):
        return d.range(100).map(lambda r: {"id": r["id"] * 3}).limit(5)

    _, ops = _physical(tdata, make)
    _, jops = _physical(jdata, make)
    kinds = [type(op).__name__ for op in ops]
    assert kinds.index("LimitOperator") < kinds.index("ChannelMapStage")
    assert any(isinstance(op, LimitOperator) for op in ops)
    assert kinds == [type(op).__name__ for op in jops]


def test_actor_pool_op_becomes_channel_stage():
    def make(d):
        return d.range(16).map_batches(AddBias, fn_constructor_kwargs={
            "bias": 5}, concurrency=(2, 4))

    _, ops = _physical(tdata, make)
    _, jops = _physical(jdata, make)
    stages = [op for op in ops if isinstance(op, ChannelMapStage)]
    assert len(stages) == 1
    assert stages[0].payload["fn_cls"] is AddBias
    assert 2 <= stages[0].lanes <= 4
    assert describe_physical(ops) == jdescribe(jops)


# ------------------------------------------------------ queues (no runtime)


def test_local_queue_blocks_producer_at_capacity():
    q = LocalQueue(capacity=2, name="t")
    q.put(1)
    q.put(2)
    progressed = threading.Event()

    def produce():
        q.put(3)  # must block until the consumer frees a slot
        progressed.set()

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    assert not progressed.wait(0.3), "producer ran past a full queue"
    assert q.get() == 1
    assert progressed.wait(5.0), "producer never unblocked"
    assert q.get() == 2 and q.get() == 3
    q.shutdown()
    t.join(timeout=5.0)
    assert not t.is_alive()


def test_local_queue_stop_drains_then_raises():
    q = LocalQueue(capacity=4, name="t")
    q.put("a")
    q.put_stop()
    assert q.get() == "a"  # backlog drains before the stop marker
    with pytest.raises(QueueStopped):
        q.get()
    q.shutdown()


def test_local_queue_shutdown_unblocks_producer():
    q = LocalQueue(capacity=1, name="t")
    q.put(1)
    done = threading.Event()

    def produce():
        q.put(2)  # consumer abandons: put must return, not hang
        done.set()

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    time.sleep(0.1)
    q.shutdown()
    assert done.wait(5.0)
    assert q.qsize() == 0


def test_channel_queue_ring_backpressure():
    """The executor's edge contract on a real shm ring of the port:
    capacity bounds frames in flight, a slow consumer blocks the
    producer, stop ends the stream."""
    cid = uuid.uuid4().bytes[:12]
    wq = ChannelQueue(RingChannel(cid, capacity=2), name="w")
    rq = ChannelQueue(RingChannel(cid, capacity=2), name="r")
    try:
        rq.prepare_read()
        wq.put((0, "a"))
        wq.put((1, "b"))
        progressed = threading.Event()

        def produce():
            wq.put((2, "c"), timeout=30.0)  # ring full: must block here
            wq.put_stop()
            progressed.set()

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        assert not progressed.wait(0.3), "producer ran past a full ring"
        assert rq.get(timeout=5.0) == (0, "a")  # frees a slot
        assert rq.get(timeout=5.0) == (1, "b")
        assert rq.get(timeout=5.0) == (2, "c")
        assert progressed.wait(5.0), "producer never unblocked"
        with pytest.raises(QueueStopped):
            rq.get(timeout=5.0)
        t.join(timeout=5.0)
    finally:
        wq.shutdown()
        rq.shutdown(unlink=True)


# --------------------------------------------- exchange kernels (no runtime)


def _blocks(seed, n_blocks=6, rows=40):
    rng = np.random.default_rng(seed)
    return [{"k": rng.integers(0, 17, rows), "v": rng.integers(0, 1000, rows)}
            for _ in range(n_blocks)]


def test_exchange_kernels_transport_order_identity():
    """Both transports share partition_rows/merge_pieces; the channel
    path's only freedom is piece ARRIVAL order. Reducers re-sort pieces
    by block index, so any interleaving merges identically to the task
    path's in-order waves, and every piece equals ``ray_tpu``'s."""
    blocks = _blocks(7)
    n_parts = 5

    def assign(block, block_index):
        return np.asarray(block["k"]) % n_parts

    split = [texchange.partition_rows(b, assign, n_parts, i)
             for i, b in enumerate(blocks)]
    jsplit = [jexchange.partition_rows(b, assign, n_parts, i)
              for i, b in enumerate(blocks)]
    for pieces, jpieces in zip(split, jsplit):
        for p, jp in zip(pieces, jpieces):
            assert_same_block(p, jp)
    task_out = [texchange.merge_pieces(
        [split[i][j] for i in range(len(blocks))], None)
        for j in range(n_parts)]
    for j in range(n_parts):
        cells = {}
        for m in range(3):
            for i in range(m, len(blocks), 3):  # mapper m's stream
                cells[i] = split[i][j]
        chan = texchange.merge_pieces([cells[i] for i in sorted(cells)],
                                      None)
        assert_same_block(chan, task_out[j])
        assert_same_block(chan, jexchange.merge_pieces(
            [jsplit[i][j] for i in range(len(blocks))], None))


def test_partition_rows_empty_block_keeps_schema():
    empty = {"k": np.array([], dtype=np.int64)}
    parts = texchange.partition_rows(empty, lambda b, i: np.array([]), 3)
    assert len(parts) == 3
    assert all(p["k"].shape == (0,) and p["k"].dtype == np.int64
               for p in parts)


def test_train_session_iter_device_batches_delegates():
    """The train-surface ingest helper hands the shard's iter_batches the
    device + prefetch depth (the double-buffered path); plain-sequence
    shards without iter_batches are rejected up front."""
    from ray_tpu_torch.train.config import TrainContextConfig
    from ray_tpu_torch.train.session import TrainSession

    class FakeShard:
        def __init__(self):
            self.calls = []

        def iter_batches(self, **kw):
            self.calls.append(kw)
            return iter([{"x": np.ones(2)}])

    shard = FakeShard()
    sess = TrainSession(lambda cfg: None, {}, TrainContextConfig(),
                        dataset_shards={"train": shard, "plain": [1, 2, 3]})
    out = list(sess.iter_device_batches(
        batch_size=32, device="dev0", prefetch_depth=4))
    assert len(out) == 1
    assert shard.calls == [{"batch_size": 32, "device_put": "dev0",
                            "prefetch_depth": 4}]
    with pytest.raises(TypeError):
        sess.iter_device_batches("plain", device="dev0")
    with pytest.raises(KeyError):
        sess.iter_device_batches("missing", device="dev0")


# ------------------------------------------------------------ cluster tier


@pytest.fixture(scope="module")
def cluster():
    with both() as rt:
        yield rt


@pytest.fixture()
def channel_exchanges(monkeypatch):
    """Counts the port's channel exchanges that returned (one that failed
    and fell back to tasks counts none)."""
    counts = {"channel": 0}
    orig = texchange._channel_exchange

    def counting(*a, **k):
        out = orig(*a, **k)
        counts["channel"] += 1
        return out

    monkeypatch.setattr(texchange, "_channel_exchange", counting)
    return counts


def test_streaming_matches_pull_executor(cluster):
    def make(d):
        return (d.range(200, parallelism=8)
                .map_batches(lambda b: {"v": b["id"] * 3})
                .filter(lambda r: r["v"] % 2 == 0))

    old = cfg.data_executor
    try:
        cfg.set("data_executor", "pull")
        pull_rows = make(tdata).take_all()
        cfg.set("data_executor", "streaming")
        stream_rows = make(tdata).take_all()
    finally:
        cfg.set("data_executor", old)
    assert_same_rows(stream_rows, pull_rows)
    assert_same_rows(stream_rows, make(jdata).take_all())


@pytest.mark.parametrize("how", ["shuffle", "sort"])
def test_channel_vs_task_exchange_identity(cluster, channel_exchanges, how):
    """``ray_tpu``'s ``test_channel_vs_task_shuffle_identity`` and
    ``..._sort_identity``: the port's channel and task exchanges give the
    same rows, and those are ``ray_tpu``'s (task exchange)."""
    if how == "shuffle":
        def make(d):
            return d.range(300, parallelism=6).map_batches(
                lambda b: {"v": b["id"] * 7}).random_shuffle(seed=11)
    else:
        def make(d):
            return d.range(200, parallelism=5).map_batches(
                lambda b: {"k": (b["id"] * 37) % 41, "v": b["id"]}).sort("k")

    old = cfg.data_exchange_transport
    try:
        cfg.set("data_exchange_transport", "channel")
        a = make(tdata).take_all()
        assert channel_exchanges["channel"] == 1
        cfg.set("data_exchange_transport", "task")
        b = make(tdata).take_all()
        assert channel_exchanges["channel"] == 1
    finally:
        cfg.set("data_exchange_transport", old)
    assert_same_rows(a, b)
    assert_same_rows(a, make(jdata).take_all())
    if how == "shuffle":
        assert sorted(r["v"] for r in a) == [i * 7 for i in range(300)]
    else:
        keys = [r["k"] for r in a]
        assert keys == sorted(keys)


def test_lane_death_mid_stream_recovers(cluster):
    """Kill one operator actor while its stage is mid-stream: the driver
    respawns the lane, replays its in-flight frames, and the output is
    row-identical to an undisturbed run (and to ``ray_tpu``'s)."""
    ds = tdata.range(64, parallelism=8).map_batches(slow_triple)
    expected = [r["v"] for r in ds.take_all()]
    assert expected == [r["v"] for r in jdata.range(
        64, parallelism=8).map_batches(slow_triple).take_all()]

    ops = adapt_plan(optimize_plan(ds._ops))
    stage = next(op for op in ops if isinstance(op, ChannelMapStage))
    ctx = ExecContext()
    stream = InputOperator(ds._read_tasks, parallelism=8).execute(None, ctx)
    out = stage.execute(stream, ctx)
    got = []
    try:
        ref, _meta = next(out)
        got.extend(ray_tpu_torch.get(ref)["v"].tolist())
        ray_tpu_torch.kill(stage._live_lanes[0].actor)  # mid-stream death
        for ref, _meta in out:
            got.extend(ray_tpu_torch.get(ref)["v"].tolist())
    finally:
        ctx.run_finalizers()
    assert got == expected
    assert any(lane.respawns for lane in stage._live_lanes)
