"""``ray_tpu_torch.data`` against ``ray_tpu.data`` on the CPU: the
counterparts of ``tests/test_data.py``.

Each pipeline runs on both packages from the same numpy data: ``ray_tpu``
on its in-process runtime (pull executor, task exchanges), the port on
its cluster runtime (the streaming executor's operator actors over
channel queues, channel exchanges). The rows must be identical, in the
same order wherever ``ray_tpu``'s order is fixed. Then the trainer's data
seam: a port ``Dataset`` handed to ``DataParallelTrainer`` reaches each of
two CPU workers as a ``StreamSplitIterator`` through ``streaming_split``
and feeds ``train.iter_device_batches``.

One module cluster; every runtime is shut down in a ``finally``.
"""

import os

import jax
import numpy as np
import pytest
import torch

import ray_tpu.data as jdata
import ray_tpu_torch.data as tdata
from tests.torch_data_common import (AddBias, assert_same_rows, both,
                                     feeds_trainer_loop)


@pytest.fixture(scope="module")
def cluster():
    with both() as rt:
        yield rt


def on_both(make):
    """``make(data_module)`` built on each package; returns (port's,
    ray_tpu's)."""
    return make(tdata), make(jdata)


def same(make, sink=lambda ds: ds.take_all()):
    got, want = on_both(make)
    assert_same_rows(sink(got), sink(want))
    return sink(got)


def test_range_count_take(cluster):
    got, want = on_both(lambda d: d.range(100, parallelism=4))
    assert got.count() == want.count() == 100
    assert_same_rows(got.take(5), want.take(5))
    assert [r["id"] for r in got.take(5)] == [0, 1, 2, 3, 4]


def test_map_batches_tasks(cluster):
    rows = same(lambda d: d.range(64).map_batches(
        lambda b: {"id": b["id"], "sq": b["id"] ** 2}))
    assert len(rows) == 64 and all(r["sq"] == r["id"] ** 2 for r in rows)


def test_map_batches_actor_pool(cluster):
    rows = same(lambda d: d.range(40).map_batches(
        AddBias, fn_constructor_kwargs={"bias": 1000}, concurrency=2))
    assert [r["id"] for r in rows] == list(range(1000, 1040))


def test_map_filter_flat_map_limit(cluster):
    rows = same(lambda d: d.from_items([{"x": i} for i in range(30)])
                .map(lambda r: {"x": r["x"] * 2})
                .filter(lambda r: r["x"] % 4 == 0)
                .flat_map(lambda r: [{"x": r["x"]}, {"x": -r["x"]}])
                .limit(6))
    xs = [r["x"] for r in rows]
    assert len(xs) == 6 and xs[0] == 0 and xs[2] == 4 and xs[3] == -4


@pytest.mark.parametrize("drop_last", [False, True])
def test_iter_batches_rechunk_and_tail(cluster, drop_last):
    got, want = on_both(lambda d: d.range(50, parallelism=3))
    g = list(got.iter_batches(batch_size=16, drop_last=drop_last))
    w = list(want.iter_batches(batch_size=16, drop_last=drop_last))
    assert [len(b["id"]) for b in g] == (
        [16, 16, 16] if drop_last else [16, 16, 16, 2])
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a["id"].dtype == b["id"].dtype
        np.testing.assert_array_equal(a["id"], b["id"])


def test_iter_batches_device_put(cluster):
    """``device_put="cpu"``: the loader thread's batches are CPU tensors
    holding ``ray_tpu``'s ``jax.device_put`` batches' values."""
    got, want = on_both(lambda d: d.range(32).map_batches(
        lambda b: {"id": b["id"], "f": b["id"].astype(np.float32) / 3}))
    g = list(got.iter_batches(batch_size=8, device_put="cpu"))
    w = list(want.iter_batches(batch_size=8,
                               device_put=jax.devices("cpu")[0]))
    assert len(g) == len(w) == 4
    for a, b in zip(g, w):
        assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
                   for v in a.values())
        assert all(isinstance(v, jax.Array) for v in b.values())
        for k in b:
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))


def test_split_balanced(cluster):
    got, want = on_both(lambda d: d.range(100, parallelism=5).split(3))
    counts = [s.count() for s in got]
    assert counts == [s.count() for s in want]
    assert sum(counts) == 100 and max(counts) - min(counts) <= 34
    for g, w in zip(got, want):
        assert_same_rows(g.take_all(), w.take_all())


def test_streaming_split_consumes_all_once(cluster):
    ds = tdata.range(60, parallelism=6).map_batches(
        lambda b: {"id": b["id"]})
    its = ds.streaming_split(2)
    assert all(isinstance(it, tdata.StreamSplitIterator) for it in its)
    got = []
    for it in its:
        for b in it.iter_batches(batch_size=None):
            got.extend(b["id"].tolist())
    assert sorted(got) == list(range(60))


def test_read_csv_json(cluster, tmp_path):
    csv_path = os.path.join(tmp_path, "t.csv")
    with open(csv_path, "w") as f:
        f.write("a,b\n1,2\n3,4\n")
    rows = same(lambda d: d.read_csv(csv_path))
    assert rows[0]["a"] == 1.0 and rows[1]["b"] == 4.0
    jl = os.path.join(tmp_path, "t.jsonl")
    with open(jl, "w") as f:
        f.write('{"x": 1}\n{"x": 2}\n')
    assert [r["x"] for r in same(lambda d: d.read_json(jl))] == [1, 2]


def test_read_parquet_roundtrip(cluster, tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq

    path = os.path.join(tmp_path, "t.parquet")
    pq.write_table(pa.table({"v": list(range(10))}), path)
    rows = same(lambda d: d.read_parquet(path))
    assert [r["v"] for r in rows] == list(range(10))


def test_random_shuffle_preserves_multiset(cluster):
    """The seeded global shuffle gives ``ray_tpu``'s order exactly."""
    rows = same(lambda d: d.range(40, parallelism=2).random_shuffle(seed=0))
    assert sorted(r["id"] for r in rows) == list(range(40))
    assert [r["id"] for r in rows] != list(range(40))


def test_materialize_reiterable(cluster):
    got, want = on_both(lambda d: d.range(20).map_batches(
        lambda b: {"id": b["id"] + 1}).materialize())
    assert got.count() == got.count() == 20
    assert got.num_blocks() == want.num_blocks() >= 1
    assert got.size_bytes() == want.size_bytes()
    assert_same_rows(got.take_all(), want.take_all())


def test_dataset_feeds_trainer(cluster, tmp_path):
    """A port ``Dataset`` through ``DataParallelTrainer(datasets=...)``:
    each of two CPU workers gets a ``StreamSplitIterator`` of the port
    (``streaming_split(2)``) and reads it through
    ``train.iter_device_batches``; the shares are disjoint and cover the
    dataset once. The workers load no JAX and no ``ray_tpu``."""
    import json

    from ray_tpu_torch.train import (DataParallelTrainer, RunConfig,
                                     ScalingConfig)

    ds = tdata.range(64).map_batches(lambda b: {"id": b["id"]})
    out = tmp_path / "out"
    out.mkdir()
    res = DataParallelTrainer(
        feeds_trainer_loop, train_loop_config={"out": str(out)},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="data-train", storage_path=str(tmp_path)),
        datasets={"train": ds}).fit()
    assert res.error is None, res.error
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(2)]
    assert sum(m["total"] for m in ranks) == sum(range(64))
    assert sum(m["rows"] for m in ranks) == 64
    for m in ranks:
        assert m["shard"] == "ray_tpu_torch.data.dataset.StreamSplitIterator"
        assert m["tensors"] and m["foreign"] == []


def test_ragged_rows_make_an_object_column(cluster):
    """Rows whose sequences differ in length (prompts of different
    lengths) make an object column, one sequence a row; ``ray_tpu``'s
    ``normalize`` raises on them."""
    items = [{"qid": i, "prompt_ids": list(range(i + 1))} for i in range(6)]
    rows = tdata.from_items(items, parallelism=2).take_all()
    assert [r["prompt_ids"] for r in rows] == [it["prompt_ids"]
                                               for it in items]
    block = next(tdata.from_items(items, parallelism=1).iter_batches(
        batch_size=None))
    assert block["prompt_ids"].dtype == object
    assert block["qid"].dtype == np.int64
    with pytest.raises(Exception, match="inhomogeneous"):
        jdata.from_items(items, parallelism=2).take_all()
    even = [{"p": [i, i]} for i in range(4)]
    assert_same_rows(tdata.from_items(even).take_all(),
                     jdata.from_items(even).take_all())
