"""The port's exchange tier against ``ray_tpu``'s on the CPU: the
counterparts of ``tests/test_data_exchange.py`` (sort, groupby,
repartition, the global shuffle, the out-of-core sort through the store's
spilling).

Each exchange runs on both packages from the same seeded numpy data:
``ray_tpu`` on its in-process runtime (task exchange), the port on its
cluster (channel exchange); the output rows are identical, in order, and
the out-of-core sort runs on a port cluster of its own whose store holds
half the dataset.
"""

import numpy as np
import pytest

import ray_tpu
import ray_tpu.data as jdata
import ray_tpu_torch
import ray_tpu_torch.data as tdata
from tests.torch_data_common import (assert_same_block, assert_same_rows,
                                     both, port_cluster, random_keys)


@pytest.fixture(scope="module")
def cluster():
    with both() as rt:
        yield rt


def same(make):
    got, want = make(tdata).take_all(), make(jdata).take_all()
    assert_same_rows(got, want)
    return got


def test_sort_global_order(cluster):
    def make(d):
        rng = np.random.default_rng(0)
        return d.from_numpy({"x": rng.permutation(5000),
                             "y": np.arange(5000)}, parallelism=7).sort("x")

    rows = same(make)
    xs = [r["x"] for r in rows]
    assert xs == sorted(xs) and len(xs) == 5000
    orig = np.random.default_rng(0).permutation(5000)
    pairs = {int(r["x"]): int(r["y"]) for r in rows}
    for x_val in (0, 1234, 4999):
        assert pairs[x_val] == int(np.flatnonzero(orig == x_val)[0])


def test_sort_descending(cluster):
    rows = same(lambda d: d.from_numpy(
        {"x": np.random.default_rng(3).normal(size=2000)},
        parallelism=5).sort("x", descending=True))
    xs = [r["x"] for r in rows]
    assert xs == sorted(xs, reverse=True)


def test_groupby_matches_numpy_oracle(cluster):
    rng = np.random.default_rng(1)
    k = rng.integers(0, 9, 4000)
    v = rng.normal(size=4000)
    rows = same(lambda d: d.from_numpy({"k": k, "v": v}, parallelism=6)
                .groupby("k").aggregate(
                    ("sum", "v", "s"), ("mean", "v", "m"), ("min", "v", "lo"),
                    ("max", "v", "hi"), ("std", "v", "sd"),
                    ("count", None, "n")))
    out = {r["k"]: r for r in rows}
    assert len(out) == 9
    for g in range(9):
        sel = v[k == g]
        np.testing.assert_allclose(out[g]["s"], sel.sum(), rtol=1e-9)
        np.testing.assert_allclose(out[g]["m"], sel.mean(), rtol=1e-9)
        np.testing.assert_allclose(out[g]["lo"], sel.min(), rtol=1e-9)
        np.testing.assert_allclose(out[g]["hi"], sel.max(), rtol=1e-9)
        np.testing.assert_allclose(out[g]["sd"], sel.std(), rtol=1e-7)
        assert out[g]["n"] == len(sel)


@pytest.mark.parametrize("agg", ["count", "sum", "mean", "min", "max",
                                 "std"])
def test_groupby_named_aggregations(cluster, agg):
    rng = np.random.default_rng(4)
    cols = {"k": rng.integers(0, 5, 300), "v": rng.normal(size=300)}

    def make(d):
        g = d.from_numpy(cols, parallelism=3).groupby("k")
        return g.count() if agg == "count" else getattr(g, agg)("v")

    assert len(same(make)) == 5


def test_groupby_map_groups(cluster):
    def top_row(block):
        i = int(np.argmax(block["v"]))
        return {c: a[i:i + 1] for c, a in block.items()}

    rows = same(lambda d: d.from_numpy(
        {"k": np.array([0, 1, 0, 1, 2]),
         "v": np.array([1.0, 2.0, 3.0, 4.0, 5.0])},
        parallelism=2).groupby("k").map_groups(top_row))
    got = {int(r["k"]): float(r["v"]) for r in rows}
    assert got == {0: 3.0, 1: 4.0, 2: 5.0}


def test_repartition_even(cluster):
    def make(d):
        return d.range(1003, parallelism=5).repartition(3)

    sizes = [m.num_rows for _r, m in make(tdata).iter_block_refs()]
    jsizes = [m.num_rows for _r, m in make(jdata).iter_block_refs()]
    assert sizes == jsizes
    assert len(sizes) == 3 and sum(sizes) == 1003
    assert max(sizes) - min(sizes) <= 2
    same(make)


def test_global_shuffle_crosses_blocks(cluster):
    def blocks(d, get):
        ds = d.range(1000, parallelism=4).random_shuffle(seed=7)
        return [get(r) for r, _m in ds.iter_block_refs()]

    got = blocks(tdata, ray_tpu_torch.get)
    want = blocks(jdata, ray_tpu.get)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_same_block(g, w)
    all_ids = sorted(sum((b["id"].tolist() for b in got), []))
    assert all_ids == list(range(1000))
    # Rows CROSS blocks: the first output block mixes input ranges.
    first = set(got[0]["id"].tolist())
    spans = [sum(1 for x in first if 250 * i <= x < 250 * (i + 1))
             for i in range(4)]
    assert sum(1 for s in spans if s > 0) >= 3, spans


def test_out_of_core_sort_through_spilling(cluster):
    """Sort 2x the object store: the exchange's pieces spill to disk and
    restore (``ray_tpu``'s sizes: a 48 MiB store, 32 blocks of 3 MB, too
    big for the channel exchange's in-memory bound, so the task path
    runs).
    The module cluster goes first; this test boots its own."""
    import functools

    from ray_tpu_torch.data.dataset import Dataset

    ray_tpu_torch.shutdown()
    n_per, n_blocks = 375_000, 32
    with port_cluster(num_cpus=2, object_store_memory=48 << 20):
        ds = Dataset([functools.partial(random_keys, i, n_per)
                      for i in range(n_blocks)], read_parallelism=2).sort("x")
        last, total = None, 0
        for ref, _meta in ds.iter_block_refs():
            xs = ray_tpu_torch.get(ref)["x"]
            assert (np.diff(xs) >= 0).all(), "partition not sorted"
            if last is not None and len(xs):
                assert xs[0] >= last, "partitions out of order"
            if len(xs):
                last = xs[-1]
            total += len(xs)
            del xs
        assert total == n_blocks * n_per
