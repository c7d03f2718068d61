"""The port's Arrow block path against ``ray_tpu``'s on the CPU: the
counterparts of ``tests/test_data_arrow.py``.

String, nested and nullable columns ride pyarrow Arrays through the
port's data plane (its shm store, its channel exchanges); groupby and
sort over a string-keyed parquet dataset give ``ray_tpu``'s rows in
``ray_tpu``'s order (``ray_tpu`` on its in-process runtime, the port on
its cluster).
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import ray_tpu.data as jdata
import ray_tpu_torch
import ray_tpu_torch.data as tdata
from ray_tpu.data.block import col_unique_inverse as jcol_unique_inverse
from ray_tpu_torch.data.block import (col_take, col_unique_inverse,
                                      is_arrow_col)
from tests.torch_data_common import (assert_same_block, assert_same_rows,
                                     both, files_of)


@pytest.fixture(scope="module")
def cluster():
    with both() as rt:
        yield rt


@pytest.fixture()
def string_parquet(tmp_path):
    """Two parquet files with a string key, a nullable string, and a
    nested list column."""
    rng = np.random.default_rng(0)
    paths = []
    for i in range(2):
        n = 50
        table = pa.table({
            "city": pa.array(rng.choice(["osaka", "kyoto", "nara"], n)),
            "note": pa.array([None if j % 7 == 0 else f"n{j}"
                              for j in range(n)]),
            "tags": pa.array([["a", "b"][: 1 + j % 2] for j in range(n)]),
            "pop": rng.integers(1, 100, n).astype(np.int64),
        })
        p = str(tmp_path / f"part{i}.parquet")
        pq.write_table(table, p)
        paths.append(p)
    return paths


def same(make):
    got, want = make(tdata).take_all(), make(jdata).take_all()
    assert_same_rows(got, want)
    return got


def test_reader_auto_selects_arrow_columns(cluster, string_parquet):
    block = next(tdata.read_parquet(string_parquet).iter_batches(
        batch_size=None))
    assert_same_block(block, next(jdata.read_parquet(
        string_parquet).iter_batches(batch_size=None)))
    assert is_arrow_col(block["city"]), type(block["city"])
    assert is_arrow_col(block["note"])   # nullable -> arrow
    assert is_arrow_col(block["tags"])   # nested -> arrow
    assert isinstance(block["pop"], np.ndarray)  # numeric -> numpy
    assert block["pop"].dtype == np.int64
    for col in block.values():
        if isinstance(col, np.ndarray):
            assert col.dtype != object


def test_string_key_groupby_without_object_arrays(cluster, string_parquet):
    rows = same(lambda d: d.read_parquet(string_parquet)
                .groupby("city").sum("pop").materialize())
    got = {r["city"]: r["sum(pop)"] for r in rows}
    t = pa.concat_tables([pq.read_table(p) for p in string_parquet])
    expect = {}
    for city, pop in zip(t["city"].to_pylist(), t["pop"].to_pylist()):
        expect[city] = expect.get(city, 0) + pop
    assert got == expect


@pytest.mark.parametrize("descending", [False, True])
def test_string_key_sort_global_order(cluster, string_parquet, descending):
    rows = same(lambda d: d.read_parquet(string_parquet).sort(
        "city", descending=descending).materialize())
    cities = [r["city"] for r in rows]
    assert len(cities) == 100
    assert cities == sorted(cities, reverse=descending)


def test_null_keys_group_and_sort(cluster, tmp_path):
    table = pa.table({
        "k": pa.array(["b", None, "a", "b", None, "a", "a"]),
        "v": np.arange(7, dtype=np.float64),
    })
    p = str(tmp_path / "nulls.parquet")
    pq.write_table(table, p)
    counts = {r["k"]: r["count()"] for r in same(
        lambda d: d.read_parquet(p).groupby("k").count().materialize())}
    assert counts == {"a": 3, "b": 2, None: 2}
    srt = [r["k"] for r in same(
        lambda d: d.read_parquet(p).sort("k").materialize())]
    assert srt[:5] == ["a", "a", "a", "b", "b"]
    assert srt[5:] == [None, None]  # nulls last


def test_arrow_roundtrip_through_object_store(cluster):
    """Arrow columns survive the port's shm object plane bit-exactly."""
    col = pa.array(["alpha", None, "gamma"] * 100)
    out = ray_tpu_torch.get(ray_tpu_torch.put({"s": col,
                                               "x": np.arange(300)}))
    assert is_arrow_col(out["s"])
    assert out["s"].equals(col)
    np.testing.assert_array_equal(out["x"], np.arange(300))


def test_arrow_shuffle_and_map_groups(cluster, string_parquet):
    rows = same(lambda d: d.read_parquet(string_parquet)
                .random_shuffle(seed=7).materialize())
    assert sorted(r["pop"] for r in rows) == sorted(
        r["pop"] for r in tdata.read_parquet(string_parquet).take_all())

    def biggest(group):
        idx = np.argsort(np.asarray(group["pop"]), kind="stable")[-1:]
        return {"city": col_take(group["city"], idx),
                "pop": np.asarray(group["pop"])[idx]}

    tops = same(lambda d: d.read_parquet(string_parquet)
                .groupby("city").map_groups(biggest).materialize())
    assert len(tops) == 3


def test_write_parquet_preserves_arrow_columns(cluster, string_parquet,
                                               tmp_path):
    out = tdata.read_parquet(string_parquet).write_parquet(
        str(tmp_path / "out"))
    jout = jdata.read_parquet(string_parquet).write_parquet(
        str(tmp_path / "jout"))
    assert files_of(out) == files_of(jout)
    same(lambda d: d.read_parquet(str(tmp_path / "out")))


def test_nullable_numeric_column_stays_numpy_nan(cluster, tmp_path):
    """Nullable ints/floats keep the numpy NaN representation, and sorts
    stay NUMERIC (never lexicographic)."""
    table = pa.table({
        "k": pa.array([10, 2, None, 7, 1], type=pa.int64()),
        "v": np.arange(5, dtype=np.float64),
    })
    p = str(tmp_path / "nn.parquet")
    pq.write_table(table, p)
    block = next(tdata.read_parquet(p).iter_batches(batch_size=None))
    assert isinstance(block["k"], np.ndarray)
    assert block["k"].dtype == np.float64  # NaN-filled
    srt = [r["k"] for r in same(
        lambda d: d.read_parquet(p).sort("k").materialize())]
    assert srt[:4] == [1.0, 2.0, 7.0, 10.0]


def test_sort_boundary_width_no_truncation(cluster, tmp_path):
    t1 = pa.table({"k": pa.array(["ban", "bag", "a"] * 10)})
    t2 = pa.table({"k": pa.array(["banana", "bananas", "zed"] * 10)})
    p1, p2 = str(tmp_path / "w1.parquet"), str(tmp_path / "w2.parquet")
    pq.write_table(t1, p1)
    pq.write_table(t2, p2)
    srt = [r["k"] for r in same(lambda d: d.read_parquet(
        [p1, p2]).sort("k", num_partitions=4).materialize())]
    assert srt == sorted(srt)


def test_json_csv_tfrecords_sinks_accept_arrow(cluster, string_parquet,
                                               tmp_path):
    for sink in ("json", "csv", "tfrecords"):
        files = {}
        for name, d in (("port", tdata), ("ray_tpu", jdata)):
            ds = d.read_parquet(string_parquet, columns=["city", "pop"])
            files[name] = files_of(getattr(ds, f"write_{sink}")(
                str(tmp_path / f"{sink}-{name}")))
        assert files["port"] == files["ray_tpu"], sink
    back = tdata.read_json(str(tmp_path / "json-port"))
    assert sorted(r["city"] for r in back.take_all()) == sorted(
        r["city"] for r in tdata.read_parquet(string_parquet).take_all())


def test_col_unique_inverse_matches_numpy_semantics():
    col = pa.array(["b", "a", "c", "a", "b"])
    uniq, inv = col_unique_inverse(col)
    juniq, jinv = jcol_unique_inverse(col)
    assert uniq.equals(juniq) and list(inv) == list(jinv)
    assert uniq.to_pylist() == ["a", "b", "c"]
    assert col.take(np.flatnonzero(inv == 0)).to_pylist() == ["a", "a"]
    _n_uniq, n_inv = col_unique_inverse(np.array(["b", "a", "c", "a", "b"]))
    assert list(n_inv) == list(inv)
