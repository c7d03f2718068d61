"""The port's plan optimizer, memory backpressure, connectors and batch
inference against ``ray_tpu``'s on the CPU: the counterparts of
``tests/test_data_optimizer.py``.

Plans (``Dataset.explain()``) are ``ray_tpu``'s strings; every pipeline's
rows are ``ray_tpu``'s (``ray_tpu`` on its in-process runtime, the port on
its cluster). ``build_llm_processor`` serves ``tiny_config`` Llama on
``ray_tpu``'s weights (``llama.init_params``, carried across by
``from_jax_params``) in a pool actor of the port's cluster, a CPU worker:
its ``generated_ids`` are ``ray_tpu``'s processor's; asked for the card
there (the default device), the engine raises instead of serving on the
CPU.
"""

import jax
import numpy as np
import pytest
import torch

import ray_tpu.data as jdata
import ray_tpu_torch.data as tdata
from ray_tpu.models import llama as jllama
from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg
from ray_tpu_torch.data._streaming import (LimitOperator, MemoryBudget,
                                           TaskPoolMapOperator,
                                           optimize_plan)
from ray_tpu_torch.models import llama as tllama
from tests.torch_data_common import (Slowish, assert_same_rows, both,
                                     files_of)


@pytest.fixture(scope="module")
def cluster():
    with both() as rt:
        yield rt


def same(make):
    got, want = make(tdata), make(jdata)
    assert got.explain() == want.explain()
    rows = got.take_all()
    assert_same_rows(rows, want.take_all())
    return got.explain(), rows


# ---------------------------------------------------------------- optimizer


def test_map_chain_fuses_to_one_operator(cluster):
    plan, rows = same(lambda d: d.range(32)
                      .map_batches(lambda b: {"id": b["id"] * 2})
                      .map_batches(lambda b: {"id": b["id"] + 1})
                      .map_batches(lambda b: {"id": b["id"] * 10}))
    assert "fused_map" in plan, plan
    assert plan.count("map_batches") == 3 and plan.count("->") == 1, plan
    assert [r["id"] for r in rows[:4]] == [10, 30, 50, 70]


def test_fusion_preserves_stage_order(cluster):
    _, rows = same(lambda d: d.range(8)
                   .map_batches(lambda b: {"id": b["id"] * 2})
                   .map_batches(lambda b: {"id": b["id"] + 1}))
    assert [r["id"] for r in rows] == [2 * i + 1 for i in range(8)]


def test_limit_pushes_below_row_preserving_map(cluster):
    plan, rows = same(lambda d: d.range(100).map(
        lambda r: {"id": r["id"] * 3}).limit(5))
    assert plan.index("limit(5)") < plan.index("map"), plan
    assert [r["id"] for r in rows] == [0, 3, 6, 9, 12]


def test_limit_does_not_push_below_filter(cluster):
    plan, rows = same(lambda d: d.range(100).filter(
        lambda r: r["id"] % 2 == 1).limit(3))
    assert plan.index("filter") < plan.index("limit(3)"), plan
    assert [r["id"] for r in rows] == [1, 3, 5]


def test_optimize_plan_unit():
    m1 = TaskPoolMapOperator(lambda b: b, name="a", preserves_rows=True)
    m2 = TaskPoolMapOperator(lambda b: b, name="b", preserves_rows=True)
    out = optimize_plan([m1, m2, LimitOperator(7)])
    assert isinstance(out[0], LimitOperator)
    assert len(out) == 2 and len(out[1].stages) == 2
    assert [st.name for st in out[1].stages] == ["a", "b"]


# ------------------------------------------------------------- backpressure


def test_memory_budget_admission_unit():
    b = MemoryBudget(100)
    assert b.can_admit(60, holding=0)      # first block always admits
    b.acquire(60)
    assert not b.can_admit(60, holding=60)  # would exceed the cap
    assert b.can_admit(60, holding=0)       # another op's first block: yes
    b.release(60)
    assert b.can_admit(60, holding=60)
    assert MemoryBudget(0).can_admit(1 << 60, holding=1)  # 0 disables


def test_pipeline_respects_memory_budget(cluster, monkeypatch):
    """~0.8 MB blocks under a 2 MB budget: the peak bytes in flight stay
    near the budget (~13 MB unbudgeted) and every row arrives."""
    budget_limit = 2 * 1024 * 1024
    peak = {"v": 0}
    orig_acquire = MemoryBudget.acquire

    def tracking_acquire(self, n):
        orig_acquire(self, n)
        with self._lock:
            peak["v"] = max(peak["v"], self._used)

    monkeypatch.setattr(MemoryBudget, "acquire", tracking_acquire)
    monkeypatch.setitem(cfg._values, "data_memory_budget_bytes",
                        budget_limit)
    monkeypatch.setitem(cfg._values, "data_block_size_estimate", 256 * 1024)
    ds = tdata.from_numpy(
        {"x": np.zeros((16 * 100_000,), dtype=np.float64)},
        parallelism=16).map_batches(lambda b: {"x": b["x"] * 2})
    total = 0
    for batch in ds.iter_batches(batch_size=None):
        total += len(batch["x"])
    assert total == 16 * 100_000
    assert peak["v"] > 0, "budget accounting never ran"
    assert peak["v"] <= budget_limit + 2 * 900_000, peak["v"]


# --------------------------------------------------------------- connectors


def test_read_text_roundtrip(cluster, tmp_path):
    p = tmp_path / "notes.txt"
    p.write_text("alpha\nbeta\ngamma\n")
    _, rows = same(lambda d: d.read_text(str(p)))
    assert [r["text"] for r in rows] == ["alpha", "beta", "gamma"]


def test_read_numpy_npy_npz(cluster, tmp_path):
    np.save(tmp_path / "a.npy", np.arange(10))
    _, rows = same(lambda d: d.read_numpy(str(tmp_path / "a.npy")))
    assert [r["data"] for r in rows] == list(range(10))
    np.savez(tmp_path / "b.npz", p=np.arange(4), q=np.arange(4) * 2)
    _, rows = same(lambda d: d.read_numpy(str(tmp_path / "b.npz")))
    assert len(rows) == 4 and rows[3]["q"] == 6


def test_read_binary_files(cluster, tmp_path):
    (tmp_path / "x.bin").write_bytes(b"\x01\x02\x03")
    (tmp_path / "y.bin").write_bytes(b"\xff" * 5)
    paths = [str(tmp_path / "x.bin"), str(tmp_path / "y.bin")]
    _, rows = same(lambda d: d.read_binary_files(paths))
    assert rows[0]["bytes"] == b"\x01\x02\x03"
    assert len(rows[1]["bytes"]) == 5
    assert rows[0]["path"].endswith("x.bin")


def test_from_pandas_and_arrow(cluster):
    import pandas as pd
    import pyarrow as pa

    df = pd.DataFrame({"a": [1, 2, 3], "b": ["x", "y", "z"]})
    _, rows = same(lambda d: d.from_pandas(df))
    assert [r["a"] for r in rows] == [1, 2, 3]
    t = pa.table({"c": [10, 20]})
    _, rows = same(lambda d: d.from_arrow(t))
    assert [r["c"] for r in rows] == [10, 20]


def test_write_parquet_roundtrip(cluster, tmp_path):
    files = tdata.range(50, parallelism=4).write_parquet(
        str(tmp_path / "out_pq"))
    assert len(files) == 4
    assert files_of(files) == files_of(jdata.range(
        50, parallelism=4).write_parquet(str(tmp_path / "jout_pq")))
    _, rows = same(lambda d: d.read_parquet(str(tmp_path / "out_pq")))
    assert [r["id"] for r in rows] == list(range(50))


def test_write_csv_json_roundtrip(cluster, tmp_path):
    items = [{"k": i, "v": float(i)} for i in range(20)]
    for sink, reader in (("csv", "read_csv"), ("json", "read_json")):
        files = getattr(tdata.from_items(items, parallelism=2),
                        f"write_{sink}")(str(tmp_path / f"out_{sink}"))
        assert len(files) == 2
        jfiles = getattr(jdata.from_items(items, parallelism=2),
                         f"write_{sink}")(str(tmp_path / f"jout_{sink}"))
        assert files_of(files) == files_of(jfiles)
        _, rows = same(lambda d: getattr(d, reader)(
            str(tmp_path / f"out_{sink}")))
        assert sorted(int(r["k"]) for r in rows) == list(range(20))


def test_actor_pool_autoscales_between_bounds(cluster):
    """concurrency=(1, 3) on the cluster: several pool processes serve
    the stage; the rows stay exact and ordered."""
    rows = tdata.range(120, parallelism=24).map_batches(
        Slowish, concurrency=(1, 3), num_cpus=0).take_all()
    assert [r["id"] for r in rows] == list(range(120))
    assert len({r["pid"] for r in rows}) >= 2


def test_union_and_zip(cluster):
    def a(d):
        return d.from_items([{"x": i} for i in range(5)], parallelism=2)

    def b(d):
        return d.from_items([{"x": i + 100} for i in range(3)],
                            parallelism=1)

    _, rows = same(lambda d: a(d).union(b(d)))
    assert [r["x"] for r in rows] == [0, 1, 2, 3, 4, 100, 101, 102]
    _, rows = same(lambda d: a(d).zip(d.from_items(
        [{"x": i * 10, "y": i} for i in range(5)], parallelism=2)))
    assert [r["x"] for r in rows] == [0, 1, 2, 3, 4]
    assert [r["x_1"] for r in rows] == [0, 10, 20, 30, 40]
    assert [r["y"] for r in rows] == [0, 1, 2, 3, 4]
    with pytest.raises(ValueError, match="equal row counts"):
        a(tdata).zip(b(tdata)).take_all()


def test_iter_torch_batches(cluster):
    def make(d):
        return d.range(100, parallelism=4).map_batches(
            lambda b: {"id": b["id"], "f": b["id"].astype(np.float32) / 2})

    got = list(make(tdata).iter_torch_batches(batch_size=32))
    want = list(make(jdata).iter_torch_batches(batch_size=32))
    assert [len(b["id"]) for b in got] == [32, 32, 32, 4]
    for g, w in zip(got, want):
        assert isinstance(g["id"], torch.Tensor)
        assert g["f"].dtype == torch.float32
        for k in w:
            assert torch.equal(g[k], w[k])


def test_iter_torch_batches_string_passthrough(cluster):
    items = [{"s": f"w{i}", "n": i} for i in range(6)]
    batches = list(tdata.from_items(items, parallelism=2)
                   .iter_torch_batches(batch_size=3))
    assert all(isinstance(b["n"], torch.Tensor) for b in batches)
    assert list(batches[0]["s"]) == ["w0", "w1", "w2"]


# ------------------------------------------------------- batch inference

BASE = dict(max_batch=2, max_len=64, prompt_buckets=[16, 32],
            decode_chunk=4, prefix_block=16, seed=0)


def _processor(build, engine_kwargs):
    return build(
        preprocess=lambda row: {"qid": row["qid"],
                                "prompt_ids": [2 + (row["qid"] % 5),
                                               3 + row["qid"], 4]},
        engine_kwargs=engine_kwargs, max_new_tokens=4,
        postprocess=lambda row: {"qid": row["qid"],
                                 "tokens": list(row["generated_ids"])},
        concurrency=1, batch_size=4)


def _close_ray_tpu_engines():
    """``ray_tpu``'s pool actors never close their engines: stop the
    threads here."""
    from ray_tpu.core.runtime_context import get_runtime

    for state in get_runtime()._actors.values():
        stage = getattr(getattr(state.instance, "_fn", None), "_engine",
                        None)
        if stage is not None:
            stage.close()


def test_llm_batch_inference_processor(cluster):
    """``tiny_config`` on ``ray_tpu``'s weights: the port's processor in a
    pool actor of its cluster (params carried there by the actor's
    arguments) gives ``ray_tpu``'s processor's greedy tokens, row by
    row; asked for the card on a worker that has none, it raises."""
    from ray_tpu.data.llm import build_llm_processor as jbuild
    from ray_tpu_torch.data.llm import build_llm_processor

    jcfg = jllama.tiny_config(max_seq_len=64)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(5))
    tcfg = tllama.tiny_config(max_seq_len=64)
    tparams = tllama.from_jax_params(
        jax.tree.map(np.asarray, jax.device_get(jparams)), tcfg, "cpu")
    items = [{"qid": i} for i in range(8)]
    try:
        want = _processor(jbuild, dict(BASE, cfg=jcfg, params=jparams))(
            jdata.from_items(items, parallelism=2)).take_all()
    finally:
        _close_ray_tpu_engines()
    got = _processor(build_llm_processor, dict(
        BASE, cfg=tcfg, params=tparams, device="cpu"))(
        tdata.from_items(items, parallelism=2)).take_all()
    assert [r["qid"] for r in got] == list(range(8))
    assert_same_rows(got, want)
    assert all(len(r["tokens"]) == 4 for r in got)
    with pytest.raises(Exception, match="no CUDA device"):
        _processor(build_llm_processor, dict(BASE, cfg=tcfg))(
            tdata.from_items(items, parallelism=2)).take_all()
