"""The data layer's tracing spans in the port (``ray_tpu_torch/data``
on ``util/tracing.py``), in the manner of ``tests/test_tracing.py``: one
``iter_batches`` call opens a ``data.iter_batches`` span under the
caller's span, and every span of its pipeline joins that trace: the
streaming map lanes' ``data.op.<stage>`` (queue_wait and exec in the lane
actors, submit on the driver), the channel exchange's
``data.op.exchange`` (map and reduce roles) and the device ingest's
``data.op.ingest`` (exec on the loader, queue_wait on the consumer).
Tracing off records none. A materialized dataset iterates with tracing
on (``ray_tpu``'s raises TypeError there).

One module cluster with ``tracing_enabled``; the flag and its exported
environment variable are put back after it. Transforms are lambdas, so
the cluster ships them by value."""

import os
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import data as rdata
from ray_tpu_torch.util import tracing


@pytest.fixture(scope="module")
def traced_cluster():
    from ray_tpu_torch.core.config import GLOBAL_CONFIG

    rt = ray_tpu_torch.init(num_cpus=4, object_store_memory=256 << 20,
                            _system_config={"tracing_enabled": True})
    try:
        yield rt
    finally:
        ray_tpu_torch.shutdown()
        GLOBAL_CONFIG.set("tracing_enabled", False)
        os.environ.pop("RTPU_TRACING_ENABLED", None)


def _spans(trace_id, want, timeout=20.0):
    """The trace's spans once every name in ``want`` has arrived (lane
    actors flush theirs at the end of their run)."""
    deadline = time.time() + timeout
    spans = []
    while time.time() < deadline:
        spans = tracing.get_trace(trace_id)
        names = {s["name"] for s in spans}
        if want <= names:
            return spans
        time.sleep(0.2)
    raise AssertionError(f"missing {want - {s['name'] for s in spans}} in "
                         f"{sorted({s['name'] for s in spans})}")


def _root_of(spans):
    (root,) = [s for s in spans if s["name"] == "data.iter_batches"]
    return root


def test_map_stage_spans_join_the_iter_batches_trace(traced_cluster):
    ds = rdata.from_numpy({"x": np.arange(64)}, parallelism=4).map_batches(
        lambda b: {"x": b["x"] * 2}, batch_size=None)
    with tracing.trace("consumer") as root:
        out = np.concatenate([b["x"] for b in ds.iter_batches(
            batch_size=16)])
    assert np.array_equal(out, np.arange(64) * 2)
    spans = _spans(root.trace_id, {"data.iter_batches"})
    it = _root_of(spans)
    assert it["parent_id"] == root.span_id and it["end"] is not None
    ops = [s for s in spans if s["name"].startswith("data.op.")
           and s["name"] != "data.op.exchange"]
    assert ops, sorted({s["name"] for s in spans})
    phases = {s["attrs"].get("phase") for s in ops}
    assert {"exec", "queue_wait", "submit"} <= phases, phases
    execs = [s for s in ops if s["attrs"].get("phase") == "exec"]
    assert sum(s["attrs"]["rows"] for s in execs) == 64
    assert {s["parent_id"] for s in ops} == {it["span_id"]}
    assert all(s["end"] >= s["start"] for s in ops)


def test_exchange_spans_map_and_reduce(traced_cluster):
    ds = rdata.from_numpy({"x": np.arange(200)},
                          parallelism=4).random_shuffle(seed=3)
    with tracing.trace("consumer") as root:
        got = np.sort(np.concatenate([b["x"] for b in ds.iter_batches(
            batch_size=50)]))
    assert np.array_equal(got, np.arange(200))
    spans = _spans(root.trace_id, {"data.iter_batches", "data.op.exchange"})
    it = _root_of(spans)
    xchg = [s for s in spans if s["name"] == "data.op.exchange"]
    roles = {s["attrs"]["role"] for s in xchg}
    assert roles == {"map", "reduce"}, roles
    sent = sum(s["attrs"]["pieces"] for s in xchg
               if s["attrs"]["role"] == "map")
    got_n = sum(s["attrs"]["pieces"] for s in xchg
                if s["attrs"]["role"] == "reduce")
    assert sent == got_n > 0
    assert {s["parent_id"] for s in xchg} == {it["span_id"]}


def test_ingest_spans(traced_cluster):
    import torch

    ds = rdata.from_numpy({"x": np.arange(96, dtype=np.float32)},
                          parallelism=3)
    with tracing.trace("consumer") as root:
        batches = list(ds.iter_batches(batch_size=32, device_put="cpu"))
    assert all(isinstance(b["x"], torch.Tensor) for b in batches)
    spans = _spans(root.trace_id, {"data.iter_batches", "data.op.ingest"})
    it = _root_of(spans)
    ingest = [s for s in spans if s["name"] == "data.op.ingest"]
    (loader,) = [s for s in ingest if s["attrs"]["phase"] == "exec"]
    assert loader["attrs"]["batches"] == 3
    waits = [s for s in ingest if s["attrs"]["phase"] == "queue_wait"]
    assert len(waits) >= 3
    assert {s["parent_id"] for s in ingest} == {it["span_id"]}


def test_materialized_dataset_iterates_traced(traced_cluster):
    mat = rdata.from_numpy({"x": np.arange(10)}, parallelism=2).materialize()
    with tracing.trace("consumer") as root:
        rows = sum(len(b["x"]) for b in mat.iter_batches(batch_size=4))
    assert rows == 10
    _spans(root.trace_id, {"data.iter_batches"})


def test_tracing_off_records_no_data_span(traced_cluster):
    """With this process's tracing off, ``iter_batches`` opens no root
    and this process buffers no span: submit, exchange and ingest spans
    are all gated on the flag (the lane actors keep their own)."""
    from ray_tpu_torch.core.config import GLOBAL_CONFIG

    tracing.flush()
    GLOBAL_CONFIG.set("tracing_enabled", False)
    try:
        assert tracing.start_span("data.iter_batches") is None
        ds = rdata.from_numpy({"x": np.arange(32)}, parallelism=2) \
            .map_batches(lambda b: {"x": b["x"] + 1}, batch_size=None) \
            .random_shuffle(seed=1)
        assert sum(len(b["x"]) for b in ds.iter_batches(
            batch_size=8, device_put="cpu")) == 32
        assert tracing._buffer == []
    finally:
        GLOBAL_CONFIG.set("tracing_enabled", True)
