"""Distributed tracing in the port (``ray_tpu_torch/util/tracing.py``, the
head's trace ring, the task-spec propagation in ``core/cluster_core.py``
and ``cluster/worker_main.py``, and the serving path's spans), as
``ray_tpu``'s tests hold ``ray_tpu``'s.

- ``tests/test_tracing.py``'s seven cases: a driver root span parents a
  worker's task span and the spans opened inside it; nested tasks chain;
  the chrome-trace export; the task path's submit, dispatch, arg-fetch,
  execute and result-seal spans; a fresh scheduling key's lease span; the
  head ring's entry, byte and attribute bounds; tracing off is free.
- ``tests/test_serve_tracing.py``'s four cases over a ``tiny_config``
  Llama: a handle request's connected route -> replica -> queued ->
  prefill -> decode-chunk chain; the same for a speculative stream; the
  HTTP proxy from admission to delivery under one ``serve.request`` root;
  and tracing off leaving the request path span-free with the engine's
  one sync a chunk.

One module cluster with ``tracing_enabled``; the flag and its exported
environment variable are put back after it.
"""

from __future__ import annotations

import json
import os
import time
import urllib.request

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.util import tracing


@pytest.fixture(scope="module")
def traced_cluster():
    from ray_tpu_torch.core.config import GLOBAL_CONFIG

    rt = ray_tpu_torch.init(num_cpus=6, object_store_memory=256 << 20,
                            _system_config={"tracing_enabled": True})
    try:
        yield rt
    finally:
        from ray_tpu_torch import serve

        try:
            serve.shutdown()
        finally:
            ray_tpu_torch.shutdown()
            for p in rt._procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=10)
            GLOBAL_CONFIG.set("tracing_enabled", False)
            os.environ.pop("RTPU_TRACING_ENABLED", None)


# ---------------------------------------------------- tests/test_tracing.py


def test_span_context_propagates_to_workers(traced_cluster):
    @ray_tpu_torch.remote
    def traced_work(x):
        from ray_tpu_torch.util import tracing as t

        with t.span("inner-compute") as s:
            s.set_attribute("x", x)
        t.flush()
        return x * 2

    with tracing.trace("pipeline") as root:
        assert ray_tpu_torch.get(traced_work.remote(21), timeout=60) == 42
    trace_id = root.trace_id
    assert trace_id
    deadline = time.time() + 15
    spans = []
    while time.time() < deadline:
        spans = tracing.get_trace(trace_id)
        if len(spans) >= 3:
            break
        time.sleep(0.3)
    names = {s["name"] for s in spans}
    assert "pipeline" in names, names
    assert any(n.startswith("task:") for n in names), names
    assert "inner-compute" in names, names
    by_id = {s["span_id"]: s for s in spans}
    task_span = next(s for s in spans if s["name"].startswith("task:"))
    assert task_span["parent_id"] == root.span_id
    inner = next(s for s in spans if s["name"] == "inner-compute")
    assert inner["parent_id"] == task_span["span_id"]
    assert inner["attrs"] == {"x": 21}
    assert by_id[inner["parent_id"]]["trace_id"] == trace_id


def test_nested_tasks_chain_spans(traced_cluster):
    @ray_tpu_torch.remote
    def leaf():
        return 1

    @ray_tpu_torch.remote
    def mid():
        return ray_tpu_torch.get(leaf.remote()) + 1

    with tracing.trace("root") as root:
        assert ray_tpu_torch.get(mid.remote(), timeout=60) == 2
    deadline = time.time() + 15
    while time.time() < deadline:
        spans = tracing.get_trace(root.trace_id)
        if len([s for s in spans if s["name"].startswith("task:")]) >= 2:
            break
        time.sleep(0.3)
    task_spans = [s for s in spans if s["name"].startswith("task:")]
    assert len(task_spans) >= 2, spans
    leaf_span = next(s for s in task_spans if "leaf" in s["name"])
    mid_span = next(s for s in task_spans if "mid" in s["name"])
    assert leaf_span["parent_id"] == mid_span["span_id"]


def test_chrome_trace_export(traced_cluster, tmp_path):
    @ray_tpu_torch.remote
    def f():
        return 1

    with tracing.trace("export-me") as root:
        ray_tpu_torch.get(f.remote(), timeout=60)
    deadline = time.time() + 15
    while time.time() < deadline:
        if len(tracing.get_trace(root.trace_id)) >= 2:
            break
        time.sleep(0.3)
    out = str(tmp_path / "trace.json")
    events = tracing.to_chrome_trace(root.trace_id, out)
    assert events and all(e["ph"] == "X" for e in events)
    assert json.load(open(out))["traceEvents"]


def test_runtime_spans_cover_task_path(traced_cluster):
    import numpy as np

    @ray_tpu_torch.remote
    def consume(arr):
        return int(arr.sum())

    ref = ray_tpu_torch.put(np.ones(300_000, np.int64))
    with tracing.trace("task-path") as root:
        assert ray_tpu_torch.get(consume.remote(ref), timeout=60) == 300_000
    tracing.flush()
    want = {"task.submit", "task.dispatch", "task.arg_fetch",
            "task.result_seal"}

    def complete(names):
        return want <= names and any(
            n.startswith("task:") and n.endswith("consume") for n in names)

    deadline = time.time() + 20
    spans = []
    while time.time() < deadline:
        spans = tracing.get_trace(root.trace_id)
        if complete({s["name"] for s in spans}):
            break
        time.sleep(0.3)
    names = {s["name"] for s in spans}
    assert complete(names), names
    by_name = {s["name"]: s for s in spans}
    assert by_name["task.submit"]["parent_id"] == root.span_id
    assert by_name["task.dispatch"]["attrs"]["worker"]
    assert by_name["task.arg_fetch"]["attrs"]["refs"] == 1
    assert by_name["task.result_seal"]["attrs"]["returns"] == 1
    assert by_name["task.submit"]["start"] <= \
        by_name["task.dispatch"]["end"]
    assert by_name["task.arg_fetch"]["end"] <= \
        by_name["task.result_seal"]["start"]


def test_fresh_sched_key_emits_lease_span(traced_cluster):
    @ray_tpu_torch.remote
    def fresh_keyed():
        return 7

    with tracing.trace("leasing") as root:
        assert ray_tpu_torch.get(fresh_keyed.remote(), timeout=60) == 7
    tracing.flush()
    deadline = time.time() + 20
    lease_spans = []
    while time.time() < deadline:
        spans = tracing.get_trace(root.trace_id)
        lease_spans = [s for s in spans if s["name"] == "task.lease"]
        if lease_spans:
            break
        time.sleep(0.3)
    assert lease_spans, "no task.lease span for a fresh scheduling key"
    assert lease_spans[0]["attrs"]["granted"] is True


def test_head_trace_ring_bounds_and_truncation():
    from ray_tpu_torch.cluster.head import TRACE_SPANS_DROPPED, HeadServer
    from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg

    head = HeadServer(port=0)
    try:
        def span(i, attrs=None):
            return {"trace_id": "t1", "span_id": f"s{i}",
                    "parent_id": "", "name": f"n{i}", "start": 1.0,
                    "end": 2.0, "attrs": attrs or {}, "ok": True}

        head.rpc_trace_spans(None, [span(0, {"blob": "x" * 100_000})])
        got = head.rpc_get_trace(None, "t1")
        assert len(got[0]["attrs"]["blob"]) <= \
            cfg.trace_attr_max_bytes + len("...[truncated]")
        assert got[0]["attrs"]["blob"].endswith("...[truncated]")
        old_bytes = cfg.get("trace_ring_max_bytes")
        cfg.set("trace_ring_max_bytes", 20_000)
        base_dropped = TRACE_SPANS_DROPPED.get()
        try:
            head.rpc_trace_spans(
                None, [span(i, {"pad": "y" * 800}) for i in range(1, 200)])
            stats = head.rpc_trace_stats(None)
            assert stats["bytes"] <= 20_000
            assert TRACE_SPANS_DROPPED.get() > base_dropped
            old_n = cfg.get("trace_ring_size")
            cfg.set("trace_ring_size", 5)
            try:
                head.rpc_trace_spans(None, [span(1000)])
                assert head.rpc_trace_stats(None)["spans"] <= 5
            finally:
                cfg.set("trace_ring_size", old_n)
        finally:
            cfg.set("trace_ring_max_bytes", old_bytes)
    finally:
        head.shutdown()


def test_disabled_tracing_is_free():
    from ray_tpu_torch.core.config import GLOBAL_CONFIG

    old = GLOBAL_CONFIG.get("tracing_enabled")
    GLOBAL_CONFIG.set("tracing_enabled", False)
    try:
        with tracing.trace("nothing") as h:
            assert h.trace_id == ""
        assert tracing.current() is None
        assert tracing.emit_span("x", 0.0, 1.0) is None
        assert tracing.start_span("y") is None
    finally:
        GLOBAL_CONFIG.set("tracing_enabled", old)


# ---------------------------------------------- tests/test_serve_tracing.py

ENGINE_KW = {"max_batch": 2, "max_len": 64, "prompt_buckets": [8, 16],
             "decode_chunk": 2}


@pytest.fixture(scope="module")
def tiny():
    from ray_tpu_torch.models import llama

    cfg = llama.tiny_config(max_seq_len=64)
    return cfg, llama.init_params(cfg, torch.Generator().manual_seed(3),
                                  device="cpu")


def _deploy(tiny, name, **extra_engine_kw):
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.llm import build_llm_deployment

    kw = dict(ENGINE_KW, cfg=tiny[0], params=tiny[1], device="cpu",
              **extra_engine_kw)
    return serve.run(build_llm_deployment(name=name, num_replicas=1,
                                          engine_kwargs=kw), name=name)


def _trace_spans(trace_id, want_names, timeout=25):
    deadline = time.time() + timeout
    spans = []
    while time.time() < deadline:
        spans = tracing.get_trace(trace_id)
        if want_names <= {s["name"] for s in spans}:
            return spans
        time.sleep(0.4)
    return spans


def _assert_connected(spans, root_name):
    by_id = {s["span_id"]: s for s in spans}
    for s in spans:
        hops = 0
        cur = s
        while cur["parent_id"]:
            cur = by_id.get(cur["parent_id"])
            assert cur is not None, \
                f"{s['name']} has a dangling parent chain"
            hops += 1
            assert hops < 20
        assert cur["name"] == root_name, (s["name"], cur["name"])


def test_handle_request_full_span_chain(traced_cluster, tiny):
    h = _deploy(tiny, "traced-llm")
    want = {"serve.route", "serve.replica:__call__", "engine.queued",
            "engine.prefill", "engine.decode_chunk"}
    with tracing.trace("req") as root:
        out = h.remote({"prompt_ids": [1, 2, 3, 4],
                        "max_new_tokens": 6}).result(timeout=180)
    assert out["num_generated"] == 6
    spans = _trace_spans(root.trace_id, want)
    names = {s["name"] for s in spans}
    assert want <= names, names
    _assert_connected(spans, "req")
    chunk_toks = sum(s["attrs"]["tokens"] for s in spans
                     if s["name"] == "engine.decode_chunk")
    assert chunk_toks == 5
    route = next(s for s in spans if s["name"] == "serve.route")
    assert route["attrs"]["deployment"] == "traced-llm"
    assert "policy" in route["attrs"]
    prefill = next(s for s in spans if s["name"] == "engine.prefill")
    assert prefill["attrs"]["prefill_tokens"] == 4


def test_streaming_spec_on_span_chain(traced_cluster, tiny):
    h = _deploy(tiny, "traced-llm-spec", spec_draft_len=2, spec_chunk=2)
    prompt = [5, 6, 7, 5, 6, 7, 5, 6, 7, 5, 6]
    want = {"serve.route", "serve.replica:stream", "engine.prefill",
            "engine.decode_chunk"}
    with tracing.trace("sreq") as root:
        toks = list(h.options("stream", stream=True).remote(
            {"prompt_ids": prompt, "max_new_tokens": 8}))
    assert len(toks) == 8
    spans = _trace_spans(root.trace_id, want)
    names = {s["name"] for s in spans}
    assert want <= names, names
    _assert_connected(spans, "sreq")
    spec_chunks = [s for s in spans if s["name"] == "engine.decode_chunk"
                   and s["attrs"].get("spec")]
    if spec_chunks:
        assert all("spec_accepted" in s["attrs"] for s in spec_chunks)


def test_http_proxy_admission_to_delivery(traced_cluster, tiny):
    from ray_tpu_torch import serve

    _deploy(tiny, "traced-http")
    proxy, port = serve.start_http()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/traced-http",
        data=json.dumps({"prompt_ids": [1, 2, 3],
                         "max_new_tokens": 4}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=180) as r:
        out = json.load(r)
    assert out["result"]["num_generated"] == 4
    rt = traced_cluster
    deadline = time.time() + 25
    trace_id = None
    while time.time() < deadline and trace_id is None:
        for s in rt.head.retrying_call("trace_tail", 5000, timeout=10):
            if s["name"] == "serve.request" and \
                    s["attrs"].get("deployment") == "traced-http":
                trace_id = s["trace_id"]
                break
        time.sleep(0.4)
    assert trace_id, "no serve.request span reached the head"
    want = {"serve.request", "serve.admission", "serve.route",
            "serve.replica:__call__", "engine.prefill",
            "engine.decode_chunk", "serve.delivery"}
    spans = _trace_spans(trace_id, want)
    assert want <= {s["name"] for s in spans}, {s["name"] for s in spans}
    _assert_connected(spans, "serve.request")
    ray_tpu_torch.kill(proxy)


def test_tracing_off_request_path_is_span_free(tiny):
    from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg
    from ray_tpu_torch.serve.llm import LLMEngine
    from ray_tpu_torch.util.tracing import _buffer

    old = cfg.get("tracing_enabled")
    cfg.set("tracing_enabled", False)
    engine = LLMEngine(cfg=tiny[0], params=tiny[1], device="cpu",
                       **ENGINE_KW)
    try:
        before = len(_buffer)
        req = engine._make_request([1, 2, 3, 4], 6, None)
        assert req.trace_ctx is None
        engine._queue.put(req)
        out = req.future.result(timeout=180)
        assert out["num_generated"] == 6
        assert len(_buffer) == before
        snap = engine.stats()
        # 1 prefill sync + ceil(5/2) decode-chunk syncs.
        assert snap["decode_host_syncs"] == 3
    finally:
        engine.close()
        cfg.set("tracing_enabled", old)
