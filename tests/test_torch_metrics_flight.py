"""The port's metrics registry, metrics exporter, flight recorder and trace
dump (``ray_tpu_torch/util/metrics.py``, ``metrics_agent.py``,
``flight_recorder.py``, ``scripts/trace_dump.py`` and the engine's
registry half in ``serve/engine/metrics.py``) against ``ray_tpu``'s.

- ``prometheus_text()`` after the same counter, gauge and histogram
  operations (label escaping included) is byte-equal to ``ray_tpu``'s, on
  a fresh registry in each package; ``gauge_lines`` too.
- The engine's registry metrics carry ``ray_tpu``'s names, kinds, help
  strings and buckets, and the same ``EngineMetrics`` records render the
  same text.
- ``tests/test_flight_recorder.py``: the ring's bound and resize, the
  disabled path, the event shape, the SIGUSR2 round trip, ``dump_flight``
  on the head and a node; in place of the chaos harness's dump before a
  planned kill (not ported), a worker process whose thread dies unhandled
  dumps its ring to the dump directory.
- ``tests/test_observability.py``'s metrics cases on the port's cluster:
  the core counters in the driver's registry, each node's ``GET
  /metrics`` on its ``metrics-port`` label, and the registry the driver
  publishes to the head's KV.
- ``scripts/trace_dump.py`` merges the head's spans, the flight rings and
  the task events of a live cluster into one chrome trace.
"""

from __future__ import annotations

import importlib
import json
import os
import signal
import time
import urllib.request

import pytest

import ray_tpu_torch
from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg
from ray_tpu_torch.util import flight_recorder as fr

PACKAGES = ["ray_tpu", "ray_tpu_torch"]


def _metrics(pkg):
    return importlib.import_module(f"{pkg}.util.metrics")


def _exercise(m):
    c = m.Counter("t_requests_total", "requests seen")
    g = m.Gauge("t_depth", "queue depth")
    h = m.Histogram("t_latency_seconds", "latency",
                    boundaries=[0.01, 0.1, 1.0])
    d = m.Histogram("t_default_buckets", "default buckets")
    c.inc()
    c.inc(2.5, labels={"engine": "e0"})
    c.inc(labels={"engine": 'quote"back\\slash\nnewline'})
    g.set(3, labels={"deployment": "a"})
    g.set(-1.5)
    for v in (0.005, 0.01, 0.05, 0.5, 7.0, 0.1):
        h.observe(v, labels={"engine": "e0"})
    h.observe(0.2)
    d.observe(30.0)
    return m.prometheus_text()


def test_prometheus_text_byte_equal(monkeypatch):
    texts = []
    for pkg in PACKAGES:
        m = _metrics(pkg)
        monkeypatch.setattr(m, "_REGISTRY", {})
        texts.append(_exercise(m))
    assert texts[1] == texts[0]
    assert "t_latency_seconds_bucket{engine=\"e0\",le=\"0.01\"} 2" in texts[1]


def test_gauge_lines_equal():
    samples = [({"node_id": "abc", "kind": "used"}, 12.0), ({}, 3)]
    outs = [importlib.import_module(f"{pkg}.util.metrics_agent")
            .gauge_lines("rtpu_x", "help text", samples) for pkg in PACKAGES]
    assert outs[1] == outs[0]


def test_engine_metrics_definitions_equal_ray_tpus():
    ref = importlib.import_module("ray_tpu.serve.engine.metrics")
    got = importlib.import_module("ray_tpu_torch.serve.engine.metrics")
    names = [n for n in dir(ref) if n.isupper()
             and isinstance(getattr(ref, n), _metrics("ray_tpu").Metric)]
    assert len(names) >= 15
    for n in names:
        a, b = getattr(ref, n), getattr(got, n)
        assert (b.name, b.kind, b.description) == (a.name, a.kind,
                                                   a.description), n
        assert getattr(b, "boundaries", None) == getattr(a, "boundaries",
                                                         None), n


def test_engine_metrics_records_render_equal():
    """The same admit/chunk/spec/depth records on one named engine in each
    package: the engine's lines of both registries are equal, and the
    snapshots agree on every count."""
    outs, snaps = [], []
    for pkg in PACKAGES:
        em = importlib.import_module(f"{pkg}.serve.engine.metrics")
        e = em.EngineMetrics("cmp-engine")
        e.record_admit(0.25, 17, 16)
        e.record_admit(0.05, 3, 0)
        e.record_chunk(8, 16, 0.04)
        e.record_chunk(0, 16, 0.01)
        e.record_spec(6, 4)
        e.record_depths(2, 1, 0.5)
        text = _metrics(pkg).prometheus_text()
        outs.append(sorted(line for line in text.splitlines()
                           if 'engine="cmp-engine"' in line))
        s = e.snapshot()
        snaps.append({k: v for k, v in s.items()})
    assert outs[1] == outs[0] and len(outs[0]) > 30
    assert snaps[1] == snaps[0]


# ------------------------------------------- tests/test_flight_recorder.py


@pytest.fixture
def clean_ring():
    fr.clear()
    yield
    fr.clear()


def test_ring_bounded_by_config_size(clean_ring):
    old = cfg.get("flight_recorder_size")
    cfg.set("flight_recorder_size", 64)
    try:
        for i in range(500):
            fr.record("ev", i=i)
        events = fr.snapshot()
        assert len(events) == 64
        assert events[-1][2]["i"] == 499
        assert events[0][2]["i"] == 500 - 64
        cfg.set("flight_recorder_size", 16)
        fr.record("ev", i=500)
        assert len(fr.snapshot()) == 16
    finally:
        cfg.set("flight_recorder_size", old)


def test_disabled_records_nothing(clean_ring):
    old = cfg.get("flight_recorder_enabled")
    cfg.set("flight_recorder_enabled", False)
    try:
        fr.record("nope", x=1)
        assert all(e[1] != "nope" for e in fr.snapshot())
    finally:
        cfg.set("flight_recorder_enabled", old)


def test_event_shape_and_payload(clean_ring):
    fr.record("lease_grant", lease="abc", worker="1.2.3.4:5")
    ts, kind, fields = fr.snapshot()[-1]
    assert kind == "lease_grant"
    assert abs(ts - time.time()) < 5
    assert fields == {"lease": "abc", "worker": "1.2.3.4:5"}
    payload = fr.dump_payload(clock_offset_s=0.25)
    assert payload["pid"] == os.getpid()
    assert payload["clock_offset_s"] == 0.25
    assert payload["events"][-1][1] == "lease_grant"
    # No witness sections: the port's dump is the ring and its identity.
    assert set(payload) == {"role", "pid", "node_id", "dumped_at",
                            "clock_offset_s", "events"}


def test_sigusr2_dump_round_trip(clean_ring, tmp_path):
    old_dir = cfg.get("flight_recorder_dump_dir")
    cfg.set("flight_recorder_dump_dir", str(tmp_path))
    try:
        assert fr.install_signal_handler()
        fr.record("pre_signal_marker", n=7)
        os.kill(os.getpid(), signal.SIGUSR2)
        deadline = time.time() + 10
        files = []
        while time.time() < deadline:
            time.sleep(0.05)
            files = list(tmp_path.glob("flight-*.json"))
            if files:
                break
        assert files, "SIGUSR2 produced no dump file"
        payload = json.loads(files[0].read_text())
        assert payload["reason"] == "SIGUSR2"
        assert any(e[1] == "pre_signal_marker" and e[2] == {"n": 7}
                   for e in payload["events"])
    finally:
        cfg.set("flight_recorder_dump_dir", old_dir)
        signal.signal(signal.SIGUSR2, signal.SIG_DFL)


# ------------------------------------------------ on the port's cluster


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    dump_dir = str(tmp_path_factory.mktemp("flight"))
    rt = ray_tpu_torch.init(
        num_cpus=2, object_store_memory=128 << 20,
        _system_config={"metrics_report_period_ms": 200,
                        "flight_recorder_dump_dir": dump_dir})
    try:
        yield rt, dump_dir
    finally:
        ray_tpu_torch.shutdown()
        for p in rt._procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
        cfg.set("flight_recorder_dump_dir", "")
        cfg.set("metrics_report_period_ms", 5000)
        os.environ.pop("RTPU_FLIGHT_RECORDER_DUMP_DIR", None)
        os.environ.pop("RTPU_METRICS_REPORT_PERIOD_MS", None)


def test_cluster_dump_flight_rpc(cluster):
    rt, _ = cluster
    head_dump = rt.head.retrying_call("dump_flight", timeout=10)
    assert head_dump["role"] == "head"
    assert head_dump["clock_offset_s"] == 0.0
    deadline = time.time() + 15
    kinds: set = set()
    while time.time() < deadline:
        node_dump = rt.node.retrying_call("dump_flight", timeout=10)
        kinds = {e[1] for e in node_dump["events"]}
        if "hb" in kinds:
            break
        time.sleep(0.3)
    assert node_dump["role"] == "node"
    assert node_dump["node_id"] == rt.node_id
    assert "hb" in kinds, kinds
    assert "clock_offset_s" in node_dump
    head_t = rt.head.retrying_call("clock_probe", timeout=10)
    assert abs(head_t - time.time()) < 5
    driver_dump = rt.rpc_dump_flight(None)
    assert driver_dump["role"] == "driver"


def test_worker_thread_death_dumps_its_ring(cluster):
    _rt, dump_dir = cluster

    @ray_tpu_torch.remote
    class Doomed:
        def boom(self):
            import threading

            from ray_tpu_torch.util import flight_recorder

            flight_recorder.record("before_the_end", step=1)

            def die():
                raise ValueError("unhandled in a worker thread")

            t = threading.Thread(target=die)
            t.start()
            t.join()
            import os as _os

            return _os.getpid()

    a = Doomed.remote()
    pid = ray_tpu_torch.get(a.boom.remote(), timeout=60)
    deadline = time.time() + 15
    files = []
    while time.time() < deadline and not files:
        files = [f for f in os.listdir(dump_dir)
                 if f.startswith(f"flight-worker-{pid}-")]
        time.sleep(0.1)
    assert files, os.listdir(dump_dir)
    payload = json.load(open(os.path.join(dump_dir, files[0])))
    assert payload["reason"] == "unhandled-thread:ValueError"
    assert any(e[1] == "before_the_end" for e in payload["events"])
    ray_tpu_torch.kill(a)


def test_metrics_counters_and_prometheus_text(cluster):
    from ray_tpu_torch.util import metrics

    @ray_tpu_torch.remote
    def m():
        return 2

    base = metrics.TASKS_SUBMITTED.get()
    ray_tpu_torch.get([m.remote() for _ in range(5)], timeout=60)
    assert metrics.TASKS_SUBMITTED.get() - base == 5
    ray_tpu_torch.put(b"x" * 2048)
    assert metrics.OBJECTS_PUT.get() >= 1
    text = metrics.prometheus_text()
    assert "rtpu_tasks_submitted_total" in text
    assert "# TYPE rtpu_task_exec_seconds histogram" in text


def test_per_node_prometheus_endpoint(cluster):
    nodes = [n for n in ray_tpu_torch.nodes() if n.get("alive", True)]
    assert nodes
    scraped = 0
    for n in nodes:
        port = n.get("labels", {}).get("metrics-port")
        if port is None:
            continue
        host = n["address"].rsplit(":", 1)[0]
        with urllib.request.urlopen(
                f"http://{host}:{port}/metrics", timeout=10) as r:
            body = r.read().decode()
        assert "rtpu_node_store_bytes" in body
        assert "rtpu_node_workers" in body
        assert "rtpu_node_resource" in body
        scraped += 1
    assert scraped >= 1, "no node advertised a metrics port"


def test_registries_reach_the_head_kv(cluster):
    """The driver publishes ``metrics/<node>`` and a worker that recorded
    something ``metrics/<node>/<pid>``, on the report loop's period or at
    once through ``publish_metrics``."""
    rt, _ = cluster

    @ray_tpu_torch.remote
    class Counting:
        def bump(self, n):
            import os as _os

            from ray_tpu_torch.util import metrics

            c = metrics.get_metric("t_worker_bumps_total") or \
                metrics.Counter("t_worker_bumps_total", "bumps")
            c.inc(n)
            return _os.getpid()

        def publish(self):
            from ray_tpu_torch.core.runtime_context import require_runtime

            require_runtime().publish_metrics()

    a = Counting.remote()
    pid = ray_tpu_torch.get(a.bump.remote(3), timeout=60)
    want = [f"metrics/{rt.node_id[:12]}",
            f"metrics/{rt.node_id[:12]}/{pid}"]
    deadline = time.time() + 15
    keys = []
    while time.time() < deadline:
        keys = [k.decode() for k in rt.head.retrying_call(
            "kv_keys", "default", b"metrics/", timeout=10)]
        if all(w in keys for w in want):
            break
        time.sleep(0.2)
    assert all(w in keys for w in want), keys
    text = rt.head.retrying_call("kv_get", "default", want[1].encode(),
                                 timeout=10).decode()
    assert "t_worker_bumps_total 3.0" in text
    # publish_metrics writes at once, without waiting for the loop.
    ray_tpu_torch.get(a.bump.remote(4), timeout=60)
    ray_tpu_torch.get(a.publish.remote(), timeout=60)
    text = rt.head.retrying_call("kv_get", "default", want[1].encode(),
                                 timeout=10).decode()
    assert "t_worker_bumps_total 7.0" in text
    ray_tpu_torch.kill(a)


def test_trace_dump_merges_a_live_cluster(cluster, tmp_path):
    from ray_tpu_torch.scripts import trace_dump

    rt, _ = cluster
    rt.head.notify("trace_spans", [{
        "trace_id": "td1", "span_id": "s1", "parent_id": "",
        "name": "serve.request", "start": time.time() - 0.01,
        "end": time.time(), "attrs": {"deployment": "x"}, "ok": True,
        "node": rt.node_id}])
    out = str(tmp_path / "merged.json")
    assert trace_dump.main(["--address", rt.head_addr, "--out", out,
                            "--limit", "1000"]) == 0
    merged = json.load(open(out))
    meta = merged["otherData"]
    assert meta["flight_dumps"] >= 2  # the head and the node
    names = {e["name"] for e in merged["traceEvents"]}
    assert "serve.request" in names
    assert "hb" in names  # a node's heartbeat events, clock-aligned
