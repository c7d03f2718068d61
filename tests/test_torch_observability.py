"""Timeline, state API and dashboard of the port
(``ray_tpu_torch/util/{timeline,state,dashboard}.py``), as
``tests/test_observability.py`` holds ``ray_tpu``'s: task completions
reach the timeline, the ring follows its configured size, the state
surfaces answer, the dashboard serves its page, JSON API and timeline;
then the node table's accelerator label and the chrome-trace JSON against
``ray_tpu``'s for the same recorded events."""

import json
import time
import urllib.request

import pytest

import ray_tpu_torch
from ray_tpu_torch.core.resources import LABEL_ACCELERATOR_TYPE


@pytest.fixture(scope="module")
def cluster():
    rt = ray_tpu_torch.init(num_cpus=4, object_store_memory=128 << 20)
    try:
        yield rt
    finally:
        ray_tpu_torch.shutdown()


def test_timeline_records_task_execution(cluster):
    from ray_tpu_torch.util.timeline import dump_timeline

    @ray_tpu_torch.remote
    def traced():
        import time as t

        t.sleep(0.05)
        return 1

    before = len([e for e in dump_timeline() if e["name"].endswith("traced")])
    ray_tpu_torch.get([traced.remote() for _ in range(3)], timeout=60)
    events = [e for e in dump_timeline() if e["name"].endswith("traced")]
    assert len(events) - before == 3
    assert all(e["dur"] >= 0.04 * 1e6 for e in events[-3:])
    assert all(e["args"]["status"] == "ok" for e in events[-3:])
    assert ray_tpu_torch.timeline()[-1] == dump_timeline()[-1]


def test_timeline_ring_resizes_with_config():
    from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg
    from ray_tpu_torch.util import timeline

    old = cfg.get("task_events_buffer_size")
    try:
        timeline.clear()
        cfg.set("task_events_buffer_size", 8)
        for i in range(50):
            timeline.record_instant(f"ev-{i}")
        events = timeline.dump_timeline()
        assert len(events) == 8
        assert events[-1]["name"] == "ev-49"
        cfg.set("task_events_buffer_size", 32)
        for i in range(20):
            timeline.record_instant(f"more-{i}")
        assert len(timeline.dump_timeline()) == 8 + 20
    finally:
        cfg.set("task_events_buffer_size", old)
        timeline.clear()


def test_state_api(cluster):
    from ray_tpu_torch.util import state

    @ray_tpu_torch.remote
    class Holder:
        def get(self):
            return 1

    h = Holder.remote()
    ray_tpu_torch.get(h.get.remote(), timeout=30)
    assert any(a["state"] == "ALIVE" for a in state.list_actors())
    assert len(state.list_nodes()) >= 1
    assert isinstance(state.list_placement_groups(), dict)
    assert any(t["state"] == "FINISHED" for t in state.list_tasks())
    summary = state.summarize_objects()
    assert "local_store" in summary and summary["tracked_refs"] >= 0
    stats = state.rpc_event_stats()
    assert stats.get("task_done", {}).get("count", 0) >= 1
    assert "rtpu_tasks_finished_total" in state.local_metrics_text()
    ray_tpu_torch.kill(h)


def test_dashboard_lite(cluster):
    from ray_tpu_torch.util import dashboard

    @ray_tpu_torch.remote
    def probe():
        return 1

    ray_tpu_torch.get(probe.remote(), timeout=30)
    port = dashboard.start(port=0)
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/",
                                timeout=30) as resp:
        html = resp.read().decode()
    assert "ray_tpu_torch cluster" in html
    assert "drawTimeline" in html and "/api/timeline" in html
    assert "'accelerator'" in html
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/api",
                                timeout=30) as resp:
        payload = json.loads(resp.read())
    assert payload["nodes"] and "objects" in payload
    assert payload["nodes"][0]["alive"] is True
    assert "jobs" in payload and "pending_demand" in payload
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/api/timeline",
                                timeout=30) as resp:
        events = json.loads(resp.read())
    spans = [e for e in events if e.get("ph") == "X"]
    assert spans and all("ts" in e and "dur" in e for e in spans)
    assert any("probe" in e.get("name", "") for e in spans)
    dashboard.stop(port)
    with pytest.raises(OSError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/api", timeout=5)


def test_dashboard_and_state_show_the_card_model(cluster):
    """A node with an a3-highgpu-2g's cards and labels (what the GPU
    manager's detection gives such a host) is listed with ``GPU`` and the
    model label, and the dashboard's JSON carries the label as the node's
    ``accelerator``."""
    from ray_tpu_torch.core.accelerators import machine_node_resources
    from ray_tpu_torch.util import dashboard, state

    res, labels = machine_node_resources("a3-highgpu-2g")
    node = cluster.add_node(num_cpus=1, resources=res, labels=labels)
    try:
        deadline = time.monotonic() + 30
        listed = None
        while listed is None and time.monotonic() < deadline:
            listed = next((n for n in state.list_nodes()
                           if n["node_id"] == node.node_id and n["alive"]),
                          None)
            time.sleep(0.2)
        assert listed is not None
        assert listed["resources"]["GPU"] == 2.0
        assert listed["labels"][LABEL_ACCELERATOR_TYPE] == "H100"
        port = dashboard.start(port=0)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/api",
                                    timeout=30) as resp:
            nodes = {n["node_id"]: n for n in json.loads(resp.read())["nodes"]}
        assert nodes[node.node_id]["accelerator"] == "H100"
        dashboard.stop(port)
    finally:
        cluster.remove_node(node)


def test_chrome_trace_json_equals_ray_tpus(tmp_path):
    """The same recorded events dump to the same chrome-trace JSON bytes
    in both packages (``ray_tpu``'s module alone, no cluster)."""
    from ray_tpu.util import timeline as ref

    from ray_tpu_torch.util import timeline as port

    events = [("task_a", "task", 1700000000.25, 1700000000.75, 0, 0,
               {"task_id": "ab12", "status": "ok"}),
              ("task_b", "task", 1700000001.0, 1700000003.5, 12, 3,
               {"status": "error"}),
              ("step", "workflow", 1700000004.0, 1700000004.0, 0, 0, None)]
    out = {}
    for name, mod in (("port", port), ("ref", ref)):
        mod.clear()
        try:
            for ev in events:
                mod.record_event(*ev)
            out[name] = open(mod.dump_timeline(
                str(tmp_path / f"{name}.json"))).read()
        finally:
            mod.clear()
    assert out["port"] == out["ref"]
    assert [e["name"] for e in json.loads(out["port"])] == \
        ["task_a", "task_b", "step"]


def test_joined_driver_returns_its_leases_at_shutdown(cluster):
    """A driver that joins the cluster (``init(address=...)``), runs a
    task and shuts down hands its lease back: the node lists no lease of
    it, and the next task reuses the same worker. Without the return the
    node kept the worker and the lease's CPU until the cluster ended
    (``ray_tpu``'s ``ClusterCore.shutdown`` returns no lease either)."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def leases():
        out = []
        for n in cluster.nodes():
            if n["alive"]:
                try:
                    held, _ = cluster._pool.get(n["address"]).call(
                        "list_leases", timeout=5)
                except Exception:  # the joined driver's own node, gone
                    continue
                out += [l for l in held if l["resources"]]
        return out

    @ray_tpu_torch.remote(num_cpus=3)
    def pid():
        import os as _os

        return _os.getpid()

    code = ("import os, sys, ray_tpu_torch\n"
            "ray_tpu_torch.init(address=sys.argv[1])\n"
            "f = ray_tpu_torch.remote(num_cpus=3)(lambda: os.getpid())\n"
            "print('PID', ray_tpu_torch.get(f.remote(), timeout=60))\n"
            "ray_tpu_torch.shutdown()\n")
    deadline = time.monotonic() + 10
    while leases() and time.monotonic() < deadline:
        time.sleep(0.2)
    proc = subprocess.run([sys.executable, "-c", code, cluster.head_addr],
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=root))
    assert proc.returncode == 0, proc.stderr[-3000:]
    child = int(proc.stdout.split("PID", 1)[1])
    assert leases() == []
    assert ray_tpu_torch.get(pid.remote(), timeout=60) == child



def test_actor_placement_skips_a_node_that_refuses_the_dial():
    """The head's actor placement dials the node it picked inside its
    try: a node that died but is not yet marked dead (a joined driver's
    zero-CPU node, just gone) is excluded and the next pick is taken.
    Outside the try, its ``ConnectionRefusedError`` would fail the
    creation (``ray_tpu``'s head dials outside it)."""
    import socket

    from ray_tpu_torch.cluster.head import ActorInfo, HeadServer
    from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    dead = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()  # nothing listens there now
    head = HeadServer(port=0)
    old = cfg.get("lease_timeout_ms")
    picks = []

    def pick(conn, resources, strategy, exclude, demand_key=None):
        picks.append(list(exclude))
        return ("dead-node", dead, None) if "dead-node" not in exclude \
            else None

    try:
        cfg.set("lease_timeout_ms", 100)
        head.rpc_pick_node = pick
        info = ActorInfo(b"a" * 16, None, "default", b"", 0, {})
        with pytest.raises(RuntimeError, match="no feasible node"):
            head._create_actor_on_some_node(info)
        assert picks[0] == [] and ["dead-node"] in picks
    finally:
        cfg.set("lease_timeout_ms", old)
        head.shutdown()
