"""The port's scale-mode harness and the head's upgrade and restart
paths: the counterparts of ``tests/test_scale_sim.py`` (simulated nodes,
the head's indexed hot-path structures, ``prepare_upgrade`` with its
summary's keys held to ``ray_tpu``'s), of ``tests/test_head_restart.py``
and of ``tests/test_scalability_harness.py``, a rolling head upgrade on
a port cluster, and the zygote's spawn counts.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

import pytest

from ray_tpu.cluster.head import HeadServer as JaxHeadServer

import ray_tpu_torch
from ray_tpu_torch.cluster import node_manager
from ray_tpu_torch.cluster.head import HeadServer
from ray_tpu_torch.core.cluster_runtime import SimulatedCluster
from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg


def test_simulated_cluster_control_plane_end_to_end():
    """8 simulated nodes register, heartbeat, serve picks/locations/
    census/drain — the full control-plane surface bench.py --scale
    profiles at 100."""
    sim = SimulatedCluster(8, resources={"CPU": 4.0})
    try:
        sim.wait_registered(30)
        views = sim.client.call("list_nodes", timeout=10)
        assert sum(1 for v in views if v["alive"]) == 8
        # Scheduling works against simulated nodes.
        picked = sim.client.call("pick_node", {"CPU": 1.0}, None, None,
                                 "sim-k", timeout=10)
        assert picked is not None
        # Directory: seed via the batched wire shape, look up, drain.
        nid = sim.nodes[0].node_id
        oid = b"x" * 28
        sim.client.call("object_batch", nid, [("add", oid, 123)],
                        timeout=10)
        locs = sim.client.call("object_locations", oid, None, timeout=10)
        assert [l[0] for l in locs] == [nid]
        census = sim.client.call("cluster_leases", timeout=30)
        assert len(census) == 8
        assert all("error" not in v for v in census.values()
                   if isinstance(v, dict))
        sim.client.call("drain_node", nid, timeout=10)
        assert sim.client.call("object_locations", oid, None,
                               timeout=10) == []
    finally:
        sim.shutdown()


def test_simulated_node_spawns_no_worker_machinery():
    sim = SimulatedCluster(1)
    try:
        sim.wait_registered(15)
        n = sim.nodes[0]
        assert n.simulated
        assert n._workers == {}
        assert n._zygote is None
        assert n._metrics_exporter is None
        # The stubbed store serves the control-plane calls it needs.
        assert n.store.contains(object()) is False
        assert n.store.stats() == (0, 0, 0, 0)
    finally:
        sim.shutdown()


def test_head_reverse_index_tracks_adds_removes_and_death():
    """The node->objects reverse index must stay consistent with the
    holder-set directory through every mutation path — it is what node
    death/drain scrubs instead of walking the full table."""
    head = HeadServer()
    try:
        head.rpc_register_node(None, "nA", "127.0.0.1:1", {"CPU": 1}, {},
                               "sA")
        head.rpc_register_node(None, "nB", "127.0.0.1:2", {"CPU": 1}, {},
                               "sB")
        o1, o2 = b"a" * 28, b"b" * 28
        head.rpc_object_added(None, o1, "nA", 10)
        head.rpc_object_batch(None, "nB", [("add", o1, 10),
                                           ("add", o2, 20)])
        assert head._node_objects["nA"] == {o1}
        assert head._node_objects["nB"] == {o1, o2}
        # Removal via both wire shapes.
        head.rpc_object_removed(None, o1, "nA")
        assert head._node_objects["nA"] == set()
        assert head._object_dir[o1] == {"nB"}
        # Death scrub drops ONLY the dead node's entries.
        head._on_node_dead("nB")
        assert "nB" not in head._node_objects
        assert o1 not in head._object_dir
        assert o2 not in head._object_dir
        assert head._object_sizes == {}
    finally:
        head.shutdown()


def test_node_util_cache_tracks_heartbeats():
    """pick scoring reads the cached util; heartbeats (full and delta)
    must keep it fresh."""
    head = HeadServer()
    try:
        head.rpc_register_node(None, "nA", "127.0.0.1:1",
                               {"CPU": 4.0, "GPU": 2.0}, {}, "sA")
        n = head._nodes["nA"]
        assert n.util == 0.0
        assert head.rpc_heartbeat(None, "nA", {"CPU": 2.0, "GPU": 2.0},
                                  version=1, is_delta=False) is True
        assert n.util == 0.5
        # Delta carrying only the changed resource.
        assert head.rpc_heartbeat(None, "nA", {"GPU": 0.0},
                                  version=2, is_delta=True) is True
        assert n.util == 1.0
        # Empty delta (nothing changed): cheap, util untouched.
        assert head.rpc_heartbeat(None, "nA", {}, version=3,
                                  is_delta=True) is True
        assert n.util == 1.0
        # The pick path consumes the cache: a fully-used node loses to
        # an idle one.
        head.rpc_register_node(None, "nB", "127.0.0.1:2",
                               {"CPU": 4.0, "GPU": 2.0}, {}, "sB")
        picked = head.rpc_pick_node(None, {"CPU": 1.0})
        assert picked[0] == "nB"
    finally:
        head.shutdown()


def test_prepare_upgrade_summary_equals_ray_tpu():
    """The same registrations on both packages' heads: the drain summary
    has ``ray_tpu``'s keys and, but for the incarnation, its values."""
    out = []
    for cls in (JaxHeadServer, HeadServer):
        head = cls()
        try:
            head.rpc_register_node(None, "nA", "127.0.0.1:1", {"CPU": 1},
                                   {}, "sA")
            head.rpc_register_node(None, "nB", "127.0.0.1:2", {"CPU": 2},
                                   {}, "sB")
            summary = head.rpc_prepare_upgrade(None)
            assert summary == head.rpc_prepare_upgrade(None)  # idempotent
            assert summary.pop("incarnation") == head.incarnation
            out.append(summary)
        finally:
            head.shutdown()
    assert out[1] == out[0]


def test_prepare_upgrade_drains_and_reports():
    head = HeadServer()
    try:
        head.rpc_register_node(None, "nA", "127.0.0.1:1", {"CPU": 1}, {},
                               "sA")
        summary = head.rpc_prepare_upgrade(None)
        assert summary["incarnation"] == head.incarnation
        assert summary["nodes"] == 1
        assert summary["flushed"] is False  # memory-only head
        assert head._draining
        # Draining head stops issuing death verdicts: a node with an
        # ancient heartbeat survives the sweep.
        head._nodes["nA"].last_heartbeat = time.monotonic() - 3600
        head._sweep_alive_watch()  # no-op either way; the health loop
        # itself is gated on _draining (exercised via the flag).
        assert head.rpc_resume_serving(None) is True
        assert not head._draining
    finally:
        head.shutdown()


def test_recovered_alive_actor_watch_grace(tmp_path):
    """A head restarted from sqlite with an ALIVE actor whose node never
    re-registers must declare it dead after the grace window and
    re-drive it (the all-holders-dead shape, unit tier)."""
    from ray_tpu_torch.cluster.head import ALIVE, RESTARTING, DEAD, ActorInfo

    db = str(tmp_path / "head.db")
    head = HeadServer(persist_path=db)
    aid = b"actor-000"
    try:
        info = ActorInfo(aid, None, "default", b"\x80\x04N.", 1, {},
                         max_task_retries=-1)
        info.state = ALIVE
        info.node_id = "gone-node"
        info.worker_addr = "127.0.0.1:9"
        head._actors[aid] = info
        head._persist_actor(info)
    finally:
        head.shutdown()
    old = cfg.head_restart_actor_grace_s
    cfg.set("head_restart_actor_grace_s", 0.5)
    try:
        head2 = HeadServer(persist_path=db)
        try:
            assert aid in head2._alive_watch
            info2 = head2._actors[aid]
            assert info2.state == ALIVE
            assert info2.max_task_retries == -1  # persisted policy
            deadline = time.monotonic() + 15
            while time.monotonic() < deadline and aid in head2._alive_watch:
                time.sleep(0.1)
            # Grace expired with no node: re-driven through max_restarts
            # (no node to land on here, so it parks RESTARTING and then
            # fails -> DEAD; the point is it LEFT the zombie-ALIVE state).
            deadline = time.monotonic() + 15
            while time.monotonic() < deadline and \
                    head2._actors[aid].state == ALIVE:
                time.sleep(0.1)
            assert head2._actors[aid].state in (RESTARTING, DEAD)
        finally:
            head2.shutdown()
    finally:
        cfg.set("head_restart_actor_grace_s", old)


def test_recovered_alive_actor_confirmed_when_node_returns(tmp_path):
    """The inverse: the host node re-registers inside the grace window
    and the actor is confirmed, never killed."""
    from ray_tpu_torch.cluster.head import ALIVE, ActorInfo

    db = str(tmp_path / "head.db")
    head = HeadServer(persist_path=db)
    aid = b"actor-001"
    try:
        info = ActorInfo(aid, None, "default", b"\x80\x04N.", 1, {})
        info.state = ALIVE
        info.node_id = "node-back"
        head._actors[aid] = info
        head._persist_actor(info)
    finally:
        head.shutdown()
    head2 = HeadServer(persist_path=db)
    try:
        assert aid in head2._alive_watch
        head2.rpc_register_node(None, "node-back", "127.0.0.1:3",
                                {"CPU": 1}, {}, "s")
        head2._sweep_alive_watch()
        assert aid not in head2._alive_watch
        assert head2._actors[aid].state == ALIVE
    finally:
        head2.shutdown()


# ------------------------------------------------------ on a port cluster

@pytest.fixture(scope="module")
def cluster():
    rt = ray_tpu_torch.init(num_cpus=4, object_store_memory=256 << 20)
    try:
        yield rt
    finally:
        ray_tpu_torch.shutdown()


def _kill_head(rt):
    pid = rt._head_proc.pid
    os.kill(pid, signal.SIGKILL)
    return pid


def _wait_head_respawn(rt, old_pid, timeout=30):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        proc = rt._head_proc
        if proc.pid != old_pid and proc.poll() is None:
            return
        time.sleep(0.2)
    raise TimeoutError("head did not respawn")


def test_spawn_stats_count_forked_and_cold(cluster):
    """CPU workers fork from the zygote where pidfds work (this host), and
    ``spawn_stats`` counts them by route with no miss."""

    @ray_tpu_torch.remote(num_cpus=1)
    def pid():
        time.sleep(0.3)
        return os.getpid()

    assert len(set(ray_tpu_torch.get([pid.remote() for _ in range(4)],
                                     timeout=60))) >= 2
    (stats,) = cluster.spawn_stats()
    assert stats["forked"] >= 2 and stats["cold_cpu"] == 0
    assert stats["cold_gpu"] == 0 and stats["zygote_miss"] is None


@pytest.mark.parametrize("case", ["pidfd", "disabled", "interpreter"])
def test_zygote_gate_names_its_reason(monkeypatch, case):
    """Why a default-env CPU worker cold-spawns: the reason that
    ``spawn_stats`` reports (on a gVisor host, pidfd_open is ENOSYS)."""
    py = sys.executable
    if case == "pidfd":
        monkeypatch.setattr(node_manager, "_pidfd_supported", lambda: False)
        want = "pidfd_open unavailable"
    elif case == "disabled":
        monkeypatch.setitem(cfg._values, "worker_zygote_enabled", False)
        want = "worker_zygote_enabled is off"
    else:
        py = "/other/python"
        want = f"interpreter /other/python is not {sys.executable}"
    assert node_manager.NodeManager._zygote_gate(py) == want
    monkeypatch.undo()
    assert node_manager.NodeManager._zygote_gate(sys.executable) is None


def test_rolling_head_upgrade_keeps_work_flowing(cluster):
    """Drain, checkpoint and swap the head on its port: a new
    incarnation, the actor and KV kept, no request failed across it."""

    @ray_tpu_torch.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def inc(self):
            self.n += 1
            return self.n

    @ray_tpu_torch.remote
    def ping(i):
        return i

    c = Counter.options(name="upgrade-survivor").remote()
    assert ray_tpu_torch.get(c.inc.remote(), timeout=60) == 1
    cluster.kv_put("upgrade_key", b"kept")
    before = ray_tpu_torch.get([ping.remote(i) for i in range(8)],
                               timeout=60)
    report = cluster.rolling_head_upgrade()
    assert report["old_incarnation"] != report["new_incarnation"]
    assert report["upgrade_s"] >= report["drain_s"] >= 0
    assert ray_tpu_torch.get([ping.remote(i) for i in range(8)],
                             timeout=120) == before
    assert ray_tpu_torch.get(c.inc.remote(), timeout=60) == 2
    assert cluster.kv_get("upgrade_key") == b"kept"
    stats = cluster.head.retrying_call("scheduler_stats", timeout=30)
    assert stats["head_incarnation"] == report["new_incarnation"]


def test_head_kill9_pending_gets_complete(cluster):
    """Tasks already pushed to workers complete across a head crash: the
    completion path is worker->owner direct and never touches the head."""

    @ray_tpu_torch.remote
    def slow(i):
        time.sleep(3)
        return i * 2

    refs = [slow.remote(i) for i in range(4)]
    time.sleep(0.5)  # let the pushes land on workers
    old_pid = _kill_head(cluster)
    # Pending gets resolve while the head is down/restarting.
    assert ray_tpu_torch.get(refs, timeout=120) == [0, 2, 4, 6]
    _wait_head_respawn(cluster, old_pid)


def test_head_restart_preserves_actors_kv_and_serves_new_work(cluster):
    @ray_tpu_torch.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def inc(self):
            self.n += 1
            return self.n

    c = Counter.options(name="survivor").remote()
    assert ray_tpu_torch.get(c.inc.remote(), timeout=60) == 1
    cluster.kv_put("durable_key", b"durable_value")

    old_pid = _kill_head(cluster)
    _wait_head_respawn(cluster, old_pid)
    time.sleep(2.0)  # node re-registration rides the next heartbeat NACK

    # Actor state survives (the actor PROCESS never died; the restarted
    # head recovered its directory entry from the durable tables).
    assert ray_tpu_torch.get(c.inc.remote(), timeout=60) == 2
    handle = ray_tpu_torch.get_actor("survivor")
    assert ray_tpu_torch.get(handle.inc.remote(), timeout=60) == 3
    # KV survives.
    assert cluster.kv_get("durable_key") == b"durable_value"

    @ray_tpu_torch.remote
    def ping():
        return "alive"

    assert ray_tpu_torch.get([ping.remote() for _ in range(8)],
                             timeout=120) == ["alive"] * 8
    c2 = Counter.remote()
    assert ray_tpu_torch.get(c2.inc.remote(), timeout=60) == 1


def test_harness_smoke_all_benchmarks(tmp_path):
    """Every bench shape of ``util/scalability.py`` runs end to end at
    tiny sizes with sane numbers, in a process of its own."""
    out = str(tmp_path / "perf.json")
    proc = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.util.scalability", "--smoke",
         "--out", out],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    with open(out) as f:
        report = json.load(f)
    s = report["scalability"]
    assert s["many_actors"]["num_actors"] == 50
    assert s["many_actors"]["actors_per_s"] > 1.0
    assert s["many_pgs"]["pgs_per_s"] > 1.0
    assert s["many_queued_tasks"]["end_to_end_per_s"] > 100.0
    assert s["broadcast"]["num_nodes"] == 2
    assert s["broadcast"]["broadcast_s"] < 120.0
    mc = s["multi_client_drivers"]
    assert mc["num_client_processes"] == 2
    assert mc["aggregate_tasks_per_s"] > 100.0
    assert "_meta" in s and "host" in s["_meta"]
