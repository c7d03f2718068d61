"""The port's chaos harness (``ray_tpu_torch/devtools/chaos.py``), case for
case with ``tests/test_chaos.py``.

- The plan engine (grammar, counters, seeds, the plan cache) runs on
  ``ray_tpu``'s module and on the port's, which must decide alike.
- The RPC-layer injection runs over a live server/client pair of each
  package under one plan, and the port must fail the same calls as
  ``ray_tpu`` (the outcome of every call, in order, is compared).
- The failure-domain cases drive the port's own head and node managers
  in process.
- The standing scenarios boot the port's subprocess clusters and kill
  processes; like ``ray_tpu``'s, they are marked ``slow``.
"""

from __future__ import annotations

import importlib
import threading
import time
import uuid

import pytest

from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg
from ray_tpu_torch.devtools import chaos
from ray_tpu_torch.devtools.chaos import ChaosPlanError, FaultPlan

PKGS = ("ray_tpu", "ray_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _cfg(pkg):
    return _mod(pkg, "core.config").GLOBAL_CONFIG


def _chaos(pkg):
    return _mod(pkg, "devtools.chaos")


def _both(scenario):
    out = [scenario(pkg) for pkg in PKGS]
    ref, got = out
    assert got == ref, (got, ref)
    return got


# --------------------------------------------------------------------------
# plan engine
# --------------------------------------------------------------------------


def test_plan_parse_defaults_and_repr():
    def run(pkg):
        plan = _chaos(pkg).FaultPlan.parse(
            "drop_request:method=push_*:role=worker;"
            "delay:secs=0.5;kill:role=head:method=register_actor:nth=2")
        return [(r.action, r.method, r.role, r.side, r.secs, r.nth,
                 r.count, repr(r)) for r in plan.rules]

    r0, r1, r2 = _both(run)
    assert r0[:4] == ("drop_request", "push_*", "worker", "request")
    assert r1[4] == 0.5 and r1[6] is None
    assert r2[5] == 2 and r2[6] == 1
    assert "kill" in r2[7] and "nth=2" in r2[7]


def test_plan_parse_rejects_garbage():
    for text, match in (("explode:method=x", "unknown chaos action"),
                        ("delay:whoops", "key=value"),
                        ("delay:wibble=3", "unknown key")):
        with pytest.raises(ChaosPlanError, match=match):
            FaultPlan.parse(text)
        with pytest.raises(_chaos("ray_tpu").ChaosPlanError, match=match):
            _chaos("ray_tpu").FaultPlan.parse(text)


def test_plan_parse_peer_value_with_colon():
    def run(pkg):
        plan = _chaos(pkg).FaultPlan.parse(
            "sever:peer=127.0.0.1:9000:method=echo")
        r = plan.rules[0]
        return (r.peer, r.method,
                r.decide("", "echo", "request", peer="127.0.0.1:9000"),
                r.decide("", "echo", "request", peer="127.0.0.1:9001"))

    assert _both(run) == ("127.0.0.1:9000", "echo", True, False)


def test_invalid_plan_disables_loudly_not_fatally(capsys):
    try:
        cfg.set("chaos_plan", "explode:method=x")
        assert chaos.current_plan() is None
        assert "invalid plan" in capsys.readouterr().out
        assert chaos.current_plan() is None  # cached; no repeat spam
        assert "invalid plan" not in capsys.readouterr().out
    finally:
        cfg.set("chaos_plan", "")


def test_nth_after_count_semantics():
    def run(pkg):
        P = _chaos(pkg).FaultPlan
        a = P.parse("drop_request:method=m:nth=2")
        b = P.parse("drop_request:method=m:after=2:count=3")
        return ([bool(a.actions_for("", "m", "request")) for _ in range(5)],
                [bool(b.actions_for("", "m", "request")) for _ in range(7)])

    assert _both(run) == ([False, True, False, False, False],
                          [False, False, True, True, True, False, False])


def test_role_method_side_scoping():
    def run(pkg):
        plan = _chaos(pkg).FaultPlan.parse(
            "drop_response:method=kill_actor:role=worker")
        return [bool(plan.actions_for(*e)) for e in (
            ("worker", "kill_actor", "request"),
            ("head", "kill_actor", "response"),
            ("worker", "heartbeat", "response"),
            ("worker", "kill_actor", "response"))]

    assert _both(run) == [False, False, False, True]


def test_prob_rules_are_seed_deterministic():
    def run(pkg):
        P = _chaos(pkg).FaultPlan
        seqs = []
        for seed in (7, 7, 8):
            p = P.parse(f"drop_request:method=m:prob=0.3:seed={seed}")
            seqs.append([bool(p.actions_for("", "m", "request"))
                         for _ in range(200)])
        return seqs

    a, b, c = _both(run)
    assert a == b and a != c and 20 < sum(a) < 120


def test_plan_cache_tracks_config_changes():
    def run(pkg):
        c, ch = _cfg(pkg), _chaos(pkg)
        try:
            c.set("chaos_plan", "delay:method=x:secs=0.1")
            p1 = ch.current_plan()
            cached = ch.current_plan() is p1
            c.set("chaos_plan", "delay:method=x:secs=0.2")
            p2 = ch.current_plan()
            out = (p1.rules[0].secs, cached, p2 is not p1,
                   p2.rules[0].secs)
        finally:
            c.set("chaos_plan", "")
        return out + (ch.current_plan() is None, ch.chaos_enabled())

    assert _both(run) == (0.1, True, True, 0.2, True, False)


def test_plan_rearm_after_clear_resets_counters():
    def run(pkg):
        c, ch = _cfg(pkg), _chaos(pkg)
        plan_str = "drop_request:method=m:nth=1"
        try:
            c.set("chaos_plan", plan_str)
            first = bool(ch.current_plan().actions_for("", "m", "request"))
            c.set("chaos_plan", "")
            cleared = ch.current_plan() is None
            c.set("chaos_plan", plan_str)
            again = bool(ch.current_plan().actions_for("", "m", "request"))
        finally:
            c.set("chaos_plan", "")
        return first, cleared, again

    assert _both(run) == (True, True, True)


# --------------------------------------------------------------------------
# protocol integration (real sockets, no cluster)
# --------------------------------------------------------------------------


class _EchoHandler:
    chaos_role = "node"
    extra_retry_safe_rpcs = frozenset({"echo"})

    def __init__(self):
        self.calls = 0

    def rpc_echo(self, conn, x):
        self.calls += 1
        return x

    def rpc_ping(self, conn):  # name IS in RETRY_SAFE_RPCS
        return "pong"


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the outcome is the result
        return ("err", "timeout" if isinstance(e, TimeoutError)
                else type(e).__name__)


def _on_pair(pkg, body):
    """``body(handler, server, client, cfg, chaos)`` over a live pair of
    ``pkg``; the plan and blind probability are cleared after."""
    p = _mod(pkg, "cluster.protocol")
    c = _cfg(pkg)
    h = _EchoHandler()
    server = p.RpcServer(h).start()
    client = p.RpcClient(server.address)
    try:
        return body(h, server, client, c, _chaos(pkg))
    finally:
        c.set("chaos_plan", "")
        c.set("rpc_chaos_failure_prob", 0.0)
        client.close()
        server.stop()


def test_drop_request_then_retry_recovers():
    def run(pkg):
        def body(h, _s, client, c, _ch):
            c.set("chaos_plan", "drop_request:role=node:method=echo:nth=1")
            first = _outcome(lambda: client.call("echo", 1, timeout=0.5))
            seen = h.calls
            return first, seen, _outcome(
                lambda: client.call("echo", 2, timeout=10))
        return _on_pair(pkg, body)

    assert _both(run) == (("err", "timeout"), 0, ("ok", 2))


def test_drop_response_runs_handler_but_loses_reply():
    def run(pkg):
        def body(h, _s, client, c, _ch):
            c.set("chaos_plan", "drop_response:method=echo:nth=1")
            first = _outcome(lambda: client.call("echo", 1, timeout=0.5))
            seen = h.calls
            return first, seen, _outcome(
                lambda: client.call("echo", 2, timeout=10))
        return _on_pair(pkg, body)

    assert _both(run) == (("err", "timeout"), 1, ("ok", 2))


def test_delay_rule_adds_latency():
    def run(pkg):
        def body(_h, _s, client, c, _ch):
            c.set("chaos_plan", "delay:method=echo:secs=0.4:count=1")
            t0 = time.monotonic()
            a = client.call("echo", 3, timeout=10)
            slow = time.monotonic() - t0 >= 0.35
            t0 = time.monotonic()
            b = client.call("echo", 4, timeout=10)
            return a, slow, b, time.monotonic() - t0 < 0.3
        return _on_pair(pkg, body)

    assert _both(run) == (3, True, 4, True)


def test_sever_kills_connection_and_retrying_call_recovers():
    def run(pkg):
        lost = _mod(pkg, "cluster.protocol").ConnectionLost

        def body(_h, _s, client, c, _ch):
            c.set("chaos_plan", "sever:method=echo:nth=1")
            with pytest.raises((lost, TimeoutError)):
                client.call("echo", 1, timeout=5)
            client.reconnect()
            after = client.call("echo", 2, timeout=10)
            c.set("chaos_plan", "sever:method=echo:nth=1")
            return after, client.retrying_call("echo", 3, timeout=5)
        return _on_pair(pkg, body)

    assert _both(run) == (2, 3)


def test_kill_action_reaches_kill_hook(monkeypatch):
    def run(pkg):
        hits = []
        monkeypatch.setattr(_chaos(pkg), "_kill_self",
                            lambda: hits.append(1))

        def body(_h, _s, client, c, _ch):
            c.set("chaos_plan", "kill:role=node:method=echo:nth=1")
            return _outcome(lambda: client.call("echo", 1, timeout=0.5))
        return _on_pair(pkg, body), hits

    assert _both(run) == (("err", "timeout"), [1])


def test_blind_chaos_only_drops_retry_safe_methods():
    def run(pkg):
        safe = _mod(pkg, "cluster.protocol").RETRY_SAFE_RPCS
        assert "ping" in safe and "echo" not in safe

        def body(_h, _s, client, c, _ch):
            c.set("rpc_chaos_failure_prob", 1.0)
            a = _outcome(lambda: client.call("echo", 7, timeout=10))
            b = _outcome(lambda: client.call("ping", timeout=0.5))
            c.set("rpc_chaos_failure_prob", 0.0)
            return a, b, _outcome(lambda: client.call("ping", timeout=10))
        return _on_pair(pkg, body)

    assert _both(run) == (("ok", 7), ("err", "timeout"), ("ok", "pong"))


def test_retrying_call_outlasts_respawn_window():
    """A peer DOWN for longer than the backoff-exhaustion time but back
    within rpc_retry_min_window_s is ridden out."""
    from ray_tpu_torch.cluster.protocol import RpcClient, RpcServer

    h = _EchoHandler()
    server = RpcServer(h).start()
    client = RpcClient(server.address)
    host, port = server.address.rsplit(":", 1)
    server.stop()
    restarted = {}

    def respawn():
        time.sleep(4.0)  # longer than 5 attempts' ~3.1 s of backoff
        restarted["server"] = RpcServer(h, host=host,
                                        port=int(port)).start()

    threading.Thread(target=respawn, daemon=True).start()
    try:
        assert client.retrying_call("echo", 42, timeout=5) == 42
    finally:
        client.close()
        s2 = restarted.get("server")
        if s2 is not None:
            s2.stop()


# --------------------------------------------------------------------------
# failure-domain reconciliation (in-process head + node managers)
# --------------------------------------------------------------------------


def _node(head_addr: str, resources=None):
    from ray_tpu_torch.cluster.node_manager import NodeManager

    return NodeManager(head_addr, uuid.uuid4().hex,
                       resources or {"CPU": 2.0}, {}, 64 << 20)


class _FakeProc:
    def poll(self):
        return None

    def terminate(self):
        pass

    def kill(self):
        pass

    def wait(self, timeout=None):
        return 0


def _wait_until(fn, timeout_s, msg):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if fn():
            return
        time.sleep(0.1)
    raise AssertionError(msg)


def test_head_restart_rehydrates_directory_and_reconciles_leases():
    """A restarted head relearns this node's copies from the node's
    mirror, and a lease granted to the dead head's in-flight actor
    creation is returned while an actor-hosting lease survives."""
    from ray_tpu_torch.cluster.head import HeadServer
    from ray_tpu_torch.cluster.node_manager import Lease, WorkerProc
    from ray_tpu_torch.core.ids import ObjectID

    head = HeadServer()
    nm = _node(head.address)
    try:
        old_inc = head.incarnation
        assert nm._head_incarnation == old_inc
        oid = ObjectID.from_random()
        mv = nm.store.create_buffer(oid, 1024)
        mv[:] = b"x" * 1024
        nm.store.seal(oid)
        nm.rpc_object_batch(None, [("add", oid.binary(), 1024)])
        _wait_until(lambda: head.rpc_object_locations(
            None, oid.binary()), 10, "object never reached the head")

        def fake_lease(lid, actor_host):
            w = WorkerProc(_FakeProc(), uuid.uuid4().hex)
            w.ready.set()
            w.address = f"fake:{lid}"
            w.is_actor_host = actor_host
            lease = Lease(lid, w, {"CPU": 1.0}, "main",
                          lessee=f"head:{old_inc}")
            with nm._lock:
                nm._workers[w.worker_id] = w
                nm._leases[lid] = lease
                nm.available["CPU"] -= 1.0
            return lease

        fake_lease("stale-era", actor_host=False)
        fake_lease("actor-host", actor_host=True)
        port = int(head.address.rsplit(":", 1)[1])
        head.shutdown()
        head2 = HeadServer(port=port)
        try:
            assert head2.incarnation != old_inc
            assert head2.rpc_object_locations(None, oid.binary()) == []
            _wait_until(lambda: head2.rpc_object_locations(
                None, oid.binary()), 20,
                "holder set never republished after head restart")
            _wait_until(lambda: "stale-era" not in nm._leases, 10,
                        "stale head-era lease never reconciled")
            with nm._lock:
                assert "actor-host" in nm._leases
                assert nm.available["CPU"] == 1.0
        finally:
            head2.shutdown()
            head = None
    finally:
        nm.shutdown()
        if head is not None:
            head.shutdown()


def test_pull_survives_severed_holder_connection():
    """Connection loss to the holder on chunk 2 of a pull: the retry
    lap re-fetches and the object arrives intact."""
    import os as _os

    from ray_tpu_torch.cluster.head import HeadServer
    from ray_tpu_torch.core.ids import ObjectID

    head = HeadServer()
    holder = _node(head.address)
    puller = _node(head.address)
    old_chunk = cfg.object_transfer_chunk_bytes
    try:
        oid = ObjectID.from_random()
        data = _os.urandom(3 << 20)
        mv = holder.store.create_buffer(oid, len(data))
        mv[:] = data
        holder.store.seal(oid)
        head.rpc_object_added(None, oid.binary(), holder.node_id,
                              len(data))
        cfg.set("object_transfer_chunk_bytes", 1 << 20)  # 3 chunks
        cfg.set("chaos_plan", "sever:role=node:method=fetch_object:nth=2")
        assert puller.rpc_pull_object(None, oid.binary(), 30000) is True
        buf = puller.store.get(oid, timeout_ms=1000)
        assert bytes(buf.buffer) == data
        buf.release()
    finally:
        cfg.set("chaos_plan", "")
        cfg.set("object_transfer_chunk_bytes", old_chunk)
        puller.shutdown()
        holder.shutdown()
        head.shutdown()


def test_chaos_roles_are_ray_tpus():
    """The head, the node manager, the owner/worker core and the DAG
    peer endpoint declare ray_tpu's fault-injection roles."""
    from ray_tpu_torch.cluster.head import HeadServer
    from ray_tpu_torch.cluster.node_manager import NodeManager
    from ray_tpu_torch.dag.peer import ChannelEndpoint

    assert HeadServer.chaos_role == "head"
    assert NodeManager.chaos_role == "node"
    assert ChannelEndpoint.chaos_role == "channel"


# --------------------------------------------------------------------------
# standing scenarios (subprocess clusters, SIGKILL faults — slow)
# --------------------------------------------------------------------------


@pytest.fixture
def chaos_cluster(request):
    """A port cluster booted under a FIXED chaos plan (the plan and seed
    ride RTPU_CHAOS_PLAN into every spawned process)."""
    import ray_tpu_torch

    plan = request.param

    def boot(num_cpus=2):
        return ray_tpu_torch.init(num_cpus=num_cpus,
                                  _system_config={"chaos_plan": plan,
                                                  "chaos_seed": 42})

    yield boot
    ray_tpu_torch.shutdown()
    cfg.set("chaos_plan", "")


@pytest.mark.slow
@pytest.mark.parametrize(
    "chaos_cluster", ["kill:role=head:method=register_actor:nth=2"],
    indirect=True)
def test_scenario_kill_head_mid_submission(chaos_cluster):
    import numpy as np

    import ray_tpu_torch as rt
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy)

    runtime = chaos_cluster()
    node_b = runtime.add_node(num_cpus=2)
    time.sleep(1.5)

    @rt.remote(scheduling_strategy=NodeAffinitySchedulingStrategy(
        node_id=node_b.node_id, soft=True))
    def produce():
        return np.arange(300_000)

    ref = produce.remote()
    ready, _ = rt.wait([ref], num_returns=1, timeout=90, fetch_local=False)
    assert ready

    @rt.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def inc(self):
            self.n += 1
            return self.n

    old_pid = runtime._head_proc.pid
    c1 = Counter.remote()
    assert rt.get(c1.inc.remote(), timeout=60) == 1
    c2 = Counter.remote()  # registration 2: SIGKILLs the head
    assert rt.get(c2.inc.remote(), timeout=120) == 1
    assert runtime._head_proc.pid != old_pid, "head did not respawn"

    @rt.remote
    def ping(i):
        return i

    assert rt.get([ping.remote(i) for i in range(8)],
                  timeout=120) == list(range(8))
    _wait_until(
        lambda: runtime.head.retrying_call(
            "object_locations", ref.id().binary(), timeout=10),
        30, "holder set never republished to the restarted head")
    got = rt.get(ref, timeout=90)
    assert got[0] == 0 and got[-1] == 299_999
    _assert_leases_drain(runtime, allowed_actor_hosts=2)


@pytest.mark.slow
@pytest.mark.parametrize(
    "chaos_cluster", ["kill:role=node:method=fetch_object:nth=2"],
    indirect=True)
def test_scenario_kill_holder_mid_chunked_pull(chaos_cluster):
    import numpy as np

    import ray_tpu_torch as rt
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy)

    runtime = chaos_cluster()
    node_b = runtime.add_node(num_cpus=2)
    time.sleep(1.5)
    n = 3_000_000

    @rt.remote(scheduling_strategy=NodeAffinitySchedulingStrategy(
        node_id=node_b.node_id, soft=True))
    def produce():
        return np.arange(n)

    ref = produce.remote()
    ready, _ = rt.wait([ref], num_returns=1, timeout=90, fetch_local=False)
    assert ready
    got = rt.get(ref, timeout=120)  # chunk 2 kills the holder mid-pull
    assert got[0] == 0 and got[-1] == n - 1
    assert node_b.proc.poll() is not None, "holder should be dead"
    _assert_leases_drain(runtime, allowed_actor_hosts=0)


@pytest.mark.slow
@pytest.mark.parametrize(
    "chaos_cluster",
    ["drop_response:role=worker:method=kill_actor:count=2"],
    indirect=True)
def test_scenario_dropped_actor_kill_acks(chaos_cluster):
    import ray_tpu_torch as rt
    from ray_tpu_torch.exceptions import ActorDiedError

    runtime = chaos_cluster()

    @rt.remote
    class Svc:
        def ping(self):
            return "pong"

    a = Svc.remote()
    assert rt.get(a.ping.remote(), timeout=60) == "pong"
    rt.kill(a)
    with pytest.raises(ActorDiedError):
        rt.get(a.ping.remote(), timeout=30)
    _assert_leases_drain(runtime, allowed_actor_hosts=0)


@pytest.mark.slow
@pytest.mark.parametrize(
    "chaos_cluster", ["kill:role=head:method=create_pg:nth=2"],
    indirect=True)
def test_scenario_head_restart_with_inflight_pg_and_queued_leases(
        chaos_cluster):
    import ray_tpu_torch as rt
    from ray_tpu_torch.util.placement_group import (placement_group,
                                                    remove_placement_group)
    from ray_tpu_torch.util.scheduling_strategies import (
        PlacementGroupSchedulingStrategy)

    runtime = chaos_cluster(num_cpus=4)
    pg1 = placement_group([{"CPU": 1}], strategy="PACK")
    assert pg1.ready(timeout=60)
    old_pid = runtime._head_proc.pid

    @rt.remote
    def ping(i):
        return i

    refs = [ping.remote(i) for i in range(4)]
    pg2 = placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK")
    assert pg2.ready(timeout=90)
    assert runtime._head_proc.pid != old_pid, "head did not respawn"

    @rt.remote(scheduling_strategy=PlacementGroupSchedulingStrategy(
        placement_group=pg2))
    def inside():
        return "in-pg"

    assert rt.get(inside.remote(), timeout=60) == "in-pg"
    assert rt.get(refs, timeout=120) == list(range(4))
    remove_placement_group(pg2)
    remove_placement_group(pg1)
    _assert_leases_drain(runtime, allowed_actor_hosts=0)


@pytest.fixture
def plain_cluster():
    import ray_tpu_torch

    def boot(num_cpus=2):
        return ray_tpu_torch.init(num_cpus=num_cpus)

    yield boot
    ray_tpu_torch.shutdown()


@pytest.mark.slow
def test_scenario_all_holders_dead_actor(plain_cluster):
    import os
    import signal

    import ray_tpu_torch as rt
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy)

    runtime = plain_cluster()
    node_b = runtime.add_node(num_cpus=2)
    time.sleep(1.5)

    @rt.remote(max_restarts=2, max_task_retries=-1,
               scheduling_strategy=NodeAffinitySchedulingStrategy(
                   node_id=node_b.node_id, soft=True))
    class Svc:
        def __init__(self):
            self.n = 0

        def inc(self):
            self.n += 1
            return self.n

    a = Svc.remote()
    assert rt.get(a.inc.remote(), timeout=60) == 1
    info = runtime.head.retrying_call("get_actor_info",
                                      a._actor_id.binary(), timeout=15)
    assert info["state"] == "ALIVE"
    assert info.get("node_id") in (None, node_b.node_id), (info, node_b)
    head_pid = runtime._head_proc.pid
    node_b.proc.kill()
    os.kill(head_pid, signal.SIGKILL)
    refs = [a.inc.remote() for _ in range(4)]
    vals = rt.get(refs, timeout=180)
    assert vals == [1, 2, 3, 4], vals
    assert runtime._head_proc.pid != head_pid, "head did not respawn"
    info = runtime.head.retrying_call("get_actor_info",
                                      a._actor_id.binary(), timeout=15)
    assert info["state"] == "ALIVE" and info["restarts"] >= 1
    _assert_leases_drain(runtime, allowed_actor_hosts=1)


@pytest.mark.slow
def test_scenario_all_holders_dead_object_while_head_down(plain_cluster):
    import os
    import signal

    import numpy as np

    import ray_tpu_torch as rt
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy)

    runtime = plain_cluster()
    node_b = runtime.add_node(num_cpus=2)
    time.sleep(1.5)
    n = 500_000

    @rt.remote(scheduling_strategy=NodeAffinitySchedulingStrategy(
        node_id=node_b.node_id, soft=True))
    def produce():
        return np.arange(n)

    ref = produce.remote()
    ready, _ = rt.wait([ref], num_returns=1, timeout=90, fetch_local=False)
    assert ready
    head_pid = runtime._head_proc.pid
    os.kill(head_pid, signal.SIGKILL)
    node_b.proc.kill()
    got = rt.get(ref, timeout=180)
    assert got[0] == 0 and got[-1] == n - 1
    assert runtime._head_proc.pid != head_pid, "head did not respawn"
    _assert_leases_drain(runtime, allowed_actor_hosts=0)


@pytest.mark.slow
def test_scenario_node_death_recreates_actor_and_replays_calls(
        plain_cluster):
    import ray_tpu_torch as rt
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy)

    runtime = plain_cluster()
    node_b = runtime.add_node(num_cpus=2)
    time.sleep(1.5)

    @rt.remote(max_restarts=1, max_task_retries=-1,
               scheduling_strategy=NodeAffinitySchedulingStrategy(
                   node_id=node_b.node_id, soft=True))
    class Svc:
        def __init__(self):
            self.n = 0

        def inc(self):
            self.n += 1
            return self.n

    a = Svc.remote()
    assert rt.get(a.inc.remote(), timeout=60) == 1
    refs = [a.inc.remote() for _ in range(6)]
    runtime.kill_node(node_b)
    vals = rt.get(refs, timeout=180)
    assert len(vals) == 6
    assert all(isinstance(v, int) for v in vals), vals
    runs = [vals[i] for i in range(len(vals))
            if i == 0 or vals[i] != vals[i - 1] + 1]
    assert len(runs) <= 2, f"more than one incarnation boundary: {vals}"
    assert rt.get(a.inc.remote(), timeout=60) >= 1
    _wait_until(
        lambda: runtime.head.retrying_call(
            "get_actor_info", a._actor_id.binary(),
            timeout=15)["restarts"] >= 1,
        60, "actor never restarted after node death")
    _assert_leases_drain(runtime, allowed_actor_hosts=1)


@pytest.mark.slow
def test_scenario_rolling_head_upgrade_zero_failures(plain_cluster):
    import ray_tpu_torch as rt

    runtime = plain_cluster()

    @rt.remote
    def ping(i):
        return i

    @rt.remote(max_restarts=1, max_task_retries=-1)
    class Echo:
        def hit(self, i):
            return i

    e = Echo.remote()
    assert rt.get(e.hit.remote(-1), timeout=60) == -1

    def request(i):
        if i % 2:
            assert rt.get(ping.remote(i), timeout=120) == i
        else:
            assert rt.get(e.hit.remote(i), timeout=120) == i

    report = chaos.run_rolling_upgrade(runtime, request, clients=2)
    assert report["request_failures"] == [], report["request_failures"]
    assert report["requests_ok"] > 0
    assert report["new_incarnation"] != report["old_incarnation"]
    assert rt.get(e.hit.remote(99), timeout=60) == 99
    assert rt.get([ping.remote(i) for i in range(4)],
                  timeout=90) == list(range(4))
    _assert_leases_drain(runtime, allowed_actor_hosts=1)


def _assert_leases_drain(runtime, allowed_actor_hosts: int,
                         timeout_s: float = 45.0) -> None:
    """Once the workload drains, every non-actor lease is returned."""
    deadline = time.monotonic() + timeout_s
    last = None
    while time.monotonic() < deadline:
        try:
            census = runtime.head.retrying_call("cluster_leases",
                                                timeout=15)
        except Exception:
            time.sleep(0.5)
            continue
        entries = [v for v in census.values() if isinstance(v, dict)]
        errors = [v["error"] for v in entries if "error" in v]
        leases = [l for v in entries for l in v.get("leases", ())]
        last = (leases, errors)
        non_actor = [l for l in leases if not l.get("is_actor_host")]
        hosts = [l for l in leases if l.get("is_actor_host")]
        if not errors and not non_actor \
                and len(hosts) <= allowed_actor_hosts:
            return
        time.sleep(0.5)
    raise AssertionError(f"leases leaked after drain: {last}")
