"""Pubsub from any process and the versioned delta resource sync in the
port (``ray_tpu_torch/util/pubsub.py`` over the head's ``subscribe`` /
``publish``), as ``tests/test_pubsub_syncer.py`` holds ``ray_tpu``'s:
a round trip, a task publishing to the driver, the NODE channel, the
heartbeat delta protocol against the port's head, and the scheduler's
view under delta heartbeats."""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.util import pubsub


@pytest.fixture(scope="module")
def cluster():
    rt = ray_tpu_torch.init(num_cpus=4, object_store_memory=128 << 20,
                            ignore_reinit_error=True)
    try:
        yield rt
    finally:
        ray_tpu_torch.shutdown()


def _wait_for(cond, timeout=10.0):
    deadline = time.time() + timeout
    while not cond() and time.time() < deadline:
        time.sleep(0.05)
    return cond()


def test_publish_subscribe_roundtrip(cluster):
    got = []
    sub = pubsub.subscribe("t-chan", got.append)
    try:
        pubsub.publish("t-chan", {"k": 1})
        assert _wait_for(lambda: got)
        assert got == [{"k": 1}]
    finally:
        sub.unsubscribe()
    pubsub.publish("t-chan", {"k": 2})
    time.sleep(0.5)
    assert got == [{"k": 1}]


def test_worker_side_publish(cluster):
    got = []
    sub = pubsub.subscribe("from-worker", got.append)
    try:
        @ray_tpu_torch.remote
        def announce(v):
            from ray_tpu_torch.util import pubsub as p

            p.publish("from-worker", {"value": v})
            return True

        assert ray_tpu_torch.get(announce.remote(42), timeout=60)
        assert _wait_for(lambda: got)
        assert got == [{"value": 42}]
    finally:
        sub.unsubscribe()


def test_node_membership_channel(cluster):
    events = []
    sub = pubsub.subscribe("NODE", events.append)
    try:
        node = cluster.add_node(num_cpus=1)
        assert _wait_for(lambda: any(e.get("event") == "added"
                                     for e in events), 30), events
        cluster.remove_node(node)
        assert _wait_for(lambda: any(e.get("event") == "removed"
                                     for e in events), 30), events
    finally:
        sub.unsubscribe()


def test_heartbeat_delta_protocol_unit():
    """Full snapshot, in-order delta, version-gap NACK, resync, against
    the port's head handler."""
    from ray_tpu_torch.cluster.head import HeadServer

    head = HeadServer(port=0)

    def view():
        return [n for n in head.rpc_list_nodes(None)
                if n["node_id"] == "n1"][0]["available"]

    try:
        head.rpc_register_node(None, "n1", "127.0.0.1:1", {"CPU": 4.0},
                               {}, "store")
        assert head.rpc_heartbeat(None, "n1", {"CPU": 4.0}, 0, False) is True
        assert head.rpc_heartbeat(None, "n1", {"CPU": 2.0}, 1, True) is True
        assert view() == {"CPU": 2.0}
        assert head.rpc_heartbeat(None, "n1", {"CPU": 1.0}, 5, True) \
            == "resync"
        assert view() == {"CPU": 2.0}
        assert head.rpc_heartbeat(None, "n1", {"CPU": 1.0, "GPU": 8.0},
                                  5, False) is True
        assert view() == {"CPU": 1.0, "GPU": 8.0}
        assert head.rpc_heartbeat(None, "n1", {"GPU": 4.0}, 6, True) is True
        assert view() == {"CPU": 1.0, "GPU": 4.0}
    finally:
        head.shutdown()


def test_scheduler_sees_delta_synced_resources(cluster):
    @ray_tpu_torch.remote
    def hold(t):
        import time as _t

        _t.sleep(t)
        return 1

    refs = [hold.remote(1.0) for _ in range(4)]
    assert ray_tpu_torch.get(refs, timeout=60) == [1] * 4
    assert _wait_for(lambda: ray_tpu_torch.available_resources()
                     .get("CPU", 0) >= 4.0, 15)
