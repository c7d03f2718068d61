"""The port's autoscaler (``ray_tpu_torch/autoscaler``), as
``tests/test_autoscaler.py`` holds ``ray_tpu``'s: unmet demand scales a
port cluster up, idle nodes reap, reaps go through the provider,
``max_nodes`` holds, bin-packing absorbs several demands a node; then the
port's decisions against ``ray_tpu``'s ``Autoscaler`` on the same fake
head and provider (no cluster of ``ray_tpu`` boots here).
"""

import copy
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.autoscaler import (Autoscaler, AutoscalerConfig,
                                      LocalNodeProvider)


@pytest.fixture
def cluster():
    rt = ray_tpu_torch.init(num_cpus=2, object_store_memory=128 << 20)
    try:
        yield rt
    finally:
        ray_tpu_torch.shutdown()


def test_infeasible_demand_triggers_scale_up_then_idle_reap(cluster):
    provider = LocalNodeProvider(cluster, node_types={"cpu": {"CPU": 4.0}})
    scaler = Autoscaler(cluster, provider, AutoscalerConfig(
        max_nodes=4, idle_timeout_s=3.0, demand_window_s=20.0))

    @ray_tpu_torch.remote(num_cpus=4)
    def big():
        import time as t

        t.sleep(1.0)
        return ray_tpu_torch.get_runtime_context().node_id

    refs = [big.remote() for _ in range(2)]
    deadline = time.monotonic() + 30
    launched = []
    while time.monotonic() < deadline and not launched:
        time.sleep(1.0)
        launched = scaler.step()["launched"]
    assert launched, "no scale-up despite infeasible demand"
    nids = ray_tpu_torch.get(refs, timeout=120)
    assert len(provider.non_terminated_nodes()) >= 1
    assert set(nids) <= set(provider.non_terminated_nodes()), \
        "tasks did not run on autoscaled nodes"
    deadline = time.monotonic() + 60
    reaped = []
    while time.monotonic() < deadline and provider.non_terminated_nodes():
        time.sleep(1.0)
        reaped += scaler.step()["reaped"]
    assert reaped, "idle autoscaled node was never reaped"
    assert not provider.non_terminated_nodes()


class _FakeHead:
    """Head stub: serves a canned get_demand state, records drains."""

    def __init__(self, state):
        self.state = state
        self.drained = []

    def retrying_call(self, method, *args, timeout=None):
        if method == "get_demand":
            return self.state
        if method == "drain_node":
            # Like the real head: a drained node leaves the node table.
            self.drained.append(args[0])
            self.state["nodes"] = [n for n in self.state["nodes"]
                                   if n["node_id"] != args[0]]
            return None
        raise AssertionError(method)


class _FakeRT:
    def __init__(self, state):
        self.head = _FakeHead(state)


class _MockProvider:
    """Provider stub: tracks nodes in a set; terminate can be failed;
    create_node records the type and names the node after it."""

    def __init__(self, nodes, node_types=None, fail_terminate=False):
        self.node_types = node_types or {"cpu": {"CPU": 4.0}}
        self.nodes = set(nodes)
        self.fail_terminate = fail_terminate
        self.terminated = []
        self.created = []

    def create_node(self, node_type):
        pid = f"{node_type}-{len(self.created)}"
        self.created.append(node_type)
        self.nodes.add(pid)
        return pid

    def terminate_node(self, pid):
        if self.fail_terminate:
            raise RuntimeError("cloud API error")
        self.nodes.discard(pid)
        self.terminated.append(pid)

    def non_terminated_nodes(self):
        return sorted(self.nodes)


def _idle_state(node_ids):
    return {
        "unmet": [],
        "nodes": [{"node_id": nid, "alive": True,
                   "resources": {"CPU": 4.0}, "available": {"CPU": 4.0},
                   "labels": {}} for nid in node_ids],
    }


def test_reap_terminates_via_provider_deterministic():
    rt = _FakeRT(_idle_state(["n1"]))
    provider = _MockProvider(["n1"])
    scaler = Autoscaler(rt, provider, AutoscalerConfig(
        max_nodes=4, min_nodes=0, idle_timeout_s=0.0))
    scaler._managed["n1"] = None
    did = scaler.step()
    assert did["reaped"] == ["n1"]
    assert provider.non_terminated_nodes() == []
    assert rt.head.drained == ["n1"]


def test_reap_not_reported_when_provider_terminate_fails():
    rt = _FakeRT(_idle_state(["n1"]))
    provider = _MockProvider(["n1"], fail_terminate=True)
    scaler = Autoscaler(rt, provider, AutoscalerConfig(
        max_nodes=4, min_nodes=0, idle_timeout_s=0.0))
    scaler._managed["n1"] = None
    did = scaler.step()
    assert did["reaped"] == []
    assert provider.non_terminated_nodes() == ["n1"]
    provider.fail_terminate = False
    did = scaler.step()
    assert did["reaped"] == ["n1"]
    assert provider.non_terminated_nodes() == []


def test_scale_up_respects_max_nodes(cluster):
    provider = LocalNodeProvider(cluster, node_types={"cpu": {"CPU": 4.0}})
    scaler = Autoscaler(cluster, provider,
                        AutoscalerConfig(max_nodes=2, max_launch_per_step=8))

    @ray_tpu_torch.remote(num_cpus=4)
    def big():
        import time as t

        t.sleep(0.2)
        return 1

    refs = [big.remote() for _ in range(12)]
    time.sleep(1.0)
    scaler.step()
    time.sleep(1.0)
    scaler.step()
    # The head node counts toward the total the scaler clamps against.
    assert len(provider.non_terminated_nodes()) <= 2
    ray_tpu_torch.get(refs, timeout=180)


def test_bin_packing_absorbs_multiple_demands_per_node(cluster):
    provider = LocalNodeProvider(cluster, node_types={"cpu": {"CPU": 4.0}})
    scaler = Autoscaler(cluster, provider, AutoscalerConfig(max_nodes=8))

    @ray_tpu_torch.remote(num_cpus=2)
    def mid():
        import time as t

        t.sleep(1.5)
        return 1

    refs = [mid.remote() for _ in range(5)]
    time.sleep(2.5)
    did = scaler.step()
    assert 1 <= len(did["launched"]) <= 3, did
    ray_tpu_torch.get(refs, timeout=120)


# ------------------------------------------ against ray_tpu's decisions


def _node(nid, total, avail, labels=None, alive=True):
    return {"node_id": nid, "alive": alive, "resources": dict(total),
            "available": dict(avail), "labels": dict(labels or {})}


_TYPES = {"cpu4": {"CPU": 4.0},
          "gpu1": {"CPU": 8.0, "GPU": 1.0, "machine_type": "a3-highgpu-1g",
                   "_labels": {"accelerator-type": "H100"}},
          "gpu8": {"CPU": 8.0, "GPU": 8.0, "machine_type": "a3-highgpu-8g"}}

#: (state, managed provider nodes, config): scale-up and reap cases.
_CASES = {
    "cpu-bin-pack": (
        {"unmet": [{"CPU": 2.0}] * 5,
         "nodes": [_node("head", {"CPU": 2.0}, {"CPU": 0.0})]},
        [], dict(max_nodes=8)),
    "gpu-label-demand": (
        {"unmet": [{"GPU": 1.0, "_labels": {"accelerator-type": "H100"}},
                   {"GPU": 4.0}, {"GPU": 1.0}],
         "nodes": [_node("head", {"CPU": 4.0}, {"CPU": 4.0})]},
        [], dict(max_nodes=8)),
    "existing-capacity-absorbs": (
        {"unmet": [{"CPU": 1.0}, {"GPU": 0.5}],
         "nodes": [_node("head", {"CPU": 2.0}, {"CPU": 2.0}),
                   _node("g", {"GPU": 1.0}, {"GPU": 1.0})]},
        [], dict(max_nodes=8)),
    "max-nodes-caps": (
        {"unmet": [{"CPU": 4.0}] * 6,
         "nodes": [_node("head", {"CPU": 2.0}, {"CPU": 0.0})]},
        [], dict(max_nodes=3, max_launch_per_step=8)),
    "launch-per-step-caps": (
        {"unmet": [{"CPU": 4.0}] * 6, "nodes": []},
        [], dict(max_nodes=10, max_launch_per_step=2)),
    "reap-idle-above-floor": (
        {"unmet": [],
         "nodes": [_node("n1", {"CPU": 4.0}, {"CPU": 4.0}),
                   _node("n2", {"CPU": 4.0}, {"CPU": 3.0}),
                   _node("n3", {"GPU": 1.0}, {"GPU": 1.0})]},
        ["n1", "n2", "n3"], dict(min_nodes=1, idle_timeout_s=0.0)),
    "reap-stops-at-min-nodes": (
        {"unmet": [],
         "nodes": [_node("n1", {"CPU": 4.0}, {"CPU": 4.0}),
                   _node("n2", {"CPU": 4.0}, {"CPU": 4.0})]},
        ["n1", "n2"], dict(min_nodes=1, idle_timeout_s=0.0)),
    "dead-node-not-reaped": (
        {"unmet": [],
         "nodes": [_node("n1", {"CPU": 4.0}, {"CPU": 4.0}, alive=False)]},
        ["n1"], dict(min_nodes=0, idle_timeout_s=0.0)),
}


def _decide(autoscaler_mod, state, managed, config):
    rt = _FakeRT(copy.deepcopy(state))
    provider = _MockProvider(managed, node_types=copy.deepcopy(_TYPES))
    scaler = autoscaler_mod.Autoscaler(
        rt, provider, autoscaler_mod.AutoscalerConfig(**config))
    for pid in managed:
        scaler._managed[pid] = None
    did = scaler.step()
    return did, provider.created, provider.terminated, rt.head.drained


@pytest.mark.parametrize("case", sorted(_CASES))
def test_decisions_equal_ray_tpus(case):
    """The same demand, nodes and provider give the same launches (by
    type, in order), reaps, drains and terminations in both packages."""
    from ray_tpu.autoscaler import autoscaler as ref

    from ray_tpu_torch.autoscaler import autoscaler as port

    state, managed, config = _CASES[case]
    got = _decide(port, state, managed, config)
    want = _decide(ref, state, managed, config)
    assert got == want
    assert got[0]["launched"] or got[0]["reaped"] or case.startswith(
        ("existing", "dead"))
