"""Compiled actor DAGs (``ray_tpu_torch.dag``) on the port's cluster
runtime, on the CPU: the counterparts of ``tests/test_dag.py`` (pipeline,
fan-out, pipelined rounds, an error to the driver, normal calls beside
the DAG loop, the ``CpuCommunicator`` ring), of
``tests/test_dag_collective.py`` (allreduce over the channels) and of
``tests/test_dag_crossnode.py::test_dag_same_node_still_uses_shm``, each
asserting what ``ray_tpu``'s test asserts; then one
``TorchHostCommunicator`` round trip of a CPU tensor.

Every ``get`` and ``execute(...).get`` has a timeout; each test kills its
actors, and the fixture shuts the cluster down in a ``finally``.
"""

import os
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.dag import (CpuCommunicator, CrossNodeChannel, InputNode,
                               MultiOutputNode, RingChannel,
                               TorchHostCommunicator, allreduce)
from ray_tpu_torch.dag.collective_node import CollectiveGroupSpec
from ray_tpu_torch.dag.compiled_dag import compile_dag
from ray_tpu_torch.core.config import GLOBAL_CONFIG as cfg

T = 60  # seconds: the bound of every wait below


@pytest.fixture(scope="module")
def ring_dir(tmp_path_factory):
    """The module's own channel directory, for this process and (through
    the environment they inherit) the cluster's workers: the last test
    counts the ring files every test left there."""
    d = str(tmp_path_factory.mktemp("rings"))
    old = os.environ.get("RTPU_DAG_CHANNEL_DIR")
    os.environ["RTPU_DAG_CHANNEL_DIR"] = d
    cfg.set("dag_channel_dir", d)
    try:
        yield d
    finally:
        cfg.set("dag_channel_dir", cfg._flags["dag_channel_dir"].default)
        if old is None:
            os.environ.pop("RTPU_DAG_CHANNEL_DIR", None)
        else:
            os.environ["RTPU_DAG_CHANNEL_DIR"] = old


@pytest.fixture(scope="module")
def cluster(ring_dir):
    rt = ray_tpu_torch.init(num_cpus=8, object_store_memory=128 << 20)
    try:
        yield rt
    finally:
        ray_tpu_torch.shutdown()
        for p in rt._procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)


@pytest.fixture
def actors(cluster):
    """Actors a test creates, killed when it ends."""
    made = []
    yield made
    for a in made:
        ray_tpu_torch.kill(a)


@ray_tpu_torch.remote
class Adder:
    def __init__(self, bias=0):
        self.bias = bias
        self.calls = 0

    def add(self, x):
        self.calls += 1
        return x + self.bias

    def boom(self, x):
        raise ValueError("deliberate")

    def ncalls(self):
        return self.calls


@ray_tpu_torch.remote
class Worker:
    def __init__(self, scale):
        self.scale = scale

    def contrib(self, x):
        return np.asarray(x, dtype=np.float64) * self.scale

    def boom(self, x):
        raise RuntimeError("collective peer failure")

    def stamp(self, v):
        return ("w%d" % self.scale, v)


def _make(actors, cls, *args, **kw):
    a = cls.remote(*args, **kw)
    actors.append(a)
    return a


def _workers(actors, n):
    return [_make(actors, Worker, i + 1) for i in range(n)]


# ------------------------------------------------------------ test_dag.py


def test_linear_pipeline(actors):
    a = _make(actors, Adder, bias=1)
    b = _make(actors, Adder, bias=10)
    with InputNode() as inp:
        dag = b.add.bind(a.add.bind(inp))
    compiled = dag.experimental_compile()
    try:
        for i in range(10):
            assert compiled.execute(i).get(timeout=T) == i + 11
    finally:
        compiled.teardown()


def test_fan_out_multi_output(actors):
    a = _make(actors, Adder, bias=100)
    b = _make(actors, Adder, bias=200)
    with InputNode() as inp:
        dag = MultiOutputNode([a.add.bind(inp), b.add.bind(inp)])
    compiled = dag.experimental_compile()
    try:
        assert compiled.execute(5).get(timeout=T) == [105, 205]
    finally:
        compiled.teardown()


def test_pipelined_rounds_overlap(actors):
    """Submitting several rounds before reading any must work (channel
    capacity pipelining)."""
    a = _make(actors, Adder, bias=2)
    with InputNode() as inp:
        dag = a.add.bind(inp)
    compiled = dag.experimental_compile()
    try:
        refs = [compiled.execute(i) for i in range(6)]
        assert [r.get(timeout=T) for r in refs] == [i + 2 for i in range(6)]
    finally:
        compiled.teardown()


def test_error_propagates_to_driver(actors):
    a = _make(actors, Adder)
    b = _make(actors, Adder, bias=1)
    with InputNode() as inp:
        dag = b.add.bind(a.boom.bind(inp))
    compiled = dag.experimental_compile()
    try:
        with pytest.raises(ValueError, match="deliberate"):
            compiled.execute(1).get(timeout=T)
        # The DAG survives an error round: next round still works...
        with pytest.raises(ValueError, match="deliberate"):
            compiled.execute(2).get(timeout=T)
    finally:
        compiled.teardown()


def test_actor_still_serves_normal_calls(actors):
    a = _make(actors, Adder, bias=3)
    with InputNode() as inp:
        dag = a.add.bind(inp)
    compiled = dag.experimental_compile()
    try:
        assert compiled.execute(1).get(timeout=T) == 4
        # Regular RPC path unaffected by the resident DAG loop.
        assert ray_tpu_torch.get(a.ncalls.remote(), timeout=T) >= 1
    finally:
        compiled.teardown()


@ray_tpu_torch.remote
class RingNode:
    def __init__(self, comm):
        self.comm = comm

    def exchange(self, value):
        nxt = (self.comm.rank() + 1) % self.comm.world_size()
        prv = (self.comm.rank() - 1) % self.comm.world_size()
        self.comm.send(value, nxt)
        return self.comm.recv(prv)

    def kind(self):
        return type(self.comm).__name__


def _close_group(comms):
    """A communicator's rings live as long as its group: remove them."""
    for ch in comms[0]._channels.values():
        ch.close(unlink=True)


def test_cpu_communicator_ring(actors):
    comms = CpuCommunicator.create_group(3)
    nodes = [_make(actors, RingNode, c) for c in comms]
    try:
        out = ray_tpu_torch.get([n.exchange.remote(i)
                                 for i, n in enumerate(nodes)], timeout=T)
    finally:
        _close_group(comms)
    assert out == [2, 0, 1]  # each received its predecessor's value


def test_torch_host_communicator_carries_a_cpu_tensor(actors):
    """A CPU tensor crosses ``TorchHostCommunicator`` as it is (a CUDA one
    would be staged through the host and put back on the card: the card
    test in ``tests/test_torch_cuda.py``)."""
    comms = TorchHostCommunicator.create_group(2)
    nodes = [_make(actors, RingNode, c) for c in comms]
    assert ray_tpu_torch.get([n.kind.remote() for n in nodes],
                             timeout=T) == ["TorchHostCommunicator"] * 2
    ts = [torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * i
          for i in range(2)]
    ts.append(torch.randn(4, 4).to(torch.bfloat16))
    try:
        out = ray_tpu_torch.get([n.exchange.remote(t)
                                 for n, t in zip(nodes, ts[:2])], timeout=T)
        assert torch.equal(out[0], ts[1]) and torch.equal(out[1], ts[0])
        assert all(o.device.type == "cpu" for o in out)
        out = ray_tpu_torch.get([n.exchange.remote(ts[2]) for n in nodes],
                                timeout=T)
    finally:
        _close_group(comms)
    assert all(o.dtype == torch.bfloat16 and torch.equal(
        o.view(torch.int16), ts[2].view(torch.int16)) for o in out)


# ------------------------------------------------- test_dag_collective.py


@pytest.mark.parametrize("n", [2, 3, 4])
def test_allreduce_sum_all_ranks(actors, n):
    """Every rank observes the same reduced value: sum_i (x * (i+1))."""
    ws = _workers(actors, n)
    with InputNode() as inp:
        parts = [w.contrib.bind(inp) for w in ws]
        reduced = allreduce.bind(parts, op="sum")
        dag = MultiOutputNode(reduced)
    compiled = dag.experimental_compile()
    try:
        for x in (1.0, 2.0, -3.5):
            outs = compiled.execute(np.array([x])).get(timeout=T)
            expect = x * sum(i + 1 for i in range(n))
            for o in outs:
                np.testing.assert_allclose(o, [expect])
    finally:
        compiled.teardown()


def test_allreduce_max_feeds_downstream(actors):
    """Reduced values flow into further per-actor binds."""
    ws = _workers(actors, 3)
    with InputNode() as inp:
        parts = [w.contrib.bind(inp) for w in ws]
        reduced = allreduce.bind(parts, op="max")
        outs = [w.stamp.bind(r) for w, r in zip(ws, reduced)]
        dag = MultiOutputNode(outs)
    compiled = dag.experimental_compile()
    try:
        results = compiled.execute(np.array([2.0])).get(timeout=T)
        for (tag, v), scale in zip(results, (1, 2, 3)):
            assert tag == f"w{scale}"
            np.testing.assert_allclose(v, [6.0])  # max over 2,4,6
    finally:
        compiled.teardown()


def test_allreduce_peer_error_propagates_everywhere(actors):
    """One participant raising must surface on every output of that round
    — and the NEXT round still works (no channel slot leaks)."""
    ws = _workers(actors, 3)
    with InputNode() as inp:
        parts = [ws[0].contrib.bind(inp), ws[1].boom.bind(inp),
                 ws[2].contrib.bind(inp)]
        reduced = allreduce.bind(parts, op="sum")
        dag = MultiOutputNode(reduced)
    compiled = dag.experimental_compile()
    try:
        ref = compiled.execute(np.array([1.0]))
        with pytest.raises(RuntimeError, match="collective peer failure"):
            ref.get(timeout=T)
        # Round 2 errors again (same boom), proving seqs stayed aligned.
        ref2 = compiled.execute(np.array([2.0]))
        with pytest.raises(RuntimeError, match="collective peer failure"):
            ref2.get(timeout=T)
    finally:
        compiled.teardown()


def test_two_groups_interleaved_bind_order_no_deadlock(actors):
    """Two concurrent groups whose output nodes are bound in conflicting
    per-actor orders must not deadlock: compilation schedules each group
    atomically at first topo encounter."""
    ws = _workers(actors, 2)
    with InputNode() as inp:
        parts = [w.contrib.bind(inp) for w in ws]
        g1 = allreduce.bind(parts, op="sum")
        parts2 = [w.contrib.bind(inp) for w in ws]
        g2 = allreduce.bind(parts2, op="max")
        # Adversarial output order: w0's g1 before w1's g2 before w0's g2.
        dag = MultiOutputNode([g1[0], g2[1], g2[0], g1[1]])
    compiled = dag.experimental_compile()
    try:
        outs = compiled.execute(np.array([1.0])).get(timeout=30)
        np.testing.assert_allclose(outs[0], [3.0])  # sum of 1,2
        np.testing.assert_allclose(outs[1], [2.0])  # max of 1,2
        np.testing.assert_allclose(outs[2], [2.0])
        np.testing.assert_allclose(outs[3], [3.0])
    finally:
        compiled.teardown()


def test_partial_group_consumption_no_hang(actors):
    """Binding only one rank's reduced output must still run every
    rank's collective op (a skipped sibling would strand the tree)."""
    ws = _workers(actors, 3)
    with InputNode() as inp:
        parts = [w.contrib.bind(inp) for w in ws]
        reduced = allreduce.bind(parts, op="sum")
        dag = reduced[0]  # ranks 1..2 discarded by the driver
    compiled = dag.experimental_compile()
    try:
        out = compiled.execute(np.array([1.0])).get(timeout=30)
        np.testing.assert_allclose(out, [6.0])
    finally:
        compiled.teardown()


def test_allreduce_validation():
    with pytest.raises(ValueError, match=">= 2"):
        CollectiveGroupSpec([object()], "sum")  # too few before type check
    with pytest.raises(ValueError, match="op must be"):
        CollectiveGroupSpec([object(), object()], "avg")


def test_allreduce_rejects_duplicate_actor(actors):
    ws = _workers(actors, 1)
    with InputNode() as inp:
        p1 = ws[0].contrib.bind(inp)
        p2 = ws[0].contrib.bind(inp)
        with pytest.raises(ValueError, match="one node per actor"):
            allreduce.bind([p1, p2], op="sum")


# ----------------------------------------------- test_dag_crossnode.py


def test_dag_same_node_still_uses_shm(cluster, actors):
    from ray_tpu_torch.util.scheduling_strategies import \
        NodeAffinitySchedulingStrategy

    @ray_tpu_torch.remote
    class S:
        def f(self, x):
            return x + 1

    s = S.options(scheduling_strategy=NodeAffinitySchedulingStrategy(
        node_id=cluster.node_id, soft=False)).remote()
    actors.append(s)
    with InputNode() as inp:
        out = s.f.bind(inp)
    dag = compile_dag(out)
    try:
        assert all(not isinstance(c, CrossNodeChannel)
                   for c in dag._output_channels)
        assert all(isinstance(c, RingChannel) and c.transport == "ring"
                   for c in dag._input_channels + dag._output_channels)
        assert dag.execute(41).get(timeout=30) == 42
    finally:
        dag.teardown()


def test_teardown_leaves_no_ring_file(ring_dir, actors):
    """Runs last: once the loops have taken the stop, no ring file of any
    DAG of this module is left in its channel directory, the edges between
    two ops of one actor included (an allreduce's argument comes from its
    own actor's ``contrib``), and the worker processes used that
    directory."""
    ws = _workers(actors, 3)
    with InputNode() as inp:
        parts = [w.contrib.bind(inp) for w in ws]
        dag = MultiOutputNode(allreduce.bind(parts, op="sum"))
    compiled = dag.experimental_compile()
    try:
        np.testing.assert_allclose(
            compiled.execute(np.array([1.0])).get(timeout=T)[0], [6.0])
        assert len(os.listdir(ring_dir)) >= 2 * 2 + 3 + 3
    finally:
        compiled.teardown()
    deadline = time.monotonic() + 10
    while os.listdir(ring_dir) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert os.listdir(ring_dir) == []
