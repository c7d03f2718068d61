"""The port's actor collectives (``ray_tpu_torch.util.collective``) on its
cluster runtime, and its coordinator against ``ray_tpu``'s.

The cluster cases are the counterparts of ``tests/test_rllib_dqn.py::
test_collective_allreduce_allgather_8_actors`` and
``tests/test_util_shims.py::test_collective_p2p_send_recv`` /
``::test_collective_p2p_same_tag_queues``, on one module cluster
(``ray_tpu_torch.init(num_cpus=4)``). ``ray_tpu``'s own cluster is not
booted: its coordinator (``ray_tpu/util/collective.py:52-179``) is a plain
class, so both coordinators are called in this process, one thread a
rank, on the same seeded numpy parts, and their results must be
bit-equal (values and dtypes).

The rank classes are defined inside the tests: a class at the top of this
module would ship by reference and make the worker import this module,
and JAX with it. Every ``get`` has a timeout; the cluster shuts down in a
``finally``.
"""

import threading
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu.util import collective as jcol
from ray_tpu_torch.util import collective as col


@pytest.fixture(scope="module")
def cluster():
    rt = ray_tpu_torch.init(num_cpus=4, object_store_memory=128 << 20)
    try:
        yield rt
    finally:
        ray_tpu_torch.shutdown()
        for p in rt._procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)


def _gone(name, timeout=30.0):
    """The named actor is no longer registered (within ``timeout``)."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            ray_tpu_torch.get_actor(name)
        except ValueError:
            return True
        time.sleep(0.1)
    return False


def test_collective_allreduce_allgather_8_actors(cluster):
    """Eight rank actors on a 4-CPU node, all calling
    ``init_collective_group`` at once: one coordinator; allreduce,
    allgather, barrier, reducescatter and broadcast as ``ray_tpu``'s test
    checks them."""

    @ray_tpu_torch.remote(num_cpus=0)
    class Rank:
        def __init__(self, rank, world):
            col.init_collective_group(world, rank, "test-gang")
            self.rank = rank

        def run(self):
            out = col.allreduce(np.full(4, self.rank + 1.0), "test-gang")
            gathered = col.allgather(np.array([self.rank]), "test-gang")
            col.barrier("test-gang")
            chunk = col.reducescatter(np.arange(8.0), "test-gang")
            b = col.broadcast(
                np.array([42.0]) if self.rank == 3 else None,
                root=3, group_name="test-gang")
            return (out.tolist(), [g.tolist() for g in gathered],
                    chunk.tolist(), b.tolist())

    world = 8
    ranks = [Rank.remote(i, world) for i in range(world)]
    results = ray_tpu_torch.get([r.run.remote() for r in ranks],
                                timeout=120)
    expected_sum = float(sum(range(1, world + 1)))
    for rank, (red, gathered, chunk, b) in enumerate(results):
        assert red == [expected_sum] * 4
        assert gathered == [[i] for i in range(world)]
        assert chunk == [float(rank) * world]  # sum of 8 copies, split
        assert b == [42.0]
    for r in ranks:
        ray_tpu_torch.kill(r)
    ray_tpu_torch.kill(ray_tpu_torch.get_actor("rtpu-collective-test-gang"))
    assert _gone("rtpu-collective-test-gang")


def test_collective_p2p_send_recv(cluster):

    @ray_tpu_torch.remote(num_cpus=0)
    class Peer:
        def __init__(self, rank):
            col.init_collective_group(2, rank, "p2p-gang")
            self.rank = rank

        def run(self):
            if self.rank == 0:
                col.send(np.arange(4.0), 1, "p2p-gang", tag=7)
                return col.recv(1, "p2p-gang", tag=8).tolist()
            got = col.recv(0, "p2p-gang", tag=7)
            col.send(got * 2, 0, "p2p-gang", tag=8)
            return got.tolist()

    peers = [Peer.remote(i) for i in range(2)]
    r0, r1 = ray_tpu_torch.get([p.run.remote() for p in peers], timeout=120)
    assert r1 == [0.0, 1.0, 2.0, 3.0]
    assert r0 == [0.0, 2.0, 4.0, 6.0]
    for p in peers:
        ray_tpu_torch.kill(p)
    ray_tpu_torch.kill(ray_tpu_torch.get_actor("rtpu-collective-p2p-gang"))


def test_collective_p2p_same_tag_queues(cluster):
    """Back-to-back sends with one tag queue FIFO (no clobber, no hang);
    a CPU tensor travels as its numpy values."""

    @ray_tpu_torch.remote(num_cpus=0)
    class P:
        def __init__(self, rank):
            col.init_collective_group(2, rank, "fifo-gang")
            self.rank = rank

        def run(self):
            if self.rank == 0:
                for i in range(4):
                    col.send(torch.tensor([i]), 1, "fifo-gang")
                return True
            return [int(col.recv(0, "fifo-gang")[0]) for _ in range(4)]

    a, b = P.remote(0), P.remote(1)
    ok, got = ray_tpu_torch.get([a.run.remote(), b.run.remote()],
                                timeout=120)
    assert ok and got == [0, 1, 2, 3]
    for p in (a, b):
        ray_tpu_torch.kill(p)
    ray_tpu_torch.kill(ray_tpu_torch.get_actor("rtpu-collective-fifo-gang"))


def test_group_of_another_size_and_destroy(cluster):
    """A rank that names a live group with another world size is refused;
    rank 0's ``destroy_collective_group`` kills the coordinator, and the
    name can then start a group of any size."""
    col.init_collective_group(1, 0, "size-gang")
    assert col.allreduce(np.ones(2), "size-gang").tolist() == [1.0, 1.0]
    saved = col._GROUPS.pop("size-gang")
    try:
        with pytest.raises(ValueError, match="world_size 1"):
            col.init_collective_group(2, 0, "size-gang")
    finally:
        col._GROUPS["size-gang"] = saved
    col.destroy_collective_group("size-gang")
    assert "size-gang" not in col._GROUPS
    assert _gone("rtpu-collective-size-gang")
    with pytest.raises(RuntimeError, match="no collective group"):
        col.barrier("size-gang")


def test_cuda_payload_refused_before_it_takes_a_sequence_number():
    """A tensor off the host (the meta device stands in for the card
    here) raises TypeError, and the rank's sequence stays where it was: a
    refused op must not put it one op off the others."""
    ctx = col._GroupContext(None, 2, 0)
    col._GROUPS["refuse-gang"] = ctx
    try:
        for call in (lambda: col.allreduce(torch.ones(2, device="meta"),
                                           "refuse-gang"),
                     lambda: col.allreduce_multi(
                         [np.ones(2), torch.ones(2, device="meta")],
                         "refuse-gang"),
                     lambda: col.send(torch.ones(1, device="meta"), 1,
                                      "refuse-gang")):
            with pytest.raises(TypeError, match="copy it to the host"):
                call()
        assert ctx.seq == 0
    finally:
        col._GROUPS.pop("refuse-gang")
    x = torch.arange(3.0, requires_grad=True)
    view = col._host(x)
    assert isinstance(view, np.ndarray) and view.tolist() == [0.0, 1.0, 2.0]


# ------------------------------------------- the coordinator, bit for bit

WORLD = 3


def _run_ranks(coordinator, method, parts, *args):
    """Every rank's call of ``method`` on its part, one thread a rank (the
    handlers block until all ranks arrive); results by rank."""
    out = [None] * WORLD
    errors = []

    def rank(r):
        try:
            out[r] = getattr(coordinator, method)(r, 0, parts[r], *args)
        except BaseException as e:  # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=rank, args=(r,))
               for r in range(WORLD)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    return out


def _equal(got, want):
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape
    assert np.array_equal(got, want), np.abs(got - want).max()


def _parts(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(7, 5))
             * 10.0 ** rng.integers(-3, 4, (7, 5))).astype(dtype)
            for _ in range(WORLD)]


@pytest.mark.parametrize("method,args,dtype", [
    ("allreduce", ("sum",), np.float32),
    ("allreduce", ("mean",), np.float32),
    ("allreduce", ("max",), np.float32),
    ("allreduce", ("min",), np.float32),
    ("allreduce", ("mean",), np.float64),
    ("reducescatter", ("sum",), np.float32),
    ("reducescatter", ("mean",), np.float32),
    ("broadcast", (2,), np.float32),
    ("allgather", (), np.float32),
], ids=lambda v: str(getattr(v, "__name__", v)))
def test_coordinator_bit_equal_to_ray_tpus(method, args, dtype):
    parts = _parts(11, dtype)
    got = _run_ranks(col._Coordinator(WORLD), method, parts, *args)
    want = _run_ranks(jcol._Coordinator(WORLD), method, parts, *args)
    for g, w in zip(got, want):
        _equal(g, w)


@pytest.mark.parametrize("op", ["sum", "mean"])
def test_coordinator_allreduce_list_bit_equal_to_ray_tpus(op):
    """A gradient tree's leaves in one rendezvous: leaves of several
    shapes, a 0-dim one among them."""
    rng = np.random.default_rng(5)
    shapes = [(4, 64), (64,), (64, 2), ()]
    parts = [[rng.normal(size=s).astype(np.float32) for s in shapes]
             for _ in range(WORLD)]
    got = _run_ranks(col._Coordinator(WORLD), "allreduce_list", parts, op)
    want = _run_ranks(jcol._Coordinator(WORLD), "allreduce_list", parts, op)
    for g, w in zip(got, want):
        _equal(g, w)


def test_coordinator_drops_each_op_once_every_rank_took_it():
    c = col._Coordinator(WORLD)
    _run_ranks(c, "allreduce", _parts(1), "sum")
    _run_ranks(c, "reducescatter", _parts(2), "mean")
    assert c._ops == {}
    c.p2p_send(0, 1, 3, np.ones(1))
    c.p2p_send(0, 1, 3, np.zeros(1))
    assert c.p2p_recv(0, 1, 3).tolist() == [1.0]
    assert c.p2p_recv(0, 1, 3).tolist() == [0.0]
    assert c._ops == {}
