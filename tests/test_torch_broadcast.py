"""The tree broadcast in the port (``ray_tpu_torch/experimental``), as
``tests/test_broadcast.py`` holds ``ray_tpu``'s: on three port nodes, an
object in the shm plane reaches every node's store through the node
managers' ``push_object``, and an inline value is refused."""

import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.experimental import broadcast


@pytest.fixture(scope="module")
def three_nodes():
    rt = ray_tpu_torch.init(num_cpus=2, object_store_memory=128 << 20)
    try:
        rt.add_node(num_cpus=2)
        rt.add_node(num_cpus=2)
        deadline = time.monotonic() + 30
        while len([n for n in rt.nodes() if n["alive"]]) < 3:
            assert time.monotonic() < deadline, "nodes did not register"
            time.sleep(0.2)
        yield rt
    finally:
        ray_tpu_torch.shutdown()


def test_broadcast_reaches_every_node(three_nodes):
    rt = three_nodes
    arr = np.arange(3_000_000, dtype=np.int64)  # 24 MB: the object plane
    ref = ray_tpu_torch.put(arr)
    assert broadcast(ref) == 3
    for node in rt.head.retrying_call("list_nodes", timeout=10):
        assert rt._pool.get(node["address"]).call(
            "has_object", ref.id().binary(), timeout=10), node["node_id"]

    @ray_tpu_torch.remote
    def total(x):
        return int(x.sum())

    outs = ray_tpu_torch.get([total.remote(ref) for _ in range(4)],
                             timeout=120)
    assert all(o == int(arr.sum()) for o in outs)


def test_broadcast_inline_value_rejected(three_nodes):
    ref = ray_tpu_torch.put(42)  # inline: never enters the shm plane
    with pytest.raises(ValueError, match="not in any node's store"):
        broadcast(ref)
