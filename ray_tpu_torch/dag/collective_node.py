"""Collective nodes in compiled DAGs: allreduce across actor-method outputs
(``ray_tpu/dag/collective_node.py``, the port's own copy).

Parity target: reference ray.experimental.collective.allreduce
(reference: python/ray/experimental/collective/allreduce.py binding
collective ops into a DAG; python/ray/dag/collective_node.py) — redesigned
for this runtime: the collective executes over the SAME channel substrate
the rest of the compiled DAG uses (shm same-node, push-transfer cross-node),
as a binary-tree reduce+broadcast among the participating actors: the
host-tier cross-actor reduction. ``reduce_fn`` keeps ``ray_tpu``'s numpy
ops.

Authoring (mirrors the reference's surface):

    with InputNode() as inp:
        parts = [w.grad.bind(inp) for w in workers]
        reduced = allreduce.bind(parts, op="sum")   # list, one per worker
        outs = [w.apply.bind(r) for w, r in zip(workers, reduced)]
        dag = MultiOutputNode(outs)
"""

from __future__ import annotations

import itertools
from typing import Any, List

from ray_tpu_torch.dag.dag_node import ClassMethodNode, DAGNode

_group_counter = itertools.count()

REDUCE_OPS = ("sum", "prod", "max", "min")


class CollectiveGroupSpec:
    """One collective instance: the participating upstream nodes (one per
    actor) and the reduction op."""

    def __init__(self, upstreams: List[ClassMethodNode], op: str):
        if op not in REDUCE_OPS:
            raise ValueError(f"op must be one of {REDUCE_OPS}, got {op!r}")
        if len(upstreams) < 2:
            raise ValueError("allreduce needs >= 2 participants")
        seen = set()
        for n in upstreams:
            if not isinstance(n, ClassMethodNode):
                raise TypeError(
                    "allreduce participants must be actor-method nodes "
                    f"(got {type(n).__name__})")
            key = n.actor.actor_id.binary()
            if key in seen:
                raise ValueError(
                    "allreduce binds at most one node per actor (the "
                    "reference imposes the same restriction)")
            seen.add(key)
        self.group_id = next(_group_counter)
        self.upstreams = list(upstreams)
        self.op = op
        # Backrefs to every rank's output node, set by bind(): compilation
        # schedules a group ATOMICALLY at its first topo encounter, so it
        # needs all sibling nodes even when only a subset is reachable.
        self.output_nodes: List["CollectiveOutputNode"] = []


class CollectiveOutputNode(DAGNode):
    """Rank r's post-allreduce value: same actor as its upstream, value =
    reduce(op, all upstreams). One per participant."""

    def __init__(self, group: CollectiveGroupSpec, rank: int):
        super().__init__()
        self.group = group
        self.rank = rank
        self.upstream_node = group.upstreams[rank]
        self.actor = self.upstream_node.actor

    def upstream(self) -> List[DAGNode]:
        # Depends on EVERY participant: topo order must place all
        # contributions before any collective output.
        return list(self.group.upstreams)

    def __repr__(self):
        return (f"CollectiveOutputNode(allreduce-{self.group.op} "
                f"rank {self.rank}/{len(self.group.upstreams)})")


class _AllReduce:
    """`allreduce.bind(nodes, op=...)` like the reference module-level API."""

    @staticmethod
    def bind(nodes: List[ClassMethodNode], op: str = "sum"
             ) -> List[CollectiveOutputNode]:
        group = CollectiveGroupSpec(nodes, op)
        group.output_nodes = [CollectiveOutputNode(group, r)
                              for r in range(len(nodes))]
        return list(group.output_nodes)


allreduce = _AllReduce()


def reduce_fn(op: str):
    import numpy as np

    return {
        "sum": np.add, "prod": np.multiply,
        "max": np.maximum, "min": np.minimum,
    }[op]
