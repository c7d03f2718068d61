"""Experimental cluster utilities: tree broadcast
(``ray_tpu/experimental/__init__.py``).

Parity target: the reference's push-based object distribution
(reference: src/ray/object_manager/object_manager.h:206 Push,
push_manager.h:30) exposed as an explicit broadcast: a 1-GiB object
reaching N nodes costs O(log N) sequential rounds of node-to-node pushes
(each round doubles the holder set) instead of N independent pulls
hammering the single owner node — the shape of the reference's
"broadcast 1 GiB -> 50 nodes" scalability benchmark.
"""

from __future__ import annotations

import math
from typing import List, Optional

import ray_tpu_torch


def broadcast(ref, *, timeout: float = 120.0) -> int:
    """Push the object behind ``ref`` to EVERY alive node's store.
    Returns the number of nodes that now hold it. Binary-tree fan-out:
    every node that has the object pushes to one that doesn't, per round.
    """
    from ray_tpu_torch.core.runtime_context import require_runtime

    rt = require_runtime()
    oid = ref.id()
    nodes = [n for n in rt.head.retrying_call("list_nodes", timeout=10)
             if n["alive"]]
    addr_of = {n["node_id"]: n["address"] for n in nodes}
    # Who has it already?
    have: List[str] = []
    missing: List[str] = []
    for n in nodes:
        if rt._pool.get(n["address"]).call("has_object", oid.binary(),
                                           timeout=10):
            have.append(n["node_id"])
        else:
            missing.append(n["node_id"])
    if not have:
        raise ValueError(
            f"object {oid.hex()[:16]} is not in any node's store (inline "
            "results never enter the object plane; put() it explicitly)")
    rounds = 0
    import time as _time

    deadline = _time.monotonic() + timeout
    while missing and _time.monotonic() < deadline:
        rounds += 1
        pairs = list(zip(have, missing))
        waiters = []
        for src, dst in pairs:
            w = rt._pool.get(addr_of[src]).call_async(
                "push_object", oid.binary(), addr_of[dst],
                int(max(1.0, deadline - _time.monotonic()) * 1000))
            waiters.append((dst, w))
        for dst, w in waiters:
            try:
                ok = w.wait(max(1.0, deadline - _time.monotonic()))
            except Exception:
                ok = False
            if ok:
                have.append(dst)
                missing.remove(dst)
    if missing:
        raise TimeoutError(
            f"broadcast incomplete: {len(missing)} node(s) missing after "
            f"{rounds} rounds")
    return len(have)
