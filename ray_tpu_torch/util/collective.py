"""Actor-level collectives: allreduce/allgather/broadcast/barrier and
point-to-point over actor gangs (``ray_tpu/util/collective.py``).

Parity target: the reference's ``ray.util.collective`` (reference:
python/ray/util/collective/collective.py — init_collective_group :120,
allreduce :258, allgather :423, reducescatter :472, send/recv :531/:594).
Collectives inside one program on the cards belong to
``torch.distributed`` (``parallel/collectives.py``, NCCL); this module is
the other tier: host-side gangs of independent actors (RL learners, Tune
trials, elastic groups) that reduce without joining one process group.

Implementation, as ``ray_tpu``'s: a per-group coordinator actor gathers
each rank's contribution per operation sequence number, reduces once and
hands every rank the result. This is the Gloo role, not NCCL's: the
payloads are host numpy arrays, and the reductions are ``ray_tpu``'s
numpy arithmetic in the same order, so a reduction here is bit-equal to
``ray_tpu``'s coordinator on the same parts. A CUDA tensor is refused
with ``TypeError`` (copy it to the host first): a silent copy would hide
a device sync in the caller's loop. A CPU tensor is taken as its numpy
view.

The coordinator is a named actor, ``rtpu-collective-<group>``, created
with ``get_if_exists`` so every rank of a gang gets the one the head
registered first, with ``num_cpus=0`` and ``max_concurrency >= world + 2``:
its handlers block until every rank has arrived, so it must serve at least
a whole gang's calls at once.
"""

from __future__ import annotations

import sys
import threading
from typing import Any, Dict, List

import numpy as np

import ray_tpu_torch


class _GroupContext:
    __slots__ = ("coordinator", "world_size", "rank", "seq", "lock")

    def __init__(self, coordinator, world_size: int, rank: int):
        self.coordinator = coordinator
        self.world_size = world_size
        self.rank = rank
        self.seq = 0
        self.lock = threading.Lock()


# Process-wide (not thread-local: an actor with max_concurrency > 1 serves
# its methods from a thread pool, and the gang identity is per process).
# A killed actor's worker process exits, so no entry outlives its rank.
_GROUPS: Dict[str, _GroupContext] = {}


class _Coordinator:
    """Rendezvous + reduce for one collective group. Every op carries a
    sequence number; contributions for the same (op_kind, seq) rendezvous
    together, the reduction computes once, and all ranks read the same
    result; the op is dropped once every rank has taken it. Handlers
    block, so the actor runs with max_concurrency >= the world size."""

    def __init__(self, world_size: int):
        self._world = world_size
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        #: (kind, seq) -> {"parts": {rank: value}, "result": ..., "taken"}
        self._ops: Dict[tuple, Any] = {}

    def world_size(self) -> int:
        return self._world

    def _rendezvous(self, kind: str, seq: int, rank: int, value,
                    finalize, timeout: float = 300.0):
        key = (kind, seq)
        with self._cv:
            op = self._ops.setdefault(key, {"parts": {}, "result": None,
                                            "taken": 0})
            op["parts"][rank] = value
            if len(op["parts"]) == self._world:
                op["result"] = finalize(op["parts"])
                self._cv.notify_all()
            elif not self._cv.wait_for(lambda: op["result"] is not None,
                                       timeout):
                self._ops.pop(key, None)
                raise TimeoutError(
                    f"collective {kind}#{seq}: only {len(op['parts'])}/"
                    f"{self._world} ranks arrived")
            result = op["result"]
            op["taken"] += 1
            if op["taken"] >= self._world:
                self._ops.pop(key, None)  # every rank served: drop the op
            return result

    def _stack(self, parts) -> np.ndarray:
        return np.stack([np.asarray(parts[r]) for r in range(self._world)])

    def allreduce(self, rank: int, seq: int, array, op: str = "sum"):
        def finalize(parts):
            stack = self._stack(parts)
            if op == "sum":
                return stack.sum(axis=0)
            if op == "mean":
                return stack.mean(axis=0)
            if op == "max":
                return stack.max(axis=0)
            if op == "min":
                return stack.min(axis=0)
            raise ValueError(f"unknown reduce op {op!r}")

        return self._rendezvous("allreduce", seq, rank, array, finalize)

    def allreduce_list(self, rank: int, seq: int, arrays: List[Any],
                       op: str = "sum"):
        """Leaf-wise reduce of a list of arrays (a gradient tree's leaves
        in one rendezvous): each rank receives one reduced set."""

        def finalize(parts):
            out = []
            for i in range(len(parts[0])):
                stack = np.stack([np.asarray(parts[r][i])
                                  for r in range(self._world)])
                out.append(stack.mean(axis=0) if op == "mean"
                           else stack.sum(axis=0))
            return out

        return self._rendezvous("allreduce_list", seq, rank, arrays,
                                finalize)

    def allgather(self, rank: int, seq: int, array):
        # No coercion: a value may be a list of ragged arrays.
        return self._rendezvous(
            "allgather", seq, rank, array,
            lambda parts: [parts[r] for r in range(self._world)])

    def reducescatter(self, rank: int, seq: int, array, op: str = "sum"):
        def finalize(parts):
            stack = self._stack(parts)
            red = stack.mean(axis=0) if op == "mean" else stack.sum(axis=0)
            return np.array_split(red, self._world)

        return self._rendezvous("reducescatter", seq, rank, array,
                                finalize)[rank]

    def broadcast(self, rank: int, seq: int, array, root: int = 0):
        return self._rendezvous("broadcast", seq, rank, array,
                                lambda parts: np.asarray(parts[root]))

    def barrier(self, rank: int, seq: int) -> bool:
        self._rendezvous("barrier", seq, rank, None, lambda parts: True)
        return True

    # Point-to-point: a FIFO per (src, dst, tag). send parks the value,
    # recv takes the oldest (blocking); either side may come first.

    def p2p_send(self, src: int, dst: int, tag: int, value) -> bool:
        key = ("p2p", src, dst, tag)
        with self._cv:
            self._ops.setdefault(key, []).append(value)
            self._cv.notify_all()
        return True

    def p2p_recv(self, src: int, dst: int, tag: int,
                 timeout: float = 300.0):
        key = ("p2p", src, dst, tag)
        with self._cv:
            if not self._cv.wait_for(lambda: self._ops.get(key), timeout):
                raise TimeoutError(
                    f"recv from rank {src} (tag {tag}) timed out")
            q = self._ops[key]
            value = q.pop(0)
            if not q:
                del self._ops[key]
            return value


def _host(value):
    """A payload as the coordinator takes it: numpy as is, a CPU tensor as
    its numpy view, a CUDA tensor refused."""
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(value, torch.Tensor):
        if value.device.type != "cpu":
            raise TypeError(
                f"collective payloads are host arrays; got a tensor on "
                f"{value.device}: copy it to the host first (.cpu())")
        return value.detach().numpy()
    return np.asarray(value)


def init_collective_group(world_size: int, rank: int,
                          group_name: str = "default") -> None:
    """Join this process/actor to a named collective gang (reference:
    init_collective_group, collective.py:120). Every rank calls it; the
    first call to reach the head creates the coordinator."""
    if not (0 <= rank < world_size):
        raise ValueError(f"rank {rank} outside [0, {world_size})")
    coordinator = ray_tpu_torch.remote(_Coordinator).options(
        name=f"rtpu-collective-{group_name}", get_if_exists=True,
        num_cpus=0, max_concurrency=max(8, world_size + 2),
    ).remote(world_size)
    ws = ray_tpu_torch.get(coordinator.world_size.remote(), timeout=60)
    if ws != world_size:
        raise ValueError(
            f"group {group_name!r} already exists with world_size {ws}")
    _GROUPS[group_name] = _GroupContext(coordinator, world_size, rank)


def _ctx(group_name: str) -> _GroupContext:
    ctx = _GROUPS.get(group_name)
    if ctx is None:
        raise RuntimeError(
            f"no collective group {group_name!r} in this process: call "
            f"init_collective_group(world_size, rank, group_name) first")
    return ctx


def _op(group_name: str):
    """The group's context and the op's sequence number. Callers check
    their payload first: a refused payload must not take a number, or this
    rank would rendezvous with the others one op off from then on."""
    ctx = _ctx(group_name)
    with ctx.lock:
        seq = ctx.seq
        ctx.seq += 1
    return ctx, seq


def allreduce(tensor, group_name: str = "default", op: str = "sum"):
    """Synchronous allreduce; returns the reduced array."""
    array = _host(tensor)
    ctx, seq = _op(group_name)
    return ray_tpu_torch.get(ctx.coordinator.allreduce.remote(
        ctx.rank, seq, array, op), timeout=600)


def allreduce_multi(tensors: List[Any], group_name: str = "default",
                    op: str = "sum") -> List[np.ndarray]:
    """Allreduce a list of arrays in one rendezvous (one round trip for a
    whole gradient tree's leaves; the coordinator reduces, so each rank
    receives one reduced set, not world_size copies)."""
    flat = [_host(t) for t in tensors]
    ctx, seq = _op(group_name)
    return ray_tpu_torch.get(ctx.coordinator.allreduce_list.remote(
        ctx.rank, seq, flat, op), timeout=600)


def allgather(tensor, group_name: str = "default") -> List[np.ndarray]:
    array = _host(tensor)
    ctx, seq = _op(group_name)
    return ray_tpu_torch.get(ctx.coordinator.allgather.remote(
        ctx.rank, seq, array), timeout=600)


def reducescatter(tensor, group_name: str = "default", op: str = "sum"):
    array = _host(tensor)
    ctx, seq = _op(group_name)
    return ray_tpu_torch.get(ctx.coordinator.reducescatter.remote(
        ctx.rank, seq, array, op), timeout=600)


def broadcast(tensor, root: int = 0, group_name: str = "default"):
    """``tensor`` matters on ``root`` alone (the others may pass None)."""
    array = None if tensor is None else _host(tensor)
    ctx, seq = _op(group_name)
    return ray_tpu_torch.get(ctx.coordinator.broadcast.remote(
        ctx.rank, seq, array, root), timeout=600)


def barrier(group_name: str = "default") -> None:
    ctx, seq = _op(group_name)
    ray_tpu_torch.get(ctx.coordinator.barrier.remote(ctx.rank, seq),
                      timeout=600)


def send(tensor, dst_rank: int, group_name: str = "default",
         tag: int = 0) -> None:
    """Point-to-point send to ``dst_rank`` (reference: collective.send
    :531). Sends with one tag queue in order."""
    array = _host(tensor)
    ctx = _ctx(group_name)
    ray_tpu_torch.get(ctx.coordinator.p2p_send.remote(
        ctx.rank, dst_rank, tag, array), timeout=600)


def recv(src_rank: int, group_name: str = "default", tag: int = 0):
    """Blocking point-to-point receive from ``src_rank`` (reference:
    collective.recv :594)."""
    ctx = _ctx(group_name)
    return ray_tpu_torch.get(ctx.coordinator.p2p_recv.remote(
        src_rank, ctx.rank, tag), timeout=600)


def destroy_collective_group(group_name: str = "default") -> None:
    """Leave the group; rank 0 also kills the coordinator."""
    ctx = _GROUPS.pop(group_name, None)
    if ctx is not None and ctx.rank == 0:
        try:
            ray_tpu_torch.kill(ctx.coordinator)
        except Exception:  # already dead, or the runtime is gone
            pass
