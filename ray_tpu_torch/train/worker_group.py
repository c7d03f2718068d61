"""A gang of train-worker actors with a shared placement group
(``ray_tpu/train/worker_group.py``).

Parity target: reference python/ray/train/_internal/worker_group.py
(WorkerGroup :102, execute :260) — N identical actors created inside one
placement group, with group-wide async/sync call helpers. The hosted
`TrainWorkerActor` runs the user loop via `TrainSession` and is polled for
report() results (reference: the RayTrainWorker + session queue pattern).

A worker leased with ``GPU`` (``ScalingConfig(use_gpu=True)``) is a
process of its own whose ``CUDA_VISIBLE_DEVICES`` the node manager set to
its lease's cards before its first CUDA call, so ``cuda:0`` there is its
own card. ``ray_tpu``'s ``setup_jax_distributed`` has no counterpart: the
process group belongs to ``TorchTrainer``.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import ScalingConfig, TrainContextConfig
from ray_tpu_torch.train.session import TrainSession
from ray_tpu_torch.util.placement_group import (PlacementGroup,
                                                placement_group,
                                                remove_placement_group)
from ray_tpu_torch.util.scheduling_strategies import \
    PlacementGroupSchedulingStrategy


def node_ip() -> str:
    """Route-based discovery: the local address of a route to the
    cluster's head, which is the address the other nodes reach this one on
    (gethostbyname(gethostname()) returns 127.0.1.1 on common /etc/hosts
    layouts). No packet is sent."""
    import socket

    from ray_tpu_torch.core.runtime_context import require_runtime

    head = getattr(require_runtime(), "head_addr", None)
    if not head:
        return "127.0.0.1"   # the in-process runtime: one host
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect((head.rsplit(":", 1)[0], 9))
        return s.getsockname()[0]
    finally:
        s.close()


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class TrainWorkerActor:
    """Hosted inside each train-worker actor process."""

    def __init__(self):
        self._session: Optional[TrainSession] = None

    def node_ip(self) -> str:
        return node_ip()

    def free_port(self) -> int:
        return free_port()

    def start_training(self, train_fn: Callable, config: Dict[str, Any],
                       ctx_cfg: TrainContextConfig,
                       checkpoint_path: Optional[str] = None,
                       dataset_shards: Optional[Dict[str, Any]] = None) -> None:
        ckpt = Checkpoint(checkpoint_path) if checkpoint_path else None
        self._session = TrainSession(train_fn, config, ctx_cfg,
                                     checkpoint=ckpt,
                                     dataset_shards=dataset_shards)
        self._session.start()

    def poll_result(self, timeout: float = 1.0) -> Optional[Dict[str, Any]]:
        """One report()'s payload, {'done': True[, 'error']}, or None yet."""
        assert self._session is not None, "start_training was never called"
        r = self._session.poll(timeout)
        if r is None:
            return None
        if r.done:
            out: Dict[str, Any] = {"done": True}
            if r.error is not None:
                exc, tb = r.error
                out["error"] = f"{type(exc).__name__}: {exc}\n{tb}"
            return out
        return {"done": False, "metrics": r.metrics,
                "checkpoint_path": r.checkpoint_path}

    def run(self, fn: Callable, *args, **kwargs):
        """Execute an arbitrary function in the worker (group-wide setup)."""
        return fn(*args, **kwargs)


def _placeable(res: Dict[str, float], timeout: float) -> bool:
    """Wait up to ``timeout`` s for an alive node whose resources hold one
    worker's bundle ``res``; False if none appears."""
    want = {k: v for k, v in res.items() if v > 0}
    deadline = time.monotonic() + timeout
    while True:
        if any(n["alive"] and all(n["resources"].get(k, 0.0) >= v
                                  for k, v in want.items())
               for n in ray_tpu_torch.nodes()):
            return True
        if time.monotonic() >= deadline:
            return False
        time.sleep(0.2)


class WorkerGroup:
    def __init__(self, scaling: ScalingConfig):
        self._scaling = scaling
        self._pg: Optional[PlacementGroup] = None
        self._workers: List[Any] = []

    @property
    def workers(self) -> List[Any]:
        return self._workers

    def __len__(self) -> int:
        return len(self._workers)

    def start(self, timeout: float = 120.0) -> None:
        """Reserve the gang's placement group and start its actors, or raise
        ``TimeoutError`` within ``timeout``. A bundle no node of the cluster
        can hold (``use_gpu`` on a cluster without ``GPU``) is waited for
        first, up to ``timeout``: the head's placement attempt would block
        the caller past it."""
        res = self._scaling.worker_resources()
        n = self._scaling.num_workers
        if not _placeable(res, timeout):
            raise TimeoutError(
                f"placement group for {n} train workers ({res}) not ready "
                f"within {timeout}s: no node has the resources of one")
        self._pg = placement_group([dict(res) for _ in range(n)],
                                   strategy=self._scaling.placement_strategy)
        if not self._pg.ready(timeout=timeout):
            remove_placement_group(self._pg)
            raise TimeoutError(
                f"placement group for {n} train workers "
                f"({res}) not ready within {timeout}s")
        cls = ray_tpu_torch.remote(TrainWorkerActor)
        self._workers = [
            cls.options(
                num_cpus=res.get("CPU", 0),
                resources={k: v for k, v in res.items() if k != "CPU"},
                scheduling_strategy=PlacementGroupSchedulingStrategy(
                    placement_group=self._pg,
                    placement_group_bundle_index=i),
            ).remote()
            for i in range(n)
        ]
        # Barrier: all actors constructed (surfaces placement failures now).
        ray_tpu_torch.get([w.node_ip.remote() for w in self._workers],
                          timeout=timeout)

    def execute(self, fn: Callable, *args, **kwargs) -> List[Any]:
        return ray_tpu_torch.get(self.execute_async(fn, *args, **kwargs))

    def execute_async(self, fn: Callable, *args, **kwargs) -> List[Any]:
        return [w.run.remote(fn, *args, **kwargs) for w in self._workers]

    def shutdown(self) -> None:
        for w in self._workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        self._workers = []
        if self._pg is not None:
            try:
                remove_placement_group(self._pg)
            except Exception:
                pass
            self._pg = None
