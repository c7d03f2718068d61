"""Drives a WorkerGroup through one training run: start, poll, finish
(``ray_tpu/train/backend_executor.py``).

Parity target: reference python/ray/train/_internal/backend_executor.py
(BackendExecutor :142 start, :458 start_training, :585 get_next_results).
The result loop enforces the reference's lockstep semantics: every worker
must produce its next report() before the round is delivered, and a dead
worker raises TrainWorkerError for the failure policy upstream.

``ray_tpu``'s ``jax.distributed`` join has no counterpart here: a torch
process group is set up by ``TorchTrainer``'s wrapper of the user loop,
inside the workers (``train/torch.py``).
"""

from __future__ import annotations

import dataclasses
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.exceptions import ActorDiedError, GetTimeoutError
from ray_tpu_torch.train.config import ScalingConfig, TrainContextConfig
from ray_tpu_torch.train.worker_group import WorkerGroup


class TrainWorkerError(RuntimeError):
    """A train worker died or its loop raised; carries the worker rank."""

    def __init__(self, rank: int, cause: str):
        super().__init__(f"train worker {rank} failed: {cause}")
        self.rank = rank
        self.cause = cause


class ReportRound:
    """One synchronized report() across the group (list indexed by rank)."""

    def __init__(self, results: List[Dict[str, Any]]):
        self.results = results

    @property
    def metrics(self) -> List[Dict[str, Any]]:
        return [r["metrics"] for r in self.results]

    def checkpoint_path(self) -> Optional[str]:
        for r in self.results:
            if r.get("checkpoint_path"):
                return r["checkpoint_path"]
        return None


class BackendExecutor:
    def __init__(self, scaling: ScalingConfig,
                 num_workers: Optional[int] = None):
        if num_workers is not None and num_workers != scaling.num_workers:
            scaling = dataclasses.replace(scaling, num_workers=num_workers)
        self._scaling = scaling
        self._group: Optional[WorkerGroup] = None

    @property
    def worker_group(self) -> WorkerGroup:
        assert self._group is not None, "start() first"
        return self._group

    def start(self) -> None:
        self._group = WorkerGroup(self._scaling)
        self._group.start()

    def start_training(self, train_fn: Callable, config: Dict[str, Any],
                       experiment_path: str,
                       checkpoint_path: Optional[str] = None,
                       dataset_shards: Optional[List[Dict[str, Any]]] = None,
                       ) -> None:
        gang_id = uuid.uuid4().hex[:12]  # fresh per gang start
        n = len(self._group.workers)
        waits = []
        for rank, w in enumerate(self._group.workers):
            ctx = TrainContextConfig(
                world_size=n, world_rank=rank, node_rank=rank,
                experiment_path=experiment_path, gang_id=gang_id)
            shards = dataset_shards[rank] if dataset_shards else None
            waits.append(w.start_training.remote(
                train_fn, config, ctx, checkpoint_path, shards))
        ray_tpu_torch.get(waits)

    def get_next_round(self, timeout: Optional[float] = None,
                       poll_interval: float = 2.0) -> Optional[ReportRound]:
        """Block until every worker reports (one lockstep round).

        Returns None when all workers finished cleanly; raises
        TrainWorkerError on the first worker death/user exception.
        """
        n = len(self._group.workers)
        slots: List[Optional[Dict[str, Any]]] = [None] * n
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            pending = [i for i in range(n) if slots[i] is None]
            if not pending:
                break
            # One in-flight poll per pending worker, consumed together — a
            # straggler never head-of-line-blocks fetching the others.
            polls = [(i, self._group.workers[i].poll_result.remote(
                poll_interval)) for i in pending]
            for i, ref in polls:
                try:
                    r = ray_tpu_torch.get(ref, timeout=poll_interval + 30)
                except ActorDiedError as e:
                    raise TrainWorkerError(i, f"actor died: {e}") from e
                except GetTimeoutError as e:
                    raise TrainWorkerError(i, "poll_result hung") from e
                if r is not None:
                    if r.get("done") and r.get("error"):
                        raise TrainWorkerError(i, r["error"])
                    slots[i] = r
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("workers did not report in time")
        if all(s.get("done") for s in slots):
            return None
        if any(s.get("done") for s in slots):
            # Mixed finish/report: some loops report more often than others.
            done = [i for i, s in enumerate(slots) if s.get("done")]
            raise TrainWorkerError(
                done[0], "worker finished while peers still report() — "
                "train loops must call report() the same number of times")
        return ReportRound(slots)  # type: ignore[arg-type]

    def shutdown(self) -> None:
        if self._group is not None:
            self._group.shutdown()
            self._group = None
