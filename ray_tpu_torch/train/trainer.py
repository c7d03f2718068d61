"""DataParallelTrainer: the user-facing distributed-training entry point
(``ray_tpu/train/trainer.py``; ``ray_tpu``'s ``JaxTrainer``, which it
aliases to this name, has no counterpart here).

Parity target: reference python/ray/train/base_trainer.py (BaseTrainer.fit
:649) + data_parallel_trainer.py (training_loop :429), with the Tune
wrapping removed (the reference runs every fit as a 1-trial Tune experiment;
here Tune layers ON TOP of the trainer instead — same layering as the
reference's Train-v2 controller, controller.py:91).

The fit loop: start worker group -> ship train_loop_per_worker -> consume
lockstep report() rounds (registering checkpoints) -> on worker failure,
restart the group from the latest checkpoint up to
FailureConfig.max_failures times (reference v1 group-restart semantics).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.train.backend_executor import (BackendExecutor,
                                                  TrainWorkerError)
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.checkpoint_manager import CheckpointManager
from ray_tpu_torch.train.config import RunConfig, ScalingConfig


@dataclasses.dataclass
class Result:
    metrics: Optional[Dict[str, Any]]          # final reported metrics (rank 0)
    checkpoint: Optional[Checkpoint]           # latest checkpoint
    path: str                                  # experiment directory
    error: Optional[Exception] = None
    metrics_dataframe: Optional[Any] = None    # history as list-of-dicts
    # Retained checkpoints with their metrics, best-scored first.
    best_checkpoints: List[Any] = dataclasses.field(default_factory=list)


class DataParallelTrainer:
    """Run ``train_loop_per_worker`` on a gang of worker actors, each a
    process of its own (with ``use_gpu``, one that sees its lease's card).

    Usage::

        def loop(config):
            ctx = ray_tpu_torch.train.get_context()
            ... spmd.make_train_step(...) on resolve_device(None) ...
            ray_tpu_torch.train.report({"loss": loss}, checkpoint=ckpt)

        trainer = DataParallelTrainer(
            loop, train_loop_config={...},
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True))
        result = trainer.fit()
    """

    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[Dict[str, Any]] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        datasets: Optional[Dict[str, Any]] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
    ):
        self._train_fn = train_loop_per_worker
        self._config = train_loop_config or {}
        self._scaling = scaling_config or ScalingConfig()
        self._run = run_config or RunConfig()
        self._datasets = datasets or {}
        self._resume_from = resume_from_checkpoint

    # ------------------------------------------------------------ fit

    def _experiment_path(self) -> str:
        base = self._run.storage_path or os.path.join(
            os.path.expanduser("~"), "ray_tpu_torch_results")
        name = self._run.name or f"{self._train_fn.__name__}"
        return os.path.join(base, name)

    def _dataset_shards(self, n: Optional[int] = None
                        ) -> Optional[List[Dict[str, Any]]]:
        """Split every dataset into one shard per worker (data-lite
        integration: Dataset.streaming_split; plain lists fall back to
        round-robin)."""
        if not self._datasets:
            return None
        n = n or self._scaling.num_workers
        per_worker: List[Dict[str, Any]] = [dict() for _ in range(n)]
        for name, ds in self._datasets.items():
            if hasattr(ds, "streaming_split"):
                shards = ds.streaming_split(n)
            elif hasattr(ds, "split"):
                shards = ds.split(n)
            else:  # static sequence: round-robin slices (materialized ONCE —
                # a generator would be exhausted by the first worker's slice)
                items = list(ds)
                shards = [items[i::n] for i in range(n)]
            for i in range(n):
                per_worker[i][name] = shards[i]
        return per_worker

    def fit(self) -> Result:
        path = self._experiment_path()
        os.makedirs(path, exist_ok=True)
        manager = CheckpointManager(path, self._run.checkpoint_config)
        max_failures = self._run.failure_config.max_failures
        failures = 0
        history: List[Dict[str, Any]] = []
        last_metrics: Optional[Dict[str, Any]] = None
        error: Optional[Exception] = None

        from ray_tpu_torch.train.scaling_policy import (
            ElasticScalingPolicy, FixedScalingPolicy, ResizeDecision)

        if self._scaling.min_workers is not None:
            policy = ElasticScalingPolicy(
                self._scaling.num_workers, self._scaling.min_workers,
                self._scaling.worker_resources())
        else:
            policy = FixedScalingPolicy(self._scaling.num_workers)

        forced_size: Optional[int] = None
        while True:
            size = forced_size if forced_size else policy.initial_size()
            forced_size = None
            executor = BackendExecutor(self._scaling, num_workers=size)
            grow_to: Optional[int] = None
            try:
                executor.start()
                start_ckpt = (manager.latest.checkpoint.path if manager.latest
                              else (self._resume_from.path
                                    if self._resume_from else None))
                executor.start_training(
                    self._train_fn, self._config, path,
                    checkpoint_path=start_ckpt,
                    dataset_shards=self._dataset_shards(size))
                while True:
                    round_ = executor.get_next_round()
                    if round_ is None:
                        break
                    last_metrics = round_.metrics[0]
                    history.append(last_metrics)
                    ckpt_path = round_.checkpoint_path()
                    if ckpt_path:
                        manager.register(ckpt_path, last_metrics)
                    decision = policy.on_round(size)
                    if isinstance(decision, ResizeDecision):
                        # Capacity returned: controlled restart at the
                        # larger world size from the latest checkpoint (a
                        # process group has a fixed world size —
                        # elasticity operates between gangs).
                        grow_to = decision.num_workers
                        break
                if grow_to is None:
                    break  # clean finish
                # The grow target was measured while the old gang still
                # held its resources; trust it over a re-probe racing the
                # just-released leases.
                forced_size = grow_to
            except TrainWorkerError as e:
                failures += 1
                if max_failures >= 0 and failures > max_failures:
                    error = e
                    break
                # else: loop — the policy re-sizes to what fits now and
                # the group restarts from manager.latest
            finally:
                executor.shutdown()

        latest = manager.latest
        ranked = sorted(manager.all(), key=manager._score, reverse=True)
        return Result(
            metrics=last_metrics,
            checkpoint=latest.checkpoint if latest else None,
            path=path,
            error=error,
            metrics_dataframe=history,
            best_checkpoints=[(t.checkpoint, t.metrics) for t in ranked],
        )

