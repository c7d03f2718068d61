"""Train configuration dataclasses (``ray_tpu/train/config.py``).

Parity target: reference python/ray/air/config.py (ScalingConfig :170,
RunConfig :614, FailureConfig :563, CheckpointConfig :484) — trimmed to the
fields the runtime acts on. ``use_gpu``/``gpus_per_worker`` lease ``GPU``
for each worker, so a worker process sees its lease's cards alone
(``CUDA_VISIBLE_DEVICES``, set by the node manager) and ``cuda:0`` is its
own card; ``ray_tpu`` leases whole ``TPU`` slots with ``use_tpu``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


@dataclasses.dataclass
class ScalingConfig:
    num_workers: int = 1
    use_gpu: bool = False
    gpus_per_worker: float = 1.0
    cpus_per_worker: float = 1.0
    resources_per_worker: Optional[Dict[str, float]] = None
    placement_strategy: str = "PACK"   # PACK | SPREAD | STRICT_SPREAD
    # Elastic lower bound (reference: train/v2 elastic scaling —
    # ScalingPolicy/ResizeDecision). None = fixed-size gang. When set, the
    # trainer shrinks the gang to what fits (>= min_workers) on failure and
    # grows back toward num_workers when capacity returns; every resize is
    # a restart from the latest checkpoint at the new world size.
    min_workers: Optional[int] = None

    def worker_resources(self) -> Dict[str, float]:
        res = dict(self.resources_per_worker or {})
        res.setdefault("CPU", self.cpus_per_worker)
        if self.use_gpu:
            res.setdefault("GPU", self.gpus_per_worker)
        return res


@dataclasses.dataclass
class FailureConfig:
    # Group-level restarts from the latest checkpoint. <0 means unlimited.
    max_failures: int = 0


@dataclasses.dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = None          # None = keep all
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"        # "max" | "min"


@dataclasses.dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None    # defaults to ~/ray_tpu_torch_results
    failure_config: FailureConfig = dataclasses.field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = dataclasses.field(default_factory=CheckpointConfig)


@dataclasses.dataclass
class TrainContextConfig:
    """Static facts handed to each train worker."""
    world_size: int = 1
    world_rank: int = 0
    node_rank: int = 0
    experiment_path: str = ""
    trial_info: Optional[Dict[str, Any]] = None
    #: unique per gang START (fresh on every restart/resize): backends
    #: needing a per-attempt rendezvous scope key on it (torch DDP).
    gang_id: str = ""
