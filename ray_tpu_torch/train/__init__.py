"""ray_tpu_torch.train: distributed training over worker-actor gangs
(``ray_tpu/train/``).

Parity target: the reference's Ray Train surface (python/ray/train/__init__
— Trainer/ScalingConfig/RunConfig/Checkpoint/report/get_context). Each
worker is a process of its own; with ``ScalingConfig(use_gpu=True)`` it
leases ``GPU`` and sees its lease's card alone, and the loop trains there
(``parallel.spmd``). ``TorchTrainer`` joins the gang into one torch
process group (NCCL on cards, gloo otherwise). Checkpoints are trees of
tensors written leaf per file (``save_pytree``); ``spmd.train_state_tree``
and ``spmd.train_state_from_tree`` turn the whole training state into
such a tree and back. ``ray_tpu``'s ``JaxTrainer`` is
``DataParallelTrainer`` here.
"""

from ray_tpu_torch.train.backend_executor import (BackendExecutor,
                                                  TrainWorkerError)
from ray_tpu_torch.train.checkpoint import (Checkpoint, load_pytree,
                                            save_pytree)
from ray_tpu_torch.train.checkpoint_manager import CheckpointManager
from ray_tpu_torch.train.config import (CheckpointConfig, FailureConfig,
                                        RunConfig, ScalingConfig)
from ray_tpu_torch.train.session import (get_checkpoint, get_context,
                                         get_dataset_shard,
                                         iter_device_batches, report)
from ray_tpu_torch.train.trainer import DataParallelTrainer, Result
from ray_tpu_torch.train.torch import TorchTrainer
from ray_tpu_torch.train.huggingface import (RayTrainReportCallback,
                                             TransformersTrainer,
                                             prepare_trainer)
from ray_tpu_torch.train.worker_group import WorkerGroup

__all__ = [
    "BackendExecutor", "Checkpoint", "CheckpointConfig", "CheckpointManager",
    "DataParallelTrainer", "FailureConfig",
    "RayTrainReportCallback", "Result", "RunConfig", "ScalingConfig",
    "TorchTrainer", "TrainWorkerError", "TransformersTrainer",
    "WorkerGroup", "prepare_trainer",
    "get_checkpoint", "get_context", "get_dataset_shard",
    "iter_device_batches", "load_pytree", "report", "save_pytree",
]
