"""Per-worker training session: runs the user loop, synchronizes report()
(``ray_tpu/train/session.py``).

Parity target: reference python/ray/train/_internal/session.py (_TrainSession
:112, report :405, module-level fns :672) — the user's
``train_loop_per_worker`` runs on a daemon thread inside a train-worker
actor; each ``report(metrics, checkpoint)`` hands one result to the driver
and blocks until the driver has consumed the previous one (lockstep, queue
depth 1, exactly the reference's backpressure).

`world_size`/`world_rank` are the actor group's coordinates. A loop that
needs a process group gets one from ``TorchTrainer`` (``train/torch.py``).
"""

from __future__ import annotations

import os
import queue
import threading
import traceback
from typing import Any, Dict, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import TrainContextConfig


class _Result:
    __slots__ = ("metrics", "checkpoint_path", "done", "error")

    def __init__(self, metrics=None, checkpoint_path=None, done=False,
                 error=None):
        self.metrics = metrics
        self.checkpoint_path = checkpoint_path
        self.done = done
        self.error = error


class TrainContext:
    """What `ray_tpu_torch.train.get_context()` returns inside a worker."""

    def __init__(self, cfg: TrainContextConfig):
        self._cfg = cfg

    def get_world_size(self) -> int:
        return self._cfg.world_size

    def get_world_rank(self) -> int:
        return self._cfg.world_rank

    def get_node_rank(self) -> int:
        return self._cfg.node_rank

    def get_experiment_name(self) -> str:
        return os.path.basename(self._cfg.experiment_path or "") or "experiment"

    def get_trial_info(self) -> Optional[Dict[str, Any]]:
        return self._cfg.trial_info

    def get_gang_id(self) -> str:
        """Unique per gang start (fresh across restarts/resizes)."""
        return self._cfg.gang_id


class TrainSession:
    """Owns the user-loop thread and the result handoff queue."""

    def __init__(self, train_fn, config: Dict[str, Any],
                 ctx_cfg: TrainContextConfig,
                 checkpoint: Optional[Checkpoint] = None,
                 dataset_shards: Optional[Dict[str, Any]] = None):
        self._train_fn = train_fn
        self._config = config
        self._ctx = TrainContext(ctx_cfg)
        self._ctx_cfg = ctx_cfg
        self._start_checkpoint = checkpoint
        self._dataset_shards = dataset_shards or {}
        # Depth-1 handoff: report() blocks until the driver consumed it.
        self._results: "queue.Queue[_Result]" = queue.Queue(maxsize=1)
        self._finished = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---------------------------------------------------------- lifecycle

    def start(self) -> None:
        def runner():
            global _session
            _session = self
            try:
                takes_config = True
                try:
                    import inspect

                    takes_config = len(
                        inspect.signature(self._train_fn).parameters) > 0
                except (TypeError, ValueError):
                    pass
                if takes_config:
                    self._train_fn(self._config)
                else:
                    self._train_fn()
                self._results.put(_Result(done=True))
            except BaseException as e:  # surfaced to the driver, not lost
                self._results.put(_Result(done=True, error=(
                    e, traceback.format_exc())))
            finally:
                self._finished.set()

        self._thread = threading.Thread(target=runner, daemon=True,
                                        name="train-session")
        self._thread.start()

    def poll(self, timeout: float) -> Optional[_Result]:
        """Driver-side: next result, or None if the loop hasn't reported."""
        try:
            return self._results.get(timeout=timeout)
        except queue.Empty:
            return None

    # ---------------------------------------------------------- loop API

    def report(self, metrics: Dict[str, Any],
               checkpoint: Optional[Checkpoint] = None) -> None:
        self._results.put(_Result(
            metrics=dict(metrics),
            checkpoint_path=checkpoint.path if checkpoint else None))

    def get_checkpoint(self) -> Optional[Checkpoint]:
        return self._start_checkpoint

    def get_context(self) -> TrainContext:
        return self._ctx

    def get_dataset_shard(self, name: str = "train"):
        shard = self._dataset_shards.get(name)
        if shard is None:
            raise KeyError(
                f"no dataset shard named {name!r} was passed to the trainer "
                f"(datasets={list(self._dataset_shards)})")
        return shard

    def iter_device_batches(self, name: str = "train", *,
                            batch_size: Optional[int] = 256,
                            device=None, prefetch_depth: Optional[int] = None):
        """Device ingest for a train loop.

        Yields batches from the named dataset shard already placed on
        ``device`` (default: ``resolve_device(None)``, this worker's
        card, which raises without one) through the shard's own
        ``iter_batches(batch_size=, device_put=, prefetch_depth=)``: a
        ``ray_tpu_torch.data`` shard (a ``StreamSplitIterator`` of
        ``streaming_split``) stages each batch in pinned memory and copies
        it on a side stream ahead of the step. Plain-sequence shards have
        no batch iterator and raise ``TypeError``.
        """
        shard = self.get_dataset_shard(name)
        if not hasattr(shard, "iter_batches"):
            raise TypeError(
                f"dataset shard {name!r} ({type(shard).__name__}) has no "
                "iter_batches; pass a dataset with iter_batches to the "
                "trainer for device ingest")
        if device is None:
            from ray_tpu_torch import resolve_device

            device = resolve_device(None)
        return shard.iter_batches(batch_size=batch_size, device_put=device,
                                  prefetch_depth=prefetch_depth)


# Module-level accessors (the public API surface inside a train loop).
_session: Optional[TrainSession] = None


def _require_session() -> TrainSession:
    if _session is None:
        raise RuntimeError(
            "ray_tpu_torch.train.report()/get_context() may only be called inside "
            "a train_loop_per_worker launched by a Trainer")
    return _session


def report(metrics: Dict[str, Any],
           checkpoint: Optional[Checkpoint] = None) -> None:
    _require_session().report(metrics, checkpoint=checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    return _require_session().get_checkpoint()


def get_context() -> TrainContext:
    return _require_session().get_context()


def get_dataset_shard(name: str = "train"):
    return _require_session().get_dataset_shard(name)


def iter_device_batches(name: str = "train", *,
                        batch_size: Optional[int] = 256,
                        device=None, prefetch_depth: Optional[int] = None):
    return _require_session().iter_device_batches(
        name, batch_size=batch_size, device=device,
        prefetch_depth=prefetch_depth)
