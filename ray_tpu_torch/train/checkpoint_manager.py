"""Driver-side checkpoint registry: ordering, scoring, top-k retention
(a copy of ``ray_tpu/train/checkpoint_manager.py``).

Parity target: reference python/ray/train/_internal/checkpoint_manager.py
(register_checkpoint, top-k pruning by score attribute) with the storage
layout of _internal/storage.py collapsed to a plain directory tree:

    <storage_path>/<experiment_name>/checkpoint_<index>/
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import CheckpointConfig


class TrackedCheckpoint:
    def __init__(self, checkpoint: Checkpoint, index: int,
                 metrics: Dict[str, Any]):
        self.checkpoint = checkpoint
        self.index = index
        self.metrics = metrics


class CheckpointManager:
    def __init__(self, experiment_path: str, config: CheckpointConfig):
        self._dir = experiment_path
        self._cfg = config
        self._checkpoints: List[TrackedCheckpoint] = []
        self._next_index = 0
        os.makedirs(self._dir, exist_ok=True)
        self._restore_existing()

    # ------------------------------------------------------------ restore

    def _restore_existing(self) -> None:
        """Re-index checkpoints already on disk (job resume)."""
        found: List[Tuple[int, str]] = []
        for name in os.listdir(self._dir):
            if name.startswith("checkpoint_"):
                try:
                    found.append((int(name.split("_", 1)[1]),
                                  os.path.join(self._dir, name)))
                except ValueError:
                    continue
        for idx, path in sorted(found):
            metrics = {}
            mpath = os.path.join(path, ".metrics.json")
            if os.path.exists(mpath):
                with open(mpath) as f:
                    metrics = json.load(f)
            self._checkpoints.append(
                TrackedCheckpoint(Checkpoint(path), idx, metrics))
            self._next_index = idx + 1

    # ------------------------------------------------------------ register

    def register(self, source_path: str,
                 metrics: Dict[str, Any]) -> TrackedCheckpoint:
        """Move a worker-produced checkpoint dir into the experiment tree
        (the source is CONSUMED — leaving it would leak one model copy in
        /tmp per report)."""
        idx = self._next_index
        self._next_index += 1
        dest = os.path.join(self._dir, f"checkpoint_{idx:06d}")
        if os.path.abspath(source_path) != dest:
            try:
                shutil.move(source_path, dest)
            except OSError:  # cross-device or source not removable: copy
                shutil.copytree(source_path, dest, dirs_exist_ok=True)
                shutil.rmtree(source_path, ignore_errors=True)
        with open(os.path.join(dest, ".metrics.json"), "w") as f:
            json.dump(_json_safe(metrics), f)
        tracked = TrackedCheckpoint(Checkpoint(dest), idx, metrics)
        self._checkpoints.append(tracked)
        self._prune()
        return tracked

    def _score(self, t: TrackedCheckpoint) -> float:
        attr = self._cfg.checkpoint_score_attribute
        if attr is None:
            return float(t.index)  # recency
        if attr not in t.metrics:
            return float("-inf")   # unscored ranks worst under either order
        v = float(t.metrics[attr])
        return v if self._cfg.checkpoint_score_order == "max" else -v

    def _prune(self) -> None:
        k = self._cfg.num_to_keep
        if k is None or len(self._checkpoints) <= k:
            return
        ranked = sorted(self._checkpoints, key=self._score, reverse=True)
        keep = set(id(t) for t in ranked[:k])
        # Never delete the newest checkpoint — it is the resume point.
        keep.add(id(self._checkpoints[-1]))
        survivors = []
        for t in self._checkpoints:
            if id(t) in keep:
                survivors.append(t)
            else:
                shutil.rmtree(t.checkpoint.path, ignore_errors=True)
        self._checkpoints = survivors

    # ------------------------------------------------------------ queries

    @property
    def latest(self) -> Optional[TrackedCheckpoint]:
        return self._checkpoints[-1] if self._checkpoints else None

    @property
    def best(self) -> Optional[TrackedCheckpoint]:
        if not self._checkpoints:
            return None
        return max(self._checkpoints, key=self._score)

    def all(self) -> List[TrackedCheckpoint]:
        return list(self._checkpoints)


def _json_safe(d: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in d.items():
        try:
            json.dumps(v)
            out[k] = v
        except (TypeError, ValueError):
            out[k] = repr(v)
    return out
