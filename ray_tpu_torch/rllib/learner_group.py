"""LearnerGroup, local only (``ray_tpu/rllib/learner_group.py``).

``num_learners=0`` keeps one learner in-process, the mode every algorithm
of ``ray_tpu`` defaults to. ``num_learners > 0`` is a gang of learner
actors that allreduce gradients between ``compute_grads`` and
``apply_grads`` over ``ray_tpu``'s collective layer; it raises here until
the port has that runtime.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np

from ray_tpu_torch.rllib.env_runner import require_local


class LearnerGroup:
    def __init__(self, learner_factory: Callable, *, num_learners: int = 0,
                 group_name: Optional[str] = None):
        require_local("num_learners", num_learners)
        self._local = learner_factory()

    @property
    def num_learners(self) -> int:
        return 1

    def update_from_batch(self, batch: Dict[str, np.ndarray]
                          ) -> Dict[str, Any]:
        return self._local.update_from_batch(batch)

    def get_weights(self):
        return self._local.get_weights()

    def set_weights(self, w) -> None:
        self._local.set_weights(w)

    def stop(self) -> None:
        pass
