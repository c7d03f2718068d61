"""Public scheduling strategies.

Parity target: python/ray/util/scheduling_strategies.py in the reference
(PlacementGroupSchedulingStrategy :15, NodeAffinitySchedulingStrategy :41,
NodeLabelSchedulingStrategy :135); ``ray_tpu``'s TPU slice-affinity
strategy has no counterpart here.
"""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch.core.task_spec import (  # noqa: F401 (re-exports)
    NodeAffinitySchedulingStrategy,
    NodeLabelSchedulingStrategy,
)


class PlacementGroupSchedulingStrategy:
    """Route tasks/actors onto a placement group's reserved bundles."""

    def __init__(self, placement_group,
                 placement_group_bundle_index: int = -1,
                 placement_group_capture_child_tasks: bool = False):
        self.placement_group = placement_group
        self.placement_group_bundle_index = placement_group_bundle_index
        self.placement_group_capture_child_tasks = (
            placement_group_capture_child_tasks)
