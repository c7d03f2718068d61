"""Elastic scaling policy for train worker gangs
(``ray_tpu/train/scaling_policy.py``).

Parity target: the reference's Train-v2 scaling policy
(reference: python/ray/train/v2/_internal/execution/scaling_policy/
scaling_policy.py:24 ScalingDecision/:29 ResizeDecision, and the
controller's recovery/resize loop, controller/controller.py:91,436),
re-designed small: the trainer consults the policy (a) when (re)starting a
gang — how many workers are feasible right now — and (b) at report-round
boundaries while running degraded — is there capacity to grow back.

A resize is always a RESTART from the latest checkpoint at the new world
size: a torch process group has a fixed world size, so elasticity operates
between gangs, never within one (the reference restarts its process groups
for the same reason).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import ray_tpu_torch


@dataclasses.dataclass
class NoopDecision:
    pass


@dataclasses.dataclass
class ResizeDecision:
    num_workers: int


class ElasticScalingPolicy:
    """Shrink to what fits (never below ``min_workers``), grow back toward
    ``num_workers`` when capacity returns."""

    def __init__(self, num_workers: int, min_workers: int,
                 worker_resources: Dict[str, float],
                 grow_check_every: int = 1):
        self.num_workers = num_workers
        self.min_workers = max(1, min_workers)
        self.worker_resources = {k: v for k, v in worker_resources.items()
                                 if v > 0}
        self.grow_check_every = max(1, grow_check_every)
        self._rounds_since_check = 0

    # ------------------------------------------------------------ helpers

    def _slots_available(self) -> int:
        """How many ADDITIONAL workers the cluster could host right now."""
        try:
            avail = ray_tpu_torch.available_resources()
        except Exception:
            return 0
        slots = None
        for k, v in self.worker_resources.items():
            have = avail.get(k, 0.0)
            n = int(math.floor(have / v + 1e-9))
            slots = n if slots is None else min(slots, n)
        return slots if slots is not None else 0

    # ------------------------------------------------------------ decisions

    def initial_size(self) -> int:
        """Gang size for a (re)start: everything feasible now, clamped to
        [min_workers, num_workers]. Falls back to min_workers when the
        view says less is available (the lease layer will queue)."""
        slots = self._slots_available()
        return max(self.min_workers, min(self.num_workers, slots))

    def on_round(self, current_size: int):
        """Called at each completed report round. Returns ResizeDecision
        to grow (restart at a larger size) or NoopDecision."""
        if current_size >= self.num_workers:
            return NoopDecision()
        self._rounds_since_check += 1
        if self._rounds_since_check < self.grow_check_every:
            return NoopDecision()
        self._rounds_since_check = 0
        target = min(self.num_workers, current_size + self._slots_available())
        if target > current_size:
            return ResizeDecision(num_workers=target)
        return NoopDecision()


class FixedScalingPolicy:
    """Non-elastic: always the configured size (reference v1 semantics)."""

    def __init__(self, num_workers: int):
        self.num_workers = num_workers

    def initial_size(self) -> int:
        return self.num_workers

    def on_round(self, current_size: int):
        return NoopDecision()
