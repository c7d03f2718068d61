"""Utilities over the actor runtime (copies of ``ray_tpu/util``'s
``actor_pool``, ``queue``, ``placement_group``,
``scheduling_strategies`` and ``log_monitor``), and ``collective``: the
actor-gang collectives (``ray_tpu/util/collective.py``)."""

from ray_tpu_torch.util import collective

__all__ = ["collective"]
