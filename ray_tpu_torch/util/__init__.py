"""Utilities over the actor runtime (copies of ``ray_tpu/util``'s
``actor_pool``, ``queue``, ``placement_group``,
``scheduling_strategies``, ``log_monitor``, ``metrics``,
``metrics_agent``, ``tracing``, ``flight_recorder``, ``timeline``,
``state``, ``pubsub``, ``dashboard``, ``multiprocessing``,
``joblib_backend``, ``dask_backend`` and ``microbenchmark``), and
``collective``: the actor-gang collectives
(``ray_tpu/util/collective.py``)."""

from ray_tpu_torch.util import collective

__all__ = ["collective"]
