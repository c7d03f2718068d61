"""Utilities over the actor runtime (copies of ``ray_tpu/util``'s
``actor_pool`` and ``queue``)."""
