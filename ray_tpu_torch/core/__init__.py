"""The core runtime: ids, objects, reference counts, the thread-based
``LocalRuntime`` and the cluster runtime's driver and worker core
(``ClusterRuntime``, ``ClusterCore``, the shm object store); copies of
``ray_tpu/core``'s JAX-free modules."""
