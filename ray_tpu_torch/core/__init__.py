"""The in-process core runtime: ids, objects, reference counts and the
thread-based ``LocalRuntime`` (copies of ``ray_tpu/core``'s JAX-free
modules). The cluster runtime waits for ROADMAP.md, queue 1, item 9a."""
