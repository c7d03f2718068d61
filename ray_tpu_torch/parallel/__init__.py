"""Training-step construction (``ray_tpu/parallel``). One card so far:
``spmd.init_train_state`` -> ``spmd.make_train_step`` -> step(state,
tokens). The mesh argument, FSDP and tensor parallelism wait for the
multi-chip slice (ROADMAP)."""
