"""Training-step construction and the mesh (``ray_tpu/parallel``).

One card: ``spmd.init_train_state`` -> ``spmd.make_train_step`` ->
step(state, tokens). Over ranks: ``mesh.make_mesh`` / ``mesh.mesh_2d``
build the six-axis ``DeviceMesh`` over the process group,
``spmd.sharded_init`` / ``spmd.shard_params`` place the parameters by the
models' logical-axis tables, and ``spmd.make_train_step(cfg, tx,
mesh=mesh)`` runs the sharded step (``collectives`` holds the
communication); ``pipeline`` is the GPipe schedule over ``pp``."""
