"""The port's runtime witnesses, its chaos harness and its static lint
(``ray_tpu/devtools``).

The static half is ``python -m ray_tpu_torch.devtools.lint``: ``ast``
passes over ``ray_tpu_torch/`` and ``chip_smoke.py`` against
``lint_baseline.json``, in five rule families (``concurrency``,
``torch`` in place of ``ray_tpu``'s ``jax``, ``dist``, ``res``,
``chan``; tables in ``invariants.py``). It imports neither torch nor the
runtime and needs no card.

Each witness is off unless its environment flag is set, and costs one
environment read where it is off; spawned cluster processes inherit the
flags. The flag names are ``ray_tpu``'s where the meaning is the same:

- ``res_debug`` (``RTPU_DEBUG_RES=1``): the acquire/release seams
  (buffer leases, node leases, KV speculation, fleet page transfers,
  parked KV, QoS tenant lanes, stream cursors, channel rings, spills and
  sockets, data queues and operators, tracked threads) become a
  per-process balance registry, asserted drained at engine and cluster
  close and snapshotted into every flight-recorder dump.
- ``lock_debug`` (``RTPU_DEBUG_LOCKS=1``): the runtime's named locks
  (``make_lock``/``make_rlock``) record the acquisition-order graph,
  report order cycles online and count long holds.
- ``rpc_debug`` (``RTPU_DEBUG_RPC=1``): every dispatched RPC method must
  be classified in ``cluster/protocol.py``; idempotent requests are
  delivered twice and their replies compared; object-directory outbox
  frames carry per-sender sequence stamps checked on arrival.
- ``chan_debug`` (``RTPU_DEBUG_CHAN=1``): the DAG channels' frame
  streams (seqs, credit, cursors, sampled checksums, Lamport clocks,
  spill pins) are checked per edge; the ring and peer records carry the
  witness fields, which are 0 with the flag off.
- ``cuda_debug`` (``RTPU_DEBUG_CUDA=1``, the counterpart of
  ``ray_tpu``'s ``jax_debug``): the engine's device programs and the
  train step count distinct signatures against their budgets, the
  engine's one fetch is counted per tag, and under
  ``RTPU_DEBUG_CUDA_SYNC=error`` every engine tick runs under
  ``torch.cuda.set_sync_debug_mode``.
- ``chaos`` (``RTPU_CHAOS_PLAN`` / the ``chaos_plan`` flag): a seeded
  fault plan applied at ``cluster/protocol.py``'s dispatch and reply
  seams, scoped by the receiving process's ``chaos_role`` (head, node,
  worker, driver, channel), plus the rolling head-upgrade scenario.
"""
