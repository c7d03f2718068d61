"""ray_tpu_torch — the PyTorch/CUDA port of ``ray_tpu`` for NVIDIA Hopper.

The JAX package ``ray_tpu`` stays the reference; this package does the
same work in PyTorch, with a hand-written Hopper kernel wherever
``ray_tpu`` has a Pallas kernel. It imports nothing of ``ray_tpu`` and
nothing of JAX: what it needs of ``ray_tpu``'s JAX-free modules it keeps
as its own copies.

Ported so far: the serving engine's device path — ``ops`` (norm, rotary,
attention, decode attention contiguous and paged, the fused per-layer
glue), ``models.llama`` and ``models.quant`` (int8 weights),
``serve.engine`` (continuous batching, prefix cache, chunked prefill,
speculative decoding, prefill/decode roles, the fleet KV page tier,
priority preemption) and the ``serve.llm.LLMEngine`` facade — and the
single-card training step: ``parallel.spmd`` (``init_train_state``,
``make_train_step``, ``default_optimizer``) over ``models.llama.loss_fn``
(remat, chunked cross-entropy), causal flash attention forward and
backward, and the fused ops' backward; the other model families
(``models.mixtral``, ``vit``, ``t5``, ``diffusion``); and ``rllib`` (env
runners, PPO/DQN/SAC/IMPALA/BC/CQL learners and algorithms, multi-agent
PPO; locally, or with runner actors and learner gangs over
``util.collective``'s actor collectives); the two runtimes: ``init()``
starts the cluster runtime (``core.cluster_runtime``: a head, a node
manager and worker processes over the node's shm object store,
``cluster/``), and
``init(local_mode=True)`` the in-process one (``core.local_runtime``:
tasks, actors, objects on threads); and the serve stack on either:
``serve`` (controller, router, replicas, handles, streaming) and
``serve.llm.build_llm_deployment``, so
``serve.run(build_llm_deployment(engine_kwargs=...))`` serves the engine
through ``handle.remote({"prompt_ids": [...]})``, each replica in a worker
process of its own on the cluster; ``dag`` (compiled DAGs over shm rings)
and the disaggregated deployment over it
(``build_llm_deployment(disaggregated=True)``); and ``train``
(``DataParallelTrainer``, ``TorchTrainer`` on NCCL or gloo, lockstep
``report()``, checkpoints of the whole training state through
``spmd.train_state_tree``, group restarts, elastic resizes); and the
mesh (``parallel.mesh``: the six-axis ``DeviceMesh`` over the process
group, the models' logical-axis tables as DTensor placements, the sharded
step, ring attention over ``sp``, the GPipe pipeline over ``pp``, experts
over ``ep``), whose ranks may be a ``TorchTrainer`` gang; and ``data``
(``Dataset``, its streaming executor and exchanges, device ingest on
pinned memory and a copy stream, ``build_llm_processor``); and ``tune``
(searchers, schedulers, ``Tuner`` on either runtime), client mode
(``init("client://...")`` through ``client.server``'s gateway), ``jobs``
and the CLI (``scripts/cli.py``), the pip, uv and conda runtime envs,
the head's rolling upgrade and ``SimulatedCluster``; and the
libraries beside the runtime: ``workflow`` (durable step DAGs),
``autoscaler`` (a GCE GPU provider), ``experimental.broadcast``,
``util.state``/``pubsub``/``timeline``/``dashboard``, the Pool, joblib
and dask shims, and ``core.accelerators`` (the GPU accelerator manager:
a node's cards and their model as its label, read without a CUDA
context). A worker
leased with ``GPU`` sees its lease's cards alone (``CUDA_VISIBLE_DEVICES``,
set by the node manager), so its own card is ``cuda:0``; a CPU worker
sees none. ``ROADMAP.md`` lists what is left.

The tests run the serve path on the CPU (``tests/test_torch_serve*.py``,
``device="cpu"`` in ``engine_kwargs``); ``python3 chip_smoke.py --serve``
runs it on the card at full Llama-3-8B on the local runtime,
``python3 chip_smoke.py --cluster`` on the cluster runtime, and
``python3 chip_smoke.py --train`` trains through ``train`` there.

Importing the package does not import ``torch``: the head and node
processes of a cluster never need it. The modules that make tensors
import it themselves.

Entry points that make tensors (``init_params``, ``init_kv_cache``,
``LLMEngine``, ``spmd.init_train_state``, ``spmd.train_state_from_tree``,
``spmd.sharded_init``, ``spmd.shard_params``, the ``rllib`` learners,
runners and configs) take ``device=None``, meaning the card; without one
they raise, as ``mesh.make_mesh`` does for its default ``"cuda"``. Pass
``device="cpu"`` (``device_type="cpu"``) to run the plain versions on the
CPU.
"""

from __future__ import annotations


def resolve_device(device=None):
    """``None`` -> the CUDA card (raises when there is none); anything
    else -> ``torch.device(device)``."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: ray_tpu_torch runs on the card by default; "
                "pass device='cpu' to run the plain versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


from ray_tpu_torch import exceptions  # noqa: E402
from ray_tpu_torch.actor import ActorClass, ActorHandle  # noqa: E402
from ray_tpu_torch.api import (available_resources, cancel,  # noqa: E402
                               cluster_resources, get, get_actor, init,
                               is_initialized, kill, method, nodes, put,
                               remote, shutdown, timeline, wait)
from ray_tpu_torch.core.object_ref import ObjectRef  # noqa: E402
from ray_tpu_torch.core.runtime_context import \
    get_runtime_context  # noqa: E402

__all__ = [
    "resolve_device",
    "init",
    "shutdown",
    "is_initialized",
    "remote",
    "method",
    "get",
    "put",
    "wait",
    "kill",
    "cancel",
    "get_actor",
    "nodes",
    "cluster_resources",
    "available_resources",
    "timeline",
    "ObjectRef",
    "ActorClass",
    "ActorHandle",
    "get_runtime_context",
    "exceptions",
]
