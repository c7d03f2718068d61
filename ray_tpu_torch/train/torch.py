"""TorchTrainer: torch DDP training on the worker-gang substrate
(``ray_tpu/train/torch.py``).

Parity target: the reference's flagship trainer
(reference: python/ray/train/torch/torch_trainer.py + torch/config.py:94-163
— master addr/port exchange then dist.init_process_group on every worker,
train_loop_utils.prepare_model/prepare_data_loader). The SAME gang
executor, lockstep report(), checkpoint manager and failure/elastic
policies as ``DataParallelTrainer``; only the backend hook differs,
wrapping the user loop with a process-group setup: NCCL when the workers
lease cards (``ScalingConfig(use_gpu=True)``; each GPU worker selects its
own card, ``cuda:0``, before it joins), gloo otherwise. ``ray_tpu``'s
hard-codes gloo. NCCL takes one rank per card, so a gang of n GPU workers
needs n cards. A failed join raises in the loop (``TrainWorkerError`` for
the failure policy); it never falls back to another backend.

A mesh over the gang: inside the loop, ``parallel.mesh.mesh_2d()`` (or
``make_mesh``) builds the six-axis ``DeviceMesh`` over this process group,
one rank a worker (on cards, each worker's ``cuda:0``, its own card), and
``spmd.make_train_step(cfg, tx, mesh=mesh)`` runs the sharded step there
(``tests/test_torch_parallel_trainer.py``).

Rendezvous: rank 0 binds a free TCP port and publishes host:port in the
cluster KV under the run's rendezvous id; other ranks poll. (The reference
executes a get-address task on worker 0 and broadcasts via the actor group
— same shape, the KV is this runtime's natural bus.)
"""

from __future__ import annotations

import os
import time
import uuid
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.train.trainer import (  # noqa: F401 (Result re-export)
    DataParallelTrainer, Result)

_RDZV_NS = "__torch_rdzv__"


def _rendezvous(rdzv_key: str, rank: int, world_size: int,
                timeout_s: float = 120.0) -> str:
    """Publish (rank 0) or discover the master address via the head KV.

    ``rdzv_key`` is scoped per GANG START (trainer id + gang_id): group
    restarts/resizes re-run this with a fresh key, so ranks can never read
    a previous incarnation's dead address."""
    from ray_tpu_torch.core.runtime_context import require_runtime
    from ray_tpu_torch.train.worker_group import free_port, node_ip

    rt = require_runtime()
    key = rdzv_key.encode()
    if rank == 0:
        # The ROUTABLE address: binding/publishing loopback would strand
        # every rank on another host on its own 127.0.0.1.
        addr = f"{node_ip()}:{free_port()}"
        rt.head.retrying_call("kv_put", _RDZV_NS, key, addr.encode(), True,
                              timeout=30)
        return addr
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        raw = rt.head.retrying_call("kv_get", _RDZV_NS, key, timeout=30)
        if raw:
            return raw.decode()
        time.sleep(0.2)
    raise TimeoutError(f"torch rendezvous {rdzv_key!r}: rank 0 never "
                       f"published the master address")


def _wrap_with_torch_backend(user_fn: Callable, backend: str,
                             rdzv_id: str, use_gpu: bool) -> Callable:
    def torch_train_loop(config: Dict[str, Any]) -> None:
        import torch
        import torch.distributed as dist

        from ray_tpu_torch.train.session import get_context

        ctx = get_context()
        rank = ctx.get_world_rank()
        world = ctx.get_world_size()
        gang = ctx.get_gang_id() if hasattr(ctx, "get_gang_id") else ""
        if use_gpu:
            # The worker sees its lease's cards alone: its own is cuda:0
            # (raises without a card; NCCL needs the device chosen first).
            torch.cuda.set_device(0)
        # free_port() probes by bind-and-close, so another process can
        # steal the port before the backend rebinds it. Rank 0 catches the
        # bind failure and republishes a fresh port (overwriting the KV entry);
        # other ranks re-read the KV on a failed/timed-out join so they
        # chase the republished address instead of a dead one.
        import datetime as _dt

        def _drop_rdzv_key() -> None:
            """Rank 0: drop the durable KV entry (rpc_kv_put writes
            through to the durable store — a long-lived cluster must not
            accumulate one key per gang, whether the gang formed or not)."""
            try:
                from ray_tpu_torch.core.runtime_context import \
                    require_runtime

                require_runtime().head.retrying_call(
                    "kv_del", _RDZV_NS, f"{rdzv_id}:{gang}".encode(),
                    timeout=30)
            except Exception:
                pass

        last_err: Optional[BaseException] = None
        for attempt in range(5):
            # Retry re-reads poll with a short deadline: after rank 0 has
            # failed for good it deletes the key, and a 120 s poll per
            # remaining attempt would stall gang teardown for minutes.
            addr = _rendezvous(f"{rdzv_id}:{gang}", rank, world,
                               timeout_s=120.0 if attempt == 0 else 15.0)
            host, port = addr.rsplit(":", 1)
            os.environ["MASTER_ADDR"] = host
            os.environ["MASTER_PORT"] = port
            os.environ["RANK"] = str(rank)
            os.environ["WORLD_SIZE"] = str(world)
            try:
                dist.init_process_group(
                    backend, rank=rank, world_size=world,
                    timeout=_dt.timedelta(seconds=120))
                last_err = None
                break
            except (RuntimeError, OSError, ValueError) as e:
                # ValueError: a failed attempt can leave the default group
                # registered ("initialize ... twice"); tear it down so the
                # next attempt starts clean.
                last_err = e
                try:
                    if dist.is_initialized():
                        dist.destroy_process_group()
                except Exception:
                    pass
                if rank == 0:
                    continue  # republish a fresh port next iteration
                time.sleep(1.0)  # wait for rank 0's republish, then re-read
        if rank == 0:
            # Success: group formed = every rank has read the address.
            # Failure: the success-path cleanup would never run. Either
            # way the key must go.
            _drop_rdzv_key()
        if last_err is not None:
            raise last_err
        try:
            user_fn(config)
        finally:
            try:
                dist.destroy_process_group()
            except Exception:
                pass

    return torch_train_loop


class TorchTrainer(DataParallelTrainer):
    """``train_loop_per_worker`` runs inside an initialized torch process
    group (``backend``: None picks NCCL when ``scaling_config.use_gpu``,
    else gloo); everything else — scaling, report(), checkpoints, failure
    handling, datasets — is the shared gang substrate.

    Usage::

        def loop(config):
            model = prepare_model(Net().to(resolve_device(None)))
            ... train ...
            ray_tpu_torch.train.report({"loss": loss})

        TorchTrainer(loop, scaling_config=ScalingConfig(
            num_workers=1, use_gpu=True)).fit()
    """

    def __init__(self, train_loop_per_worker: Callable, *,
                 backend: Optional[str] = None, **kwargs):
        use_gpu = bool(kwargs.get("scaling_config")
                       and kwargs["scaling_config"].use_gpu)
        self.backend = backend or ("nccl" if use_gpu else "gloo")
        rdzv_id = f"rdzv-{uuid.uuid4().hex[:12]}"
        wrapped = _wrap_with_torch_backend(train_loop_per_worker,
                                           self.backend, rdzv_id, use_gpu)
        # Result dirs default to the USER fn's name, not the wrapper's.
        wrapped.__name__ = getattr(train_loop_per_worker, "__name__",
                                   "torch_train_loop")
        super().__init__(wrapped, **kwargs)


def prepare_model(model):
    """Wrap a torch module for distributed training (reference:
    train/torch/train_loop_utils.prepare_model — DDP on >1 worker, no-op
    single-worker). A module on the card is wrapped with ``device_ids`` set
    to the current card."""
    import torch
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_world_size() > 1:
        from torch.nn.parallel import DistributedDataParallel

        on_card = any(p.is_cuda for p in model.parameters())
        return DistributedDataParallel(
            model,
            device_ids=[torch.cuda.current_device()] if on_card else None)
    return model


def prepare_data_loader(loader):
    """Shard a DataLoader across the gang with a DistributedSampler
    (reference: prepare_data_loader). Falls back to the loader unchanged
    when not distributed, the dataset isn't map-style, or the loader uses
    a custom batch_sampler (rebuilding one would silently change its
    batching semantics)."""
    import torch.distributed as dist

    if not (dist.is_initialized() and dist.get_world_size() > 1):
        return loader
    import torch.utils.data as tud

    ds = loader.dataset
    if not hasattr(ds, "__len__") or loader.batch_size is None:
        return loader
    # Only the two default samplers are replaceable without changing what
    # the user asked for; a custom sampler (weighted, subset, ...) must
    # survive — return the loader unchanged rather than silently retrain
    # on a uniform distribution.
    if not isinstance(loader.sampler,
                      (tud.SequentialSampler, tud.RandomSampler)):
        return loader
    shuffle = not isinstance(loader.sampler, tud.SequentialSampler)
    sampler = tud.distributed.DistributedSampler(
        ds, num_replicas=dist.get_world_size(), rank=dist.get_rank(),
        shuffle=shuffle)
    return tud.DataLoader(
        ds, batch_size=loader.batch_size, sampler=sampler,
        num_workers=loader.num_workers, collate_fn=loader.collate_fn,
        drop_last=loader.drop_last, pin_memory=loader.pin_memory,
        timeout=loader.timeout, worker_init_fn=loader.worker_init_fn,
        generator=loader.generator,
        persistent_workers=getattr(loader, "persistent_workers", False),
        prefetch_factor=(loader.prefetch_factor
                         if loader.num_workers > 0 else None))
