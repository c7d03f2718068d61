"""Train loops that the ``tests/test_torch_train_*.py`` files run in the
port's worker processes.

The cluster ships a function by reference when its module can be
imported: these loops live here, in a module that imports neither JAX nor
``ray_tpu``, so a worker that runs them loads neither (each loop checks
that of its own process). The tests compute ``ray_tpu``'s side in their
own process.
"""

import json
import os
import sys
import tempfile
import time

import numpy as np

TOKENS_SHAPE = (2, 64)


def foreign_modules():
    """The jax*, jaxlib and ray_tpu modules loaded in this process."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "ray_tpu"))


def tiny_llama_loop(config):
    """``tests/test_train.py``'s loop on the port: ``tiny_config`` Llama on
    the CPU from ``ray_tpu``'s weights (``config["params"]``, a numpy
    tree), ``default_optimizer(lr=1e-2)``, tokens from a numpy rng seeded
    by rank; the whole state saved by rank 0 every ``checkpoint_every``
    steps and restored from the trainer's checkpoint."""
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import spmd

    assert foreign_modules() == [], foreign_modules()
    ctx = train.get_context()
    assert ctx.get_world_size() == config["world_size"]
    cfg = llama.tiny_config()
    tx = spmd.default_optimizer(lr=1e-2)
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        with ckpt.as_directory() as d:
            state = spmd.train_state_from_tree(train.load_pytree(d), cfg,
                                               tx, device="cpu")
    else:
        params = llama.from_jax_params(config["params"], cfg, "cpu")
        state = spmd.TrainState(0, params, tx.init(params))
    start_step = state.step
    step_fn = spmd.make_train_step(cfg, tx)
    rng = np.random.default_rng(ctx.get_world_rank())
    for i in range(start_step, config["num_steps"]):
        tokens = rng.integers(0, cfg.vocab_size, TOKENS_SHAPE).astype(
            np.int32)
        state, metrics = step_fn(state, torch.from_numpy(tokens))
        if config.get("fail_at") == i and ckpt is None:
            raise RuntimeError("injected worker failure")
        payload = {"loss": metrics["loss"].item(), "step": i,
                   "start_step": start_step, "rank": ctx.get_world_rank(),
                   "pid": os.getpid(), "foreign": foreign_modules()}
        if (i + 1) % config["checkpoint_every"] == 0 \
                and ctx.get_world_rank() == 0:
            d = tempfile.mkdtemp(prefix="rtt_test_ckpt_")
            train.save_pytree(spmd.train_state_tree(state), d)
            train.report(payload, checkpoint=train.Checkpoint(d))
        else:
            train.report(payload)


def counting_loop(config):
    """``tests/test_elastic_train.py``'s loop: checkpoints a step counter
    each round and reports the world size."""
    from ray_tpu_torch import train

    ctx = train.get_context()
    start_step = 0
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        with ckpt.as_directory() as d:
            with open(os.path.join(d, "state.json")) as f:
                start_step = json.load(f)["step"] + 1
    for step in range(start_step, config["num_steps"]):
        time.sleep(config.get("round_s", 0.2))
        payload = {"step": step, "start_step": start_step,
                   "world_size": ctx.get_world_size()}
        if ctx.get_world_rank() == 0:
            d = tempfile.mkdtemp(prefix="rtt_elastic_ckpt_")
            with open(os.path.join(d, "state.json"), "w") as f:
                json.dump({"step": step}, f)
            train.report(payload, checkpoint=train.Checkpoint(d))
        else:
            train.report(payload)


def allreduce_loop(config):
    """Every worker in one process group; an allreduce of rank + 1."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch import train

    ctx = train.get_context()
    assert dist.is_initialized()
    assert dist.get_world_size() == config["world_size"]
    assert dist.get_rank() == ctx.get_world_rank()
    t = torch.tensor([float(dist.get_rank() + 1)])
    dist.all_reduce(t)
    train.report({"allreduce": float(t.item()), "rank": dist.get_rank(),
                  "backend": dist.get_backend(),
                  "foreign": foreign_modules()})


def mesh_llama_loop(config):
    """``mesh_2d()`` over the gang's world (one rank a worker), then Llama's
    sharded step on it; reports the losses and the mesh's shape."""
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import spmd
    from ray_tpu_torch.parallel.mesh import AXES, mesh_2d

    mesh = mesh_2d(device_type="cpu")
    cfg = llama.tiny_config(**config["cfg"])
    logical = llama.param_logical_axes(cfg)
    params = spmd.shard_params(
        llama.from_jax_params(config["params"], cfg, "cpu"), mesh, logical,
        "cpu")
    tx = spmd.default_optimizer(**config["tx"])
    state = spmd.TrainState(0, params, tx.init(params))
    step = spmd.make_train_step(cfg, tx, mesh=mesh)
    tokens = torch.from_numpy(config["tokens"])
    losses = []
    for _ in range(config["steps"]):
        state, metrics = step(state, tokens)
        losses.append(float(metrics["loss"]))
    spmd.assert_params_sharded(state.params, mesh, logical)
    train.report({"losses": losses, "foreign": foreign_modules(),
                  "mesh": dict(zip(AXES, mesh.shape))})


def ddp_linear_loop(config):
    """DDP linear regression, each rank on its own data."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch import train
    from ray_tpu_torch.train.torch import prepare_model

    torch.manual_seed(0)
    model = prepare_model(torch.nn.Linear(2, 1))
    opt = torch.optim.SGD(model.parameters(), lr=0.2)
    rank = dist.get_rank()
    g = torch.Generator().manual_seed(100 + rank)
    X = torch.randn(64, 2, generator=g)
    y = X @ torch.tensor([[2.0], [-3.0]]) + 1.0
    for _ in range(60):
        opt.zero_grad()
        loss = torch.nn.functional.mse_loss(model(X), y)
        loss.backward()
        opt.step()
    w = model.module.weight.detach().numpy().ravel()
    b = float(model.module.bias.item())
    train.report({"loss": float(loss.item()), "w0": float(w[0]),
                  "w1": float(w[1]), "b": b})


def data_loader_loop(config):
    """``prepare_data_loader`` shards 20 rows across the gang."""
    import torch
    import torch.distributed as dist
    import torch.utils.data as tud

    from ray_tpu_torch import train
    from ray_tpu_torch.train.torch import prepare_data_loader

    ds = tud.TensorDataset(torch.arange(20).float())
    loader = prepare_data_loader(tud.DataLoader(ds, batch_size=5))
    seen = sorted(float(x) for batch in loader for x in batch[0])
    total = torch.tensor([len(seen)])
    dist.all_reduce(total)
    train.report({"n_local": len(seen), "n_total": int(total.item())})


def transformers_loop(config):
    """A stock ``transformers.Trainer`` on the gang, reporting through
    ``RayTrainReportCallback``."""
    import torch
    from transformers import Trainer, TrainingArguments

    from ray_tpu_torch.train.huggingface import (RayTrainReportCallback,
                                                 prepare_trainer)

    class TinyRegressor(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.net = torch.nn.Linear(4, 1)

        def forward(self, x=None, labels=None):
            pred = self.net(x).squeeze(-1)
            loss = torch.nn.functional.mse_loss(pred, labels)
            return {"loss": loss, "logits": pred}

    class Ds(torch.utils.data.Dataset):
        def __len__(self):
            return 64

        def __getitem__(self, i):
            x = torch.randn(4, generator=torch.Generator().manual_seed(i))
            return {"x": x, "labels": x.sum()}

    args = TrainingArguments(
        output_dir=config["out_dir"],
        per_device_train_batch_size=8,
        max_steps=6,
        logging_steps=2,
        save_strategy="no",
        report_to=[],
        use_cpu=True,
    )
    trainer = Trainer(model=TinyRegressor(), args=args, train_dataset=Ds())
    trainer = prepare_trainer(trainer)
    trainer.add_callback(RayTrainReportCallback())
    trainer.train()
