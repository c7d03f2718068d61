"""Rank programs for the multi-rank tests of ``ray_tpu_torch.parallel``
(imports neither JAX nor ``ray_tpu``).

``run_ranks(case, world, inputs, tmp_path)`` starts ``world`` processes of
``python -m tests.torch_parallel_ranks``, one a rank. They join one gloo
process group through a ``FileStore`` in ``tmp_path`` (no port, so tests
running side by side never meet), each runs ``CASES[case](inputs)`` on
the CPU and saves what it returns; the launcher returns the ranks'
results in rank order. A rank that fails or a run that outlasts
``timeout`` (at most 120 s) kills every rank and fails the test.
"""

from __future__ import annotations

import datetime
import os
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List

import torch

CASES: Dict[str, Callable[[Dict[str, Any]], Any]] = {}

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def run_ranks(name: str, world: int, inputs: Dict[str, Any], tmp_path,
              timeout: float = 120.0) -> List[Any]:
    if timeout > 120:
        raise ValueError("a multi-rank test gets at most 120 s")
    in_path = os.path.join(tmp_path, f"{name}.in.pt")
    torch.save(inputs, in_path)
    store = os.path.join(tmp_path, f"{name}.store")
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_parallel_ranks", name, str(r),
         str(world), store, in_path, str(tmp_path)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            left = deadline - time.monotonic()
            p.wait(timeout=max(left, 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    failed = [(r, p.returncode, p.stdout.read().decode(errors="replace"))
              for r, p in enumerate(procs) if p.returncode != 0]
    for p in procs:
        p.stdout.close()
    if failed:
        r, rc, log = failed[0]
        raise AssertionError(f"rank {r} of {name} exited {rc} "
                             f"(-9: killed at the {timeout:.0f} s limit):\n"
                             f"{log[-6000:]}")
    return [torch.load(os.path.join(tmp_path, f"{name}.rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def main() -> None:
    import torch.distributed as dist

    name, rank, world, store, in_path, out_dir = sys.argv[1:]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=100))
    try:
        out = CASES[name](torch.load(in_path, weights_only=False))
        torch.save(out, os.path.join(out_dir, f"{name}.rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------------ cases

def _mesh(inputs):
    from ray_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    return make_mesh(MeshSpec(**inputs["spec"]), "cpu")


def _local_tree(tree):
    from ray_tpu_torch.models import _tree
    from ray_tpu_torch.parallel.mesh import local

    return _tree.map_leaves(lambda t: local(t).detach().clone(), tree)


@case
def llama_steps(inputs):
    """Llama's sharded train step from ``ray_tpu``'s weights: the losses
    and grad norms of ``steps`` steps, the placements checked before and
    after, and the rank's shards as placed."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import spmd

    mesh = _mesh(inputs)
    cfg = llama.tiny_config(**inputs["cfg"])
    logical = llama.param_logical_axes(cfg)
    params = spmd.shard_params(
        llama.from_jax_params(inputs["params"], cfg, "cpu"), mesh, logical,
        "cpu")
    spmd.assert_params_sharded(params, mesh, logical)
    shards = _local_tree(params)
    tx = spmd.default_optimizer(**inputs["tx"])
    state = spmd.TrainState(0, params, tx.init(params))
    step = spmd.make_train_step(cfg, tx, mesh=mesh)
    tokens = torch.from_numpy(inputs["tokens"])
    losses, norms = [], []
    for _ in range(inputs["steps"]):
        state, metrics = step(state, tokens)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    spmd.assert_params_sharded(state.params, mesh, logical)
    return {"losses": losses, "grad_norms": norms, "shards": shards,
            "coord": mesh.get_coordinate()}


@case
def llama_placement(inputs):
    """Llama's tables on the mesh: ``sharded_init``'s placements and
    summary, the shards ``shard_params`` keeps of ``ray_tpu``'s weights,
    ``assert_params_sharded`` on trees that must fail it, and the token
    batch's block."""
    from torch.distributed.tensor import DTensor, Replicate

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import spmd
    from ray_tpu_torch.parallel.collectives import local_slice

    mesh = _mesh(inputs)
    cfg = llama.tiny_config(**inputs["cfg"])
    logical = llama.param_logical_axes(cfg)
    tx = spmd.default_optimizer(lr=1e-3)
    state = spmd.sharded_init(cfg, mesh, torch.Generator().manual_seed(0),
                              tx, device="cpu")
    spmd.assert_params_sharded(state.params, mesh, logical)
    whole = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    drawn_equal = all(torch.equal(
        local_slice(w, mesh, p.placements), p.to_local())
        for w, p in zip(_tree_leaves(whole), _tree_leaves(state.params)))
    placed = spmd.shard_params(
        llama.from_jax_params(inputs["params"], cfg, "cpu"), mesh, logical,
        "cpu")
    failures = []
    for bad in (whole, _tree_map(
            lambda p: DTensor.from_local(p.full_tensor(), mesh,
                                         (Replicate(),) * mesh.ndim),
            placed)):
        try:
            spmd.assert_params_sharded(bad, mesh, logical)
        except AssertionError as e:
            failures.append(str(e))
    tokens = torch.arange(8 * 32).reshape(8, 32)
    return {"coord": mesh.get_coordinate(), "shards": _local_tree(placed),
            "summary": spmd.sharding_summary(state.params, logical),
            "w_gate": tuple(state.params["blocks"]["w_gate"].to_local().shape),
            "wq": tuple(state.params["blocks"]["wq"].to_local().shape),
            "drawn_equal": drawn_equal, "failures": failures,
            "tokens": local_slice(tokens, mesh,
                                  spmd.data_sharding(mesh)).clone()}


def _tree_leaves(tree):
    from ray_tpu_torch.models import _tree

    return _tree.leaves(tree)


def _tree_map(fn, tree):
    from ray_tpu_torch.models import _tree

    return _tree.map_leaves(fn, tree)


@case
def llama_resume(inputs):
    """Two sharded steps, the state through ``train_state_tree`` (whole
    tensors) and back with ``train_state_from_tree(mesh=)``, a third step;
    and ``ray_tpu``'s sharded state after its two steps through
    ``from_jax_train_state(mesh=)``, a step from it."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import spmd

    mesh = _mesh(inputs)
    cfg = llama.tiny_config(**inputs["cfg"])
    logical = llama.param_logical_axes(cfg)
    tx = spmd.default_optimizer(**inputs["tx"])
    params = spmd.shard_params(
        llama.from_jax_params(inputs["params"], cfg, "cpu"), mesh, logical,
        "cpu")
    state = spmd.TrainState(0, params, tx.init(params))
    step = spmd.make_train_step(cfg, tx, mesh=mesh)
    tokens = torch.from_numpy(inputs["tokens"])
    for _ in range(2):
        state, _ = step(state, tokens)
    tree = spmd.train_state_tree(state)
    whole = _tree_map(lambda t: t.full_tensor() if hasattr(
        t, "full_tensor") else t, tree)
    resumed = spmd.train_state_from_tree(whole, cfg, tx, "cpu", mesh=mesh)
    spmd.assert_params_sharded(resumed.params, mesh, logical)
    _, m_resumed = step(resumed, tokens)
    _, m_straight = step(state, tokens)
    from_jax = spmd.from_jax_train_state(inputs["jax_state"], cfg, tx, "cpu",
                                         mesh=mesh)
    spmd.assert_params_sharded(from_jax.params, mesh, logical)
    _, m_jax = step(from_jax, tokens)
    return {k: float(m["loss"]) for k, m in (
        ("resumed", m_resumed), ("straight", m_straight),
        ("from_jax", m_jax))}


@case
def ring(inputs):
    """``ring_attention`` on DTensors split over ``sp``: the output and the
    local gradients of q, k, v for a given output gradient."""
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.ops import ring_attention
    from ray_tpu_torch.parallel.collectives import local_slice
    from ray_tpu_torch.parallel.mesh import spec_placements

    mesh = _mesh(inputs)
    qkv = spec_placements(mesh, (None, "sp", None, None))
    pos = spec_placements(mesh, (None, "sp"))
    leaves = [local_slice(torch.from_numpy(inputs[n]), mesh, qkv).clone()
              .requires_grad_() for n in ("q", "k", "v")]
    q, k, v = (DTensor.from_local(t, mesh, qkv) for t in leaves)
    p = DTensor.from_local(local_slice(torch.from_numpy(inputs["pos"]), mesh,
                                       pos), mesh, pos)
    out = ring_attention(q, k, v, p, p, mesh=mesh, batch_spec=None,
                         heads_axis=None)
    g = local_slice(torch.from_numpy(inputs["gout"]), mesh, qkv)
    (out.to_local() * g).sum().backward()
    return {"out": out.to_local().detach(),
            "grads": [t.grad for t in leaves]}


@case
def pipeline_steps(inputs):
    """The pipeline forward beside the dense forward on the same weights,
    then ``steps`` pipeline train steps."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import pipeline, spmd

    mesh = _mesh(inputs)
    cfg = llama.tiny_config(**inputs["cfg"])
    pcfg = pipeline.PipelineConfig(**inputs["pcfg"])
    tokens = torch.from_numpy(inputs["tokens"])
    whole = llama.from_jax_params(inputs["params"], cfg, "cpu")
    dense = spmd.shard_params(whole, mesh, llama.param_logical_axes(cfg),
                              "cpu")
    logical = pipeline.pipeline_param_logical_axes(cfg)
    params = spmd.shard_params(pipeline.stage_params(whole, pcfg.stages),
                               mesh, logical, "cpu")
    spmd.assert_params_sharded(params, mesh, logical)
    with torch.no_grad():
        want = llama.forward_hidden(dense, tokens, cfg, mesh=mesh)
        got = pipeline.pipeline_forward_hidden(params, tokens, cfg, pcfg,
                                               mesh=mesh)
        loss = pipeline.pipeline_loss_fn(params, tokens, cfg, pcfg,
                                         mesh=mesh)[0]
    tx = spmd.default_optimizer(**inputs["tx"])
    state = spmd.TrainState(0, params, tx.init(params))
    step = pipeline.make_pipeline_train_step(cfg, pcfg, mesh, tx)
    losses = []
    for _ in range(inputs["steps"]):
        state, metrics = step(state, tokens)
        losses.append(float(metrics["loss"]))
    spmd.assert_params_sharded(state.params, mesh, logical)
    return {"dense": want.to_local(), "pipeline": got.to_local(),
            "loss": float(loss), "losses": losses}


@case
def mixtral_steps(inputs):
    """Mixtral's training steps over a mesh with experts over ``ep``."""
    from ray_tpu_torch.models import mixtral
    from ray_tpu_torch.parallel import spmd

    mesh = _mesh(inputs)
    cfg = mixtral.tiny_moe_config()
    logical = mixtral.param_logical_axes(cfg)
    params = spmd.shard_params(
        mixtral.from_jax_params(inputs["params"], cfg, "cpu"), mesh, logical,
        "cpu")
    tx = spmd.default_optimizer(**inputs["tx"])
    opt = tx.init(params, stacked=mixtral.STACKED)
    tokens = torch.from_numpy(inputs["tokens"])
    losses = []
    for i in range(inputs["steps"]):
        loss, metrics = mixtral.loss_fn(params, tokens, cfg, mesh=mesh,
                                        layers=opt.layers["blocks"])
        loss.backward()
        tx.update(opt, i)
        losses.append(float(metrics["loss"]))
    spmd.assert_params_sharded(params, mesh, logical)
    return {"losses": losses,
            "experts": tuple(params["blocks"]["w_gate"].to_local().shape)}


def zoo_loss(model, params, layers, inputs, mesh):
    """One model's loss on the fixed batch of ``inputs`` (``mesh`` None:
    one process)."""
    import importlib

    mod = importlib.import_module(f"ray_tpu_torch.models.{model}")
    cfg = mod.tiny_config()
    batch = {k: torch.from_numpy(v) for k, v in inputs["batch"].items()}
    if model == "vit":
        return mod.loss_fn(params, batch["images"], batch["labels"], cfg,
                           mesh=mesh, layers=layers["blocks"])
    if model == "t5":
        return mod.loss_fn(params, batch["enc"], batch["dec"], cfg,
                           mesh=mesh, layers=layers)[0]
    return mod.loss_fn(params, batch["x0"], None, cfg,
                       mod.cosine_schedule(cfg, "cpu"), mesh=mesh,
                       t=batch["t"], eps=batch["eps"])[0]


def zoo_sgd(model, inputs, mesh):
    """``ray_tpu``'s zoo test step: the loss, then p - 1e-3 * grad on
    every parameter (over a mesh, the gradients summed as
    ``Optimizer.update`` sums them). Returns (loss, params)."""
    import importlib

    from ray_tpu_torch.parallel import spmd

    mod = importlib.import_module(f"ray_tpu_torch.models.{model}")
    cfg = mod.tiny_config()
    params = mod.from_jax_params(inputs["params"], cfg, "cpu")
    if mesh is not None:
        params = spmd.shard_params(params, mesh, mod.param_logical_axes(cfg),
                                   "cpu")
    tx = spmd.default_optimizer()
    opt = tx.init(params, stacked=mod.STACKED)
    loss = zoo_loss(model, params, opt.layers, inputs, mesh)
    loss.backward()
    tx.global_norm(opt)
    with torch.no_grad():
        for w in opt.leaves:
            w -= 1e-3 * w.grad
    return loss.item(), params


@case
def zoo_step(inputs):
    from ray_tpu_torch.models import _tree
    from ray_tpu_torch.parallel import spmd

    mesh = _mesh(inputs)
    loss, params = zoo_sgd(inputs["model"], inputs, mesh)
    import importlib

    mod = importlib.import_module(f"ray_tpu_torch.models.{inputs['model']}")
    spmd.assert_params_sharded(params, mesh,
                               mod.param_logical_axes(mod.tiny_config()))
    return {"loss": loss,
            "params": _tree.map_leaves(lambda p: p.full_tensor(), params)}


if __name__ == "__main__":
    main()
