"""The training step on one card (``ray_tpu/parallel/spmd.py``).

``ray_tpu`` jits one program over a mesh: ``value_and_grad`` of
``llama.loss_fn``, then optax's chain (clip by global norm, AdamW with a
warmup-cosine schedule), the buffers donated so the step is in place. Here
the step runs eagerly on one card and updates the parameters in place:

- the parameters stay the model's tree in ``ray_tpu``'s layout, any nest
  of dicts and lists (optax applies to any pytree); ``tx.init`` makes each
  layer of a stacked subtree (Llama's ``blocks``; the model names them) a
  leaf view of that tree, so each layer's gradient lands in its own tensor
  (a gradient through a slice of the stacked tensor would build a
  full-size zero tensor per layer) and the optimizer's in-place updates
  write the tree; ``make_train_step`` composes Llama's step, and the other
  models' steps are the same three calls with their ``loss_fn``;
- ``default_optimizer`` reproduces optax's chain: the global norm of every
  gradient in f32, a scale of ``max_norm / norm`` only when the norm is not
  below ``max_norm`` (no epsilon, unlike ``clip_grad_norm_``), then AdamW
  (b1 0.9, b2 0.95, eps 1e-8, decay on every leaf, moments in the
  parameters' dtype as optax keeps them) at the schedule's rate for the
  step, which is 0 at step 0. On the card the AdamW update is PyTorch's
  fused kernel (``ray_tpu`` leaves the update to XLA; there is no Pallas
  kernel there either).

``train_state_tree`` writes the whole state (step, parameters, AdamW's
count and moments) as a tree in ``ray_tpu``'s layout, and
``train_state_from_tree`` / ``from_jax_train_state`` rebuild a state from
that tree or from ``ray_tpu``'s own: what ``train``'s checkpoints save and
restore.

Over a mesh (``parallel/mesh.py``): ``shard_params`` and ``sharded_init``
make each parameter a DTensor placed by the model's logical-axis table,
each rank holding its shard; ``Optimizer.init`` then works on the local
shards (the layer views share the stacked local storage) and records
each leaf's placement; ``make_train_step(cfg, tx, mesh=mesh)`` runs the
model's mesh path; ``Optimizer.update`` sums each gradient over the data
axes its parameter is not sharded on (dp, sp, and fsdp for a parameter
replicated there; the ZeRO-3 gather's backward already reduce-scattered
the rest) and takes the global norm over every shard once, the same
number on every rank. ``assert_params_sharded`` checks the placements and
the local shard shapes. A world of one runs the same path with no
communication.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, NamedTuple, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.optim.optimizer import _get_scalar_dtype

from ray_tpu_torch import resolve_device
from ray_tpu_torch.devtools import cuda_debug
from ray_tpu_torch.models import _tree, llama
from ray_tpu_torch.models.quant import QuantTensor
from ray_tpu_torch.parallel.collectives import all_reduce_, local_slice
from ray_tpu_torch.parallel.mesh import (AXES, DATA_AXES, local,
                                         logical_spec, param_shardings)

Metrics = Dict[str, torch.Tensor]
Params = Dict[str, Any]


class OptState(NamedTuple):
    leaves: List[torch.Tensor]    # every trainable tensor, in update order
    # Per stacked subtree, per layer: the layer's leaf views.
    layers: Dict[str, List[Dict[str, torch.Tensor]]]
    adamw: torch.optim.AdamW
    # Over a mesh (DTensor parameters; ``leaves`` are their local shards):
    # per leaf, the data axes its gradient is summed over and the number
    # of ranks holding the same shard.
    mesh: Any = None
    sync: Sequence[Tuple[Tuple[str, ...], int]] = ()


def _sharded_axes(p) -> Tuple[str, ...]:
    """The mesh axes a DTensor is sharded over."""
    names = p.device_mesh.mesh_dim_names
    return tuple(names[i] for i, pl in enumerate(p.placements)
                 if pl.is_shard())


def _sync_of(p) -> Tuple[Tuple[str, ...], int]:
    sharded = _sharded_axes(p)
    mesh = p.device_mesh
    replicas = math.prod(mesh.size(i) for i, a in
                         enumerate(mesh.mesh_dim_names) if a not in sharded)
    return tuple(a for a in DATA_AXES if a not in sharded), replicas


class TrainState(NamedTuple):
    step: int
    params: Params
    opt_state: OptState


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(
    warmup_cosine_decay_schedule(0, lr, warmup, decay_steps, lr * 0.1),
    b1, b2, eps, weight_decay))``, applied in place."""

    lr: float
    weight_decay: float
    warmup: int
    decay_steps: int
    grad_clip: float
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8

    def schedule(self, step: int) -> float:
        """optax's warmup_cosine_decay_schedule at ``step``: linear from 0
        to lr over ``warmup`` steps, then cosine down to lr * 0.1 at
        ``decay_steps``."""
        if step < self.warmup:
            return self.lr * step / self.warmup
        span = self.decay_steps - self.warmup
        if span <= 0:
            raise ValueError(f"decay_steps {self.decay_steps} must exceed "
                             f"warmup {self.warmup}")
        alpha = 0.1
        count = min(step - self.warmup, span)
        cosine = 0.5 * (1 + math.cos(math.pi * count / span))
        return self.lr * ((1 - alpha) * cosine + alpha)

    def init(self, params: Params,
             stacked: Sequence[str] = ("blocks",)) -> OptState:
        """Mark every floating tensor of ``params`` (any nest of dicts and
        lists) trainable and make AdamW's state for them (its moments
        appear at the first update). The top-level subtrees named in
        ``stacked`` hold layers stacked on a leading axis (the model's
        ``STACKED``: ``blocks`` for Llama, Mixtral and ViT, ``encoder``
        and ``decoder`` for T5, none for the UNet); each of their layers
        gets a leaf view of every weight, ``OptState.layers[name][i]``,
        which the model's ``loss_fn`` takes as ``layers=``. Every other
        tensor is a leaf of its own."""
        missing = [n for n in stacked if n not in params]
        if missing:
            raise ValueError(f"stacked subtrees {missing} are not in the "
                             f"parameters {sorted(params)}")
        if any(isinstance(w, QuantTensor) for w in _tree.leaves(params)):
            raise ValueError("int8 weights are not trainable")
        mesh = next((t.device_mesh for t in _tree.leaves(params)
                     if isinstance(t, DTensor)), None)
        top_pairs = [(local(t), t) for name, sub in params.items()
                     if name not in stacked for t in _tree.leaves(sub)
                     if t.dtype.is_floating_point]
        for t, _ in top_pairs:
            t.requires_grad_(True)
        layers, layer_pairs = {}, []
        for name in stacked:
            stacks = _tree.leaves(params[name])
            layers[name] = [_tree.map_leaves(
                lambda w: w.detach().requires_grad_(w.dtype.is_floating_point),
                view) for view in _tree.unstack(_tree.map_leaves(
                    local, params[name]))]
            layer_pairs += [(w, p) for view in layers[name]
                            for w, p in zip(_tree.leaves(view), stacks)
                            if w.requires_grad]
        pairs = top_pairs + layer_pairs
        leaves = [w for w, _ in pairs]
        adamw = torch.optim.AdamW(
            leaves, lr=0.0, betas=(self.b1, self.b2), eps=self.eps,
            weight_decay=self.weight_decay,
            fused=leaves[0].device.type == "cuda")
        if mesh is None:
            return OptState(leaves, layers, adamw)
        return OptState(leaves, layers, adamw, mesh,
                        [_sync_of(p) for _, p in pairs])

    def update(self, opt: OptState, step: int) -> torch.Tensor:
        """Clip the gradients by their global norm, take the AdamW step at
        ``schedule(step)`` and free the gradients. Returns the norm before
        clipping (a 0-dim f32 tensor; no host sync)."""
        grads = [p.grad for p in opt.leaves]
        gnorm = self.global_norm(opt)
        clip = torch.where(gnorm < self.grad_clip, torch.ones_like(gnorm),
                           self.grad_clip / gnorm)
        # The factor in the gradients' dtype (optax casts the norm to each
        # leaf's dtype too): a factor of another dtype sends the CUDA
        # foreach op to its per-tensor path, one launch per gradient.
        for dtype in {g.dtype for g in grads}:
            torch._foreach_mul_([g for g in grads if g.dtype == dtype],
                                clip.to(dtype))
        lr = self.schedule(step)
        for group in opt.adamw.param_groups:
            group["lr"] = lr
        opt.adamw.step()
        opt.adamw.zero_grad(set_to_none=True)
        return gnorm


    @staticmethod
    def global_norm(opt: OptState) -> torch.Tensor:
        """The gradients' global norm in f32 (0-dim, no host sync). Over a
        mesh of several ranks this first sums each gradient, in place,
        over the data axes its parameter is not sharded on, then counts
        every shard's squares once (a shard held by n ranks counts 1/n on
        each) and sums them over the mesh: the same number on every
        rank."""
        grads = [p.grad for p in opt.leaves]
        if any(g is None for g in grads):
            raise RuntimeError("a trainable tensor got no gradient")
        if opt.mesh is None or opt.mesh.size() == 1:
            norms = torch._foreach_norm(grads, 2, dtype=torch.float32)
            return torch.linalg.vector_norm(torch.stack(norms))
        for g, (axes, _) in zip(grads, opt.sync):
            all_reduce_(g, opt.mesh, axes)
        norms = torch._foreach_norm(grads, 2, dtype=torch.float32)
        replicas = torch.tensor([n for _, n in opt.sync],
                                dtype=torch.float32, device=grads[0].device)
        sq = (torch.stack(norms).square() / replicas).sum()
        return all_reduce_(sq, opt.mesh, AXES).sqrt()


def default_optimizer(lr: float = 3e-4, weight_decay: float = 0.1,
                      warmup: int = 100, decay_steps: int = 10000,
                      grad_clip: float = 1.0) -> Optimizer:
    return Optimizer(lr, weight_decay, warmup, decay_steps, grad_clip)


def init_train_state(cfg: llama.LlamaConfig, generator: torch.Generator,
                     tx: Optimizer, device=None) -> TrainState:
    """Random parameters from ``generator`` on ``device`` (None = the
    card) and the optimizer's state: ``sharded_init`` on one device."""
    params = llama.init_params(cfg, generator, device)
    return TrainState(0, params, tx.init(params))


def data_sharding(mesh) -> tuple:
    """Token batches [B,S]: batch over dp+fsdp, sequence over sp (the
    DTensor placements)."""
    return llama._data_placements(mesh)


def _zip_map(fn, tree, other):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zip_map(fn, v, o) for v, o in zip(tree, other)]
    return fn(tree, other)


def _place(t: torch.Tensor, mesh, placements, device) -> torch.Tensor:
    """A full tensor -> a DTensor holding this rank's block on ``device``
    (a copy when the block is part of ``t``; ``t`` itself when whole and
    already there)."""
    if isinstance(t, QuantTensor):
        raise ValueError("int8 weights cannot be placed on a mesh")
    block = local_slice(t, mesh, placements)
    if block.numel() != t.numel() and block.device == device:
        block = block.clone(memory_format=torch.contiguous_format)
    block = block.to(device).contiguous()
    return DTensor.from_local(block, mesh, placements, run_check=False)


def shard_params(params: Params, mesh, logical_tree: Any,
                 device=None) -> Params:
    """``jax.device_put(params, param_shardings(mesh, logical_tree))``:
    every leaf a DTensor placed by its logical names, each rank keeping
    its block on ``device`` (None = the card)."""
    device = resolve_device(device)
    return _zip_map(lambda t, pl: _place(t, mesh, pl, device), params,
                    param_shardings(mesh, logical_tree))


def sharded_init(cfg: llama.LlamaConfig, mesh, generator: torch.Generator,
                 tx: Optimizer, device=None) -> TrainState:
    """Random parameters straight into their shards: each leaf is drawn
    whole (the draws of ``init_params``), the rank keeps its block and
    drops the rest, so no rank ever holds the whole tree."""
    device = resolve_device(device)
    placements = param_shardings(mesh, llama.param_logical_axes(cfg))

    def place(path, t):
        pl = placements
        for key in path:
            pl = pl[key]
        return _place(t, mesh, pl, device)

    params = llama.init_params(cfg, generator, device, place=place)
    return TrainState(0, params, tx.init(params))


def _paths(tree: Any, prefix: str = ""):
    """(path, leaf) pairs, dict keys sorted (as JAX flattens a tree)."""
    if isinstance(tree, dict):
        for k, v in sorted(tree.items()):
            yield from _paths(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}/{i}" if prefix else str(i))
    else:
        yield prefix, tree


def _local_shape(shape, mesh, placements) -> Tuple[int, ...]:
    out = list(shape)
    for i, pl in enumerate(placements):
        if pl.is_shard():
            out[pl.dim] //= mesh.size(i)
    return tuple(out)


def sharding_summary(params: Any, logical_tree: Any) -> Dict[str, str]:
    """``{param path: "logical names -> mesh axes @ local shard shape"}``:
    where every weight lives on the mesh."""
    flat_p, flat_l = list(_paths(params)), list(_paths(logical_tree))
    if len(flat_p) != len(flat_l):
        raise ValueError(
            f"params tree has {len(flat_p)} leaves but logical tree has "
            f"{len(flat_l)} — structures diverge")
    return {key: f"{names} -> {logical_spec(names)} @ "
                 f"{tuple(local(leaf).shape)}"
            for (key, leaf), (_, names) in zip(flat_p, flat_l)}


def assert_params_sharded(params: Any, mesh, logical_tree: Any) -> None:
    """Every leaf is a DTensor on ``mesh`` with exactly the placements its
    logical names prescribe and a local shard of the shape they give.
    Raises AssertionError naming the first offending leaf."""
    flat_p = list(_paths(params))
    flat_e = list(_paths(param_shardings(mesh, logical_tree)))
    assert len(flat_p) == len(flat_e), (
        f"params tree has {len(flat_p)} leaves but the logical tree "
        f"prescribes {len(flat_e)} — structures diverge")
    for (key, leaf), (_, want) in zip(flat_p, flat_e):
        assert isinstance(leaf, DTensor), (
            f"{key}: {type(leaf).__name__} has no placement (not a DTensor)")
        assert leaf.device_mesh == mesh, f"{key}: on another mesh"
        got = tuple(leaf.placements)
        assert got == tuple(want), f"{key}: placements {got} != {want}"
        shard = tuple(local(leaf).shape)
        expect = _local_shape(leaf.shape, mesh, want)
        assert shard == expect, (f"{key}: shard shape {shard} != expected "
                                 f"{expect}")


def _stack(trees: List[Any]) -> Any:
    """Per-layer trees of one structure -> one tree stacked on a leading
    layer axis (the inverse of ``_tree.unstack``)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, list):
        return [_stack([t[i] for t in trees]) for i in range(len(first))]
    return torch.stack(trees)


def train_state_tree(state: TrainState) -> Dict[str, Any]:
    """The whole training state as a tree in ``ray_tpu``'s layout:
    ``{step, params, opt: {count, mu, nu}}``. ``step`` drives the
    learning-rate schedule, ``count`` is AdamW's update count (its bias
    correction); ``mu`` and ``nu`` mirror ``params``, the moments of a
    stacked subtree stacked ``[L, ...]`` as optax keeps them, zeros before
    the first update (optax's ``adamw`` starts at zeros; torch makes its
    state at the first step). The parameters are the live tensors
    (detached), the moments of stacked subtrees fresh stacks; the caller
    copies what it keeps (``train.save_pytree`` copies to the host)."""
    opt = state.opt_state
    adam = opt.adamw.state
    params = _tree.map_leaves(local, state.params)
    counts = {int(s["step"]) for s in adam.values()}
    if len(counts) > 1:
        raise ValueError(f"AdamW's leaves disagree on their step: {counts}")
    if counts and len(adam) != len(opt.leaves):
        raise ValueError(f"AdamW holds state for {len(adam)} of "
                         f"{len(opt.leaves)} trainable tensors")

    def moment(key):
        def of(w):
            s = adam.get(w)
            return s[key] if s else torch.zeros_like(w)

        tree = {name: (_stack([_tree.map_leaves(of, v)
                               for v in opt.layers[name]])
                       if name in opt.layers else _tree.map_leaves(of, sub))
                for name, sub in params.items()}
        return _zip_map(_placed_like, tree, state.params)

    return {"step": state.step,
            "params": (state.params if opt.mesh is not None else
                       _tree.map_leaves(torch.Tensor.detach, state.params)),
            "opt": {"count": counts.pop() if counts else 0,
                    "mu": moment("exp_avg"), "nu": moment("exp_avg_sq")}}


def _placed_like(t: torch.Tensor, like) -> torch.Tensor:
    """``t``, a local block, as a DTensor placed as ``like`` is (``t``
    itself when ``like`` is no DTensor)."""
    if not isinstance(like, DTensor):
        return t
    return DTensor.from_local(t, like.device_mesh, like.placements,
                              run_check=False)


def _whole(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def train_state_from_tree(tree: Dict[str, Any], cfg: llama.LlamaConfig,
                          tx: Optimizer, device=None, mesh=None,
                          logical_tree: Any = None) -> TrainState:
    """Rebuild a ``TrainState`` from ``train_state_tree``'s layout on
    ``device`` (None = the card): the parameters copied there in their
    dtype and checked against ``cfg``'s shapes, ``tx.init`` over them (new
    layer views of the new stacked tensors), then AdamW's ``exp_avg``,
    ``exp_avg_sq`` and ``step`` written for every leaf and layer view, on
    the leaf's device (fused AdamW keeps its step there). A count of 0
    leaves AdamW's state to its first update, as a fresh state does.
    With ``mesh`` the parameters are placed by ``logical_tree`` (default
    ``llama.param_logical_axes(cfg)``) and each rank keeps its blocks of
    the parameters and moments; the tree's leaves may be whole tensors or
    DTensors (a sharded state's ``train_state_tree``)."""
    device = resolve_device(device)
    shapes = llama.param_shapes(cfg)

    def place(t, shape, name):
        t = _whole(t)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")
        if mesh is not None:
            return t.detach()
        return t.detach().to(device, copy=True).contiguous()

    def placed(sub, shape, name):
        if isinstance(shape, dict):
            if not isinstance(sub, dict) or set(sub) != set(shape):
                got = sorted(sub) if isinstance(sub, dict) else type(sub)
                raise ValueError(f"{name}: keys {got}, expected "
                                 f"{sorted(shape)}")
            return {k: placed(v, shape[k], f"{name}.{k}")
                    for k, v in sub.items()}
        return place(sub, shape, name)

    params = placed(tree["params"], shapes, "params")
    if mesh is not None:
        params = shard_params(params, mesh, logical_tree
                              or llama.param_logical_axes(cfg), device)
    opt = tx.init(params)
    count = int(tree["opt"]["count"])
    if count:
        group = opt.adamw.param_groups[0]
        on_leaf = group["fused"] or group["capturable"]
        scalar = _get_scalar_dtype(is_fused=group["fused"])

        def blocks(moments, name):
            """The rank's blocks of one subtree's moments, in leaf order."""
            return [local_slice(_whole(m), mesh, p.placements)
                    if mesh is not None else m
                    for m, p in zip(_tree.leaves(moments[name]),
                                    _tree.leaves(params[name]))]

        mu, nu = tree["opt"]["mu"], tree["opt"]["nu"]
        pairs = []
        for name, sub in params.items():
            mus, nus = blocks(mu, name), blocks(nu, name)
            if name in opt.layers:
                for i, view in enumerate(opt.layers[name]):
                    pairs += zip(_tree.leaves(view), [m[i] for m in mus],
                                 [v[i] for v in nus])
            else:
                pairs += zip(_tree.leaves(_tree.map_leaves(local, sub)),
                             mus, nus)
        for w, m, v in pairs:
            if not w.requires_grad:
                continue
            opt.adamw.state[w] = {
                "step": torch.tensor(float(count), dtype=scalar,
                                     device=w.device if on_leaf else "cpu"),
                "exp_avg": torch.empty_like(w).copy_(m),
                "exp_avg_sq": torch.empty_like(w).copy_(v)}
    return TrainState(int(tree["step"]), params, opt)


def from_jax_train_state(tree: Any, cfg: llama.LlamaConfig, tx: Optimizer,
                         device=None, mesh=None,
                         logical_tree: Any = None) -> TrainState:
    """``ray_tpu``'s ``TrainState`` as numpy arrays (the caller does
    ``jax.device_get``) -> this module's, on ``device``: the state
    counterpart of ``llama.from_jax_params``. ``ray_tpu``'s ``opt_state``
    is ``default_optimizer``'s chain, ``(EmptyState, (ScaleByAdamState(
    count, mu, nu), EmptyState, ScaleByScheduleState(count)))``; read by
    position, so any tuples of that shape do. ``mesh`` and
    ``logical_tree`` as ``train_state_from_tree`` takes them."""
    step, params, opt_state = tree
    count, mu, nu = opt_state[1][0]
    shapes = llama.param_shapes(cfg)
    cpu = torch.device("cpu")

    def moments(m, name):
        return _tree.from_numpy(m, shapes, cfg.dtype, cpu, name)

    return train_state_from_tree(
        {"step": int(step),
         "params": llama.from_jax_params(params, cfg, cpu),
         "opt": {"count": int(count), "mu": moments(mu, "mu"),
                 "nu": moments(nu, "nu")}}, cfg, tx, device, mesh,
        logical_tree)


def make_train_step(cfg: llama.LlamaConfig, tx: Optimizer, mesh=None
                    ) -> Callable[[TrainState, torch.Tensor],
                                  Tuple[TrainState, Metrics]]:
    """(state, tokens [B,S]) -> (state, metrics): the loss and its
    gradients, then ``tx`` in place. Metrics: ``loss``, ``ppl_log`` and
    ``grad_norm`` (before clipping), 0-dim tensors on the parameters'
    device. With ``mesh`` the state's parameters are DTensors
    (``sharded_init`` / ``shard_params``), ``tokens`` the global batch
    (every rank passes the same, or a DTensor), and the metrics are the
    global batch's on every rank."""

    def step_fn(state: TrainState, tokens: torch.Tensor):
        opt = state.opt_state
        loss, metrics = llama.loss_fn(state.params, tokens, cfg, mesh=mesh,
                                      layers=opt.layers["blocks"])
        loss.backward()
        gnorm = tx.update(opt, state.step)
        return (TrainState(state.step + 1, state.params, opt),
                dict(metrics, grad_norm=gnorm))

    # Budget 1: a steady-state trainer runs ONE step signature — shape
    # churn per step is the costliest silent bug a training loop has.
    # The RTPU_DEBUG_CUDA witness reports it; off, the step is returned
    # untouched.
    return cuda_debug.wrap_program(step_fn, "spmd.train_step", budget=1)


def make_eval_step(cfg: llama.LlamaConfig, mesh=None):
    """(params, tokens) -> metrics of ``llama.loss_fn``, no gradients."""

    def eval_fn(params: llama.Params, tokens: torch.Tensor) -> Metrics:
        with torch.no_grad():
            _, metrics = llama.loss_fn(params, tokens, cfg, mesh=mesh)
        return metrics

    return cuda_debug.wrap_program(eval_fn, "spmd.eval_step", budget=1)
