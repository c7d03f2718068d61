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

The mesh argument, FSDP and tensor parallelism wait for the multi-chip
slice (ROADMAP).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, NamedTuple, Sequence, Tuple

import torch
from torch.optim.optimizer import _get_scalar_dtype

from ray_tpu_torch import resolve_device
from ray_tpu_torch.models import _tree, llama
from ray_tpu_torch.models.quant import QuantTensor

Metrics = Dict[str, torch.Tensor]
Params = Dict[str, Any]


class OptState(NamedTuple):
    leaves: List[torch.Tensor]    # every trainable tensor, in update order
    # Per stacked subtree, per layer: the layer's leaf views.
    layers: Dict[str, List[Dict[str, torch.Tensor]]]
    adamw: torch.optim.AdamW


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
        top = [t for name, sub in params.items() if name not in stacked
               for t in _tree.leaves(sub) if t.is_floating_point()]
        for t in top:
            t.requires_grad_(True)
        layers = {name: [_tree.map_leaves(
            lambda w: w.detach().requires_grad_(w.is_floating_point()), view)
            for view in _tree.unstack(params[name])] for name in stacked}
        leaves = top + [w for views in layers.values()
                        for w in _tree.leaves(views) if w.requires_grad]
        adamw = torch.optim.AdamW(
            leaves, lr=0.0, betas=(self.b1, self.b2), eps=self.eps,
            weight_decay=self.weight_decay,
            fused=leaves[0].device.type == "cuda")
        return OptState(leaves, layers, adamw)

    def update(self, opt: OptState, step: int) -> torch.Tensor:
        """Clip the gradients by their global norm, take the AdamW step at
        ``schedule(step)`` and free the gradients. Returns the norm before
        clipping (a 0-dim f32 tensor; no host sync)."""
        grads = [p.grad for p in opt.leaves]
        if any(g is None for g in grads):
            raise RuntimeError("a trainable tensor got no gradient")
        norms = torch._foreach_norm(grads, 2, dtype=torch.float32)
        gnorm = torch.linalg.vector_norm(torch.stack(norms))
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

        return {name: (_stack([_tree.map_leaves(of, v)
                               for v in opt.layers[name]])
                       if name in opt.layers else _tree.map_leaves(of, sub))
                for name, sub in state.params.items()}

    return {"step": state.step,
            "params": _tree.map_leaves(torch.Tensor.detach, state.params),
            "opt": {"count": counts.pop() if counts else 0,
                    "mu": moment("exp_avg"), "nu": moment("exp_avg_sq")}}


def train_state_from_tree(tree: Dict[str, Any], cfg: llama.LlamaConfig,
                          tx: Optimizer, device=None) -> TrainState:
    """Rebuild a ``TrainState`` from ``train_state_tree``'s layout on
    ``device`` (None = the card): the parameters copied there in their
    dtype and checked against ``cfg``'s shapes, ``tx.init`` over them (new
    layer views of the new stacked tensors), then AdamW's ``exp_avg``,
    ``exp_avg_sq`` and ``step`` written for every leaf and layer view, on
    the leaf's device (fused AdamW keeps its step there). A count of 0
    leaves AdamW's state to its first update, as a fresh state does."""
    device = resolve_device(device)
    shapes = llama.param_shapes(cfg)

    def place(t, shape, name):
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")
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
    opt = tx.init(params)
    count = int(tree["opt"]["count"])
    if count:
        group = opt.adamw.param_groups[0]
        on_leaf = group["fused"] or group["capturable"]
        scalar = _get_scalar_dtype(is_fused=group["fused"])
        mu, nu = tree["opt"]["mu"], tree["opt"]["nu"]
        pairs = []
        for name, sub in params.items():
            if name in opt.layers:
                for i, view in enumerate(opt.layers[name]):
                    pairs += zip(_tree.leaves(view),
                                 _tree.leaves(_tree.map_leaves(
                                     lambda m, i=i: m[i], mu[name])),
                                 _tree.leaves(_tree.map_leaves(
                                     lambda v, i=i: v[i], nu[name])))
            else:
                pairs += zip(_tree.leaves(sub), _tree.leaves(mu[name]),
                             _tree.leaves(nu[name]))
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
                         device=None) -> TrainState:
    """``ray_tpu``'s ``TrainState`` as numpy arrays (the caller does
    ``jax.device_get``) -> this module's, on ``device``: the state
    counterpart of ``llama.from_jax_params``. ``ray_tpu``'s ``opt_state``
    is ``default_optimizer``'s chain, ``(EmptyState, (ScaleByAdamState(
    count, mu, nu), EmptyState, ScaleByScheduleState(count)))``; read by
    position, so any tuples of that shape do."""
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
                 "nu": moments(nu, "nu")}}, cfg, tx, device)


def make_train_step(cfg: llama.LlamaConfig, tx: Optimizer
                    ) -> Callable[[TrainState, torch.Tensor],
                                  Tuple[TrainState, Metrics]]:
    """(state, tokens [B,S]) -> (state, metrics): the loss and its
    gradients, then ``tx`` in place. Metrics: ``loss``, ``ppl_log`` and
    ``grad_norm`` (before clipping), 0-dim tensors on the parameters'
    device."""

    def step_fn(state: TrainState, tokens: torch.Tensor):
        opt = state.opt_state
        loss, metrics = llama.loss_fn(state.params, tokens, cfg,
                                      layers=opt.layers["blocks"])
        loss.backward()
        gnorm = tx.update(opt, state.step)
        return (TrainState(state.step + 1, state.params, opt),
                dict(metrics, grad_norm=gnorm))

    return step_fn


def make_eval_step(cfg: llama.LlamaConfig):
    """(params, tokens) -> metrics of ``llama.loss_fn``, no gradients."""

    def eval_fn(params: llama.Params, tokens: torch.Tensor) -> Metrics:
        with torch.no_grad():
            _, metrics = llama.loss_fn(params, tokens, cfg)
        return metrics

    return eval_fn
