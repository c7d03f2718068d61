"""The training step on one card (``ray_tpu/parallel/spmd.py``).

``ray_tpu`` jits one program over a mesh: ``value_and_grad`` of
``llama.loss_fn``, then optax's chain (clip by global norm, AdamW with a
warmup-cosine schedule), the buffers donated so the step is in place. Here
the step runs eagerly on one card and updates the parameters in place:

- the parameters stay the stacked ``llama`` tree (``ray_tpu``'s layout);
  ``tx.init`` makes each layer's block weights a leaf view of that tree,
  so each layer's gradient lands in its own tensor (a gradient through a
  slice of the stacked tensor would build a full-size zero tensor per
  layer) and the optimizer's in-place updates write the tree;
- ``default_optimizer`` reproduces optax's chain: the global norm of every
  gradient in f32, a scale of ``max_norm / norm`` only when the norm is not
  below ``max_norm`` (no epsilon, unlike ``clip_grad_norm_``), then AdamW
  (b1 0.9, b2 0.95, eps 1e-8, decay on every leaf, moments in the
  parameters' dtype as optax keeps them) at the schedule's rate for the
  step, which is 0 at step 0. On the card the AdamW update is PyTorch's
  fused kernel (``ray_tpu`` leaves the update to XLA; there is no Pallas
  kernel there either).

The mesh argument, FSDP and tensor parallelism wait for the multi-chip
slice (ROADMAP).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, NamedTuple, Tuple

import torch

from ray_tpu_torch.models import llama
from ray_tpu_torch.models.quant import QuantTensor

Metrics = Dict[str, torch.Tensor]


class OptState(NamedTuple):
    leaves: List[torch.Tensor]    # every trainable tensor, in update order
    layers: List[Dict[str, torch.Tensor]]  # per-layer leaf views
    adamw: torch.optim.AdamW


class TrainState(NamedTuple):
    step: int
    params: llama.Params
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

    def init(self, params: llama.Params) -> OptState:
        """Mark the trainable tensors (the non-block leaves of ``params``
        and a leaf view of each layer's block weights) and make AdamW's
        state for them (its moments appear at the first update)."""
        blocks = params["blocks"]
        if any(isinstance(w, QuantTensor) for w in params.values()) or any(
                isinstance(w, QuantTensor) for w in blocks.values()):
            raise ValueError("int8 weights are not trainable")
        top = [params[n] for n in ("embed", "ln_out", "lm_head")
               if n in params]
        for t in top:
            t.requires_grad_(True)
        layers = [{name: w[i].detach().requires_grad_(True)
                   for name, w in blocks.items()}
                  for i in range(len(blocks["ln_attn"]))]
        leaves = top + [w for layer in layers for w in layer.values()]
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
                                      layers=opt.layers)
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
