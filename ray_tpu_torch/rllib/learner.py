"""PPO Learner: GAE + clipped-surrogate minibatch SGD
(``ray_tpu/rllib/learner.py``).

``ray_tpu`` runs the whole update (GAE, advantage normalisation, E epochs
x M minibatches of Adam steps) as one jitted function with two
``lax.scan``s. Here it runs eagerly on the learner's device: GAE is a
reverse loop over T, one fused multiply-add a step; the epochs and
minibatches are Python loops of forward, ``torch.autograd.grad`` and an
in-place optimizer step. The stats of every minibatch step stay on the
device and reach the host in one copy per update.

Also here, for every learner of the package:

- ``Adam``: optax's ``chain(clip_by_global_norm(max_norm), adam(lr,
  eps=eps))`` over a tree's tensors, in place. The clip scales by
  ``max_norm / norm`` only where the norm is not below ``max_norm``, with
  no epsilon (``clip_grad_norm_`` adds 1e-6); then ``torch.optim.Adam``
  (optax's arithmetic: bias-corrected moments, eps outside the root;
  PyTorch's fused kernel on the card);
- ``to_tensors``: a numpy batch -> tensors on the device, every float or
  bool column f32 (JAX runs with x64 off) and the discrete actions int64.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.rllib import models

Stats = Dict[str, float]


class Adam:
    """``optax.chain(clip_by_global_norm(max_grad_norm), adam(lr,
    eps=eps))`` (no clip when ``max_grad_norm`` is None) over the tensors
    of ``params``, which it marks trainable and updates in place."""

    def __init__(self, params: Any, lr: float, *, eps: float = 1e-8,
                 max_grad_norm: Optional[float] = None):
        self.leaves = models.leaves(params)
        for p in self.leaves:
            p.requires_grad_(True)
        self.max_grad_norm = max_grad_norm
        self.opt = torch.optim.Adam(
            self.leaves, lr=lr, eps=eps,
            fused=self.leaves[0].device.type == "cuda")

    def step(self, grads: Sequence[torch.Tensor]) -> None:
        grads = list(grads)
        if self.max_grad_norm is not None:
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads, 2)))
            scale = torch.where(norm < self.max_grad_norm,
                                torch.ones_like(norm),
                                self.max_grad_norm / norm)
            grads = torch._foreach_mul(grads, scale)
        for p, g in zip(self.leaves, grads):
            p.grad = g
        self.opt.step()
        for p in self.leaves:
            p.grad = None

    def moments(self) -> list:
        """(exp_avg, exp_avg_sq) of every leaf, optax's (mu, nu)."""
        return [(self.opt.state[p]["exp_avg"], self.opt.state[p]["exp_avg_sq"])
                for p in self.leaves]


def to_tensors(batch: Dict[str, Any], device: torch.device,
               int_keys: Sequence[str] = ("actions",)
               ) -> Dict[str, torch.Tensor]:
    """Every array column of ``batch`` on ``device``: ``int_keys`` int64,
    the rest f32. Other entries (counts, metrics) are left out."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, (np.ndarray, torch.Tensor)):
            dtype = torch.int64 if k in int_keys else torch.float32
            out[k] = torch.as_tensor(v).to(device, dtype)
    return out


def host_stats(names: Sequence[str], values: Sequence[torch.Tensor]
               ) -> Stats:
    """0-dim tensors -> floats, in one copy to the host."""
    return dict(zip(names, torch.stack(list(values)).tolist()))


def gae(values: torch.Tensor, rewards: torch.Tensor,
        terminated: torch.Tensor, truncated: torch.Tensor,
        bootstrap: torch.Tensor, last_value: torch.Tensor, gamma: float,
        lam: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reverse GAE over [T, B] f32 tensors -> (advantages, targets).
    Truncated steps bootstrap from the critic's value of the final
    (pre-reset) observation; terminated steps zero the continuation; the
    chain is cut at every done."""
    done = torch.clamp(terminated + truncated, 0.0, 1.0)
    v_next = torch.cat([values[1:], last_value[None]], 0)
    v_next = (1.0 - done) * v_next + truncated * bootstrap
    delta = rewards + gamma * v_next * (1.0 - terminated) - values
    coef = gamma * lam * (1.0 - done)
    adv = torch.empty_like(delta)
    carry = torch.zeros_like(delta[0])
    for t in range(delta.shape[0] - 1, -1, -1):
        carry = torch.addcmul(delta[t], coef[t], carry, out=adv[t])
    return adv, adv + values


class PPOLearner:
    """Owns the policy's parameters and optimizer; ``update_from_batch``
    runs one PPO update. ``device=None`` is the card."""

    STATS = ("total_loss", "policy_loss", "vf_loss", "entropy", "mean_kl")

    def __init__(self, obs_size: int, num_actions: int, *,
                 hidden: int = 64, lr: float = 3e-4,
                 gamma: float = 0.99, gae_lambda: float = 0.95,
                 clip_eps: float = 0.2, vf_coef: float = 0.5,
                 entropy_coef: float = 0.01, num_epochs: int = 4,
                 minibatch_size: int = 256, max_grad_norm: float = 0.5,
                 seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.gamma = gamma
        self.gae_lambda = gae_lambda
        self.clip_eps = clip_eps
        self.vf_coef = vf_coef
        self.entropy_coef = entropy_coef
        self.num_epochs = num_epochs
        self.minibatch_size = minibatch_size
        self.params = models.init_policy_params(
            torch.Generator().manual_seed(seed), obs_size, num_actions,
            hidden, self.device)
        self.optimizer = Adam(self.params, lr, eps=1e-5,
                              max_grad_norm=max_grad_norm)
        self._gen = torch.Generator(self.device).manual_seed(seed)

    # ------------------------------------------------------------- public

    def get_weights(self):
        """The learner's parameter tree (its live tensors)."""
        return self.params

    def set_weights(self, params) -> None:
        models.assign_(self.params, params)

    def update_from_batch(self, batch: Dict[str, np.ndarray],
                          perms: Optional[np.ndarray] = None) -> Stats:
        """batch: stacked rollouts [T, B] (obs/actions/logp/values/rewards/
        terminated/truncated/bootstrap_value + last_value [B]). ``perms``
        [num_epochs, >= n_mb * mb]: each epoch's row order (default: a
        permutation a epoch from the learner's generator). Returns the
        mean of each stat over every minibatch step."""
        b = to_tensors(batch, self.device)
        adv, targets = self._gae(b)
        T, B = b["actions"].shape
        n = T * B
        obs = b["obs"].reshape(n, -1)
        actions = b["actions"].reshape(n)
        logp_old = b["logp"].reshape(n)
        adv = adv.reshape(n)
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        targets = targets.reshape(n)
        mb = min(self.minibatch_size, n)
        n_mb = max(1, n // mb)
        if perms is None:
            perms = torch.stack([
                torch.randperm(n, generator=self._gen, device=self.device)
                for _ in range(self.num_epochs)])
        perms = torch.as_tensor(perms).to(self.device, torch.int64)
        leaves = self.optimizer.leaves
        stats = []
        for epoch in range(self.num_epochs):
            for idx in perms[epoch, :n_mb * mb].view(n_mb, mb):
                total, aux = self._loss(obs[idx], actions[idx],
                                        logp_old[idx], adv[idx],
                                        targets[idx])
                grads = torch.autograd.grad(total, leaves)
                self.optimizer.step(grads)
                stats.append(torch.stack([total.detach(), *aux]))
        return dict(zip(self.STATS, torch.stack(stats).mean(0).tolist()))

    # ------------------------------------------------------------- impl

    def _gae(self, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        return gae(batch["values"], batch["rewards"],
                   batch["terminated"], batch["truncated"],
                   batch["bootstrap_value"], batch["last_value"],
                   self.gamma, self.gae_lambda)

    def _loss(self, obs, actions, logp_old, adv, targets):
        logits, value = models.policy_apply(self.params, obs)
        logp_all = torch.log_softmax(logits, -1)
        logp = logp_all.gather(-1, actions[:, None])[:, 0]
        ratio = torch.exp(logp - logp_old)
        unclipped = ratio * adv
        clipped = torch.clamp(ratio, 1.0 - self.clip_eps,
                              1.0 + self.clip_eps) * adv
        pi_loss = -torch.minimum(unclipped, clipped).mean()
        vf_loss = 0.5 * ((value - targets) ** 2).mean()
        entropy = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
        total = (pi_loss + self.vf_coef * vf_loss
                 - self.entropy_coef * entropy)
        kl = (logp_old - logp).mean()
        return total, [x.detach() for x in (pi_loss, vf_loss, entropy, kl)]
