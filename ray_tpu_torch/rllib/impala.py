"""IMPALA: actor-learner RL with the V-trace off-policy correction
(``ray_tpu/rllib/impala.py``), local path.

The V-trace update (importance ratios, the reverse recursion for the
targets, policy/value/entropy losses, one clipped Adam step) runs eagerly
on the learner's device; the recursion is a reverse loop over T, one
fused multiply-add a step, over the detached values and ratios, as
``ray_tpu``'s ``stop_gradient``s make it. ``ray_tpu``'s asynchronous
runners (one rollout in flight per runner actor, consumed as each lands)
are actors of its runtime: ``num_env_runners > 0`` raises here until the
port has that runtime.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.rllib import models
from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.env_runner import EnvRunner, require_local
from ray_tpu_torch.rllib.learner import Adam, host_stats, to_tensors


class IMPALALearner:
    """V-trace actor-critic update, one SGD pass a batch. ``device=None``
    is the card."""

    STATS = ("total_loss", "policy_loss", "vf_loss", "entropy",
             "mean_vtrace_rho")

    def __init__(self, obs_size: int, num_actions: int, *,
                 hidden: int = 64, lr: float = 5e-4, gamma: float = 0.99,
                 vtrace_rho_clip: float = 1.0, vtrace_c_clip: float = 1.0,
                 vtrace_pg_rho_clip: Optional[float] = None,
                 vf_coef: float = 0.5, entropy_coef: float = 0.01,
                 max_grad_norm: float = 40.0, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.gamma = gamma
        self.rho_clip = vtrace_rho_clip
        self.c_clip = vtrace_c_clip
        # Separate clip for the policy-gradient advantage's rho.
        self.pg_rho_clip = (vtrace_rho_clip if vtrace_pg_rho_clip is None
                            else vtrace_pg_rho_clip)
        self.vf_coef = vf_coef
        self.entropy_coef = entropy_coef
        self.params = models.init_policy_params(
            torch.Generator().manual_seed(seed), obs_size, num_actions,
            hidden, self.device)
        self.optimizer = Adam(self.params, lr, eps=1e-5,
                              max_grad_norm=max_grad_norm)

    def get_weights(self):
        return self.params

    def set_weights(self, params) -> None:
        models.assign_(self.params, params)

    def update_from_batch(self, batch: Dict[str, np.ndarray]
                          ) -> Dict[str, float]:
        b = to_tensors(batch, self.device)
        T, B = b["actions"].shape
        logits, value = models.policy_apply(self.params,
                                            b["obs"].reshape(T * B, -1))
        logits = logits.reshape(T, B, -1)
        values = value.reshape(T, B)
        logp_all = torch.log_softmax(logits, -1)
        logp = logp_all.gather(-1, b["actions"][..., None])[..., 0]
        ratio = torch.exp(logp - b["logp"])
        rho = torch.clamp(ratio, max=self.rho_clip)
        pg_rho = torch.clamp(ratio, max=self.pg_rho_clip)
        with torch.no_grad():
            vs, pg_adv = self._vtrace(values.detach(), b["last_value"], b,
                                      rho.detach(), pg_rho.detach())
        pi_loss = -(pg_adv * logp).mean()
        vf_loss = 0.5 * ((values - vs) ** 2).mean()
        entropy = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
        total = (pi_loss + self.vf_coef * vf_loss
                 - self.entropy_coef * entropy)
        grads = torch.autograd.grad(total, self.optimizer.leaves)
        self.optimizer.step(grads)
        return host_stats(self.STATS, [x.detach() for x in (
            total, pi_loss, vf_loss, entropy, rho.mean())])

    # ------------------------------------------------------------- impl

    def _vtrace(self, values: torch.Tensor, last_value: torch.Tensor,
                batch: Dict[str, torch.Tensor], rho: torch.Tensor,
                pg_rho: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Reverse V-trace targets (Espeholt et al. 2018).

        values: learner V(x_t) [T, B]; rho: clipped importance ratios
        [T, B] for the vs recursion; pg_rho (defaults to rho): separately
        clipped ratios for the policy-gradient advantage. Truncated steps
        bootstrap from the recorded value of the pre-reset final
        observation; terminated steps zero the continuation."""
        rewards = batch["rewards"]
        terminated = batch["terminated"].float()
        truncated = batch["truncated"].float()
        bootstrap = batch["bootstrap_value"]
        done = torch.clamp(terminated + truncated, 0.0, 1.0)

        v_next = torch.cat([values[1:], last_value[None]], 0)
        v_next = (1.0 - done) * v_next + truncated * bootstrap
        not_terminal = 1.0 - terminated
        c = torch.clamp(rho, max=self.c_clip)
        delta = rho * (rewards + self.gamma * v_next * not_terminal - values)
        coef = self.gamma * c * (1.0 - done)
        vs_minus_v = torch.empty_like(delta)
        acc = torch.zeros_like(delta[0])
        for t in range(delta.shape[0] - 1, -1, -1):
            acc = torch.addcmul(delta[t], coef[t], acc, out=vs_minus_v[t])
        vs = values + vs_minus_v

        # vs_{t+1} for the policy-gradient advantage, with the same
        # boundary handling as v_next.
        vs_next = torch.cat([vs[1:], last_value[None]], 0)
        vs_next = (1.0 - done) * vs_next + truncated * bootstrap
        if pg_rho is None:
            pg_rho = rho
        pg_adv = pg_rho * (rewards + self.gamma * vs_next * not_terminal
                           - values)
        return vs, pg_adv


@dataclasses.dataclass
class IMPALAConfig:
    """Fluent config (reference: IMPALAConfig fluent API)."""

    env: Union[str, Callable] = "CartPole"
    num_env_runners: int = 0
    num_envs_per_runner: int = 8
    rollout_len: int = 64
    hidden: int = 64
    lr: float = 5e-4
    gamma: float = 0.99
    vtrace_rho_clip: float = 1.0
    vtrace_c_clip: float = 1.0
    vtrace_pg_rho_clip: Optional[float] = None  # None -> vtrace_rho_clip
    vf_coef: float = 0.5
    entropy_coef: float = 0.01
    max_grad_norm: float = 40.0
    seed: int = 0
    device: Any = None

    def environment(self, env) -> "IMPALAConfig":
        self.env = env
        return self

    def env_runners(self, *, num_env_runners: int = None,
                    num_envs_per_env_runner: int = None,
                    rollout_fragment_length: int = None) -> "IMPALAConfig":
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_env_runner is not None:
            self.num_envs_per_runner = num_envs_per_env_runner
        if rollout_fragment_length is not None:
            self.rollout_len = rollout_fragment_length
        return self

    def training(self, *, lr: float = None, gamma: float = None,
                 vtrace_clip_rho_threshold: float = None,
                 vtrace_clip_pg_rho_threshold: float = None,
                 vf_loss_coeff: float = None, entropy_coeff: float = None,
                 grad_clip: float = None) -> "IMPALAConfig":
        for name, val in (("lr", lr), ("gamma", gamma),
                          ("vtrace_rho_clip", vtrace_clip_rho_threshold),
                          ("vtrace_pg_rho_clip",
                           vtrace_clip_pg_rho_threshold),
                          ("vf_coef", vf_loss_coeff),
                          ("entropy_coef", entropy_coeff),
                          ("max_grad_norm", grad_clip)):
            if val is not None:
                setattr(self, name, val)
        return self

    def build(self) -> "IMPALA":
        return IMPALA(self)


class IMPALA:
    """The local actor-learner loop: sample, update, re-sync the runner."""

    def __init__(self, config: IMPALAConfig):
        require_local("num_env_runners (IMPALA's asynchronous runners)",
                      config.num_env_runners)
        self.config = config
        probe = make_env(config.env, num_envs=1, seed=config.seed)
        self.learner = IMPALALearner(
            probe.observation_size, probe.num_actions,
            hidden=config.hidden, lr=config.lr, gamma=config.gamma,
            vtrace_rho_clip=config.vtrace_rho_clip,
            vtrace_c_clip=config.vtrace_c_clip,
            vtrace_pg_rho_clip=config.vtrace_pg_rho_clip,
            vf_coef=config.vf_coef, entropy_coef=config.entropy_coef,
            max_grad_norm=config.max_grad_norm, seed=config.seed,
            device=config.device)
        self._iteration = 0
        self._total_steps = 0
        self._local = EnvRunner(config.env, config.num_envs_per_runner,
                                config.rollout_len, config.seed,
                                config.device)
        self._local.set_weights(self.learner.get_weights())

    # ------------------------------------------------------------- train

    def training_step(self) -> Dict[str, Any]:
        batch = self._local.sample()
        stats = self.learner.update_from_batch(batch)
        self._local.set_weights(self.learner.get_weights())
        self._total_steps += int(np.prod(batch["actions"].shape))
        return stats

    def train(self) -> Dict[str, Any]:
        t0 = time.monotonic()
        learner_stats = self.training_step()
        self._iteration += 1
        m = self._local.get_metrics()
        return {
            "training_iteration": self._iteration,
            "num_env_steps_sampled_lifetime": self._total_steps,
            "time_this_iter_s": time.monotonic() - t0,
            "env_runners": {
                "episode_return_mean": m["episode_return_mean"],
                "num_episodes": m["num_episodes"],
            },
            "learners": {"default_policy": learner_stats},
        }

    def get_weights(self):
        return self.learner.get_weights()

    def set_weights(self, params) -> None:
        self.learner.set_weights(params)

    def stop(self) -> None:
        pass
