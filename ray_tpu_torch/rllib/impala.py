"""IMPALA: actor-learner RL with the V-trace off-policy correction
(``ray_tpu/rllib/impala.py``).

The V-trace update (importance ratios, the reverse recursion for the
targets, policy/value/entropy losses, one clipped Adam step) runs eagerly
on the learner's device; the recursion is a reverse loop over T, one
fused multiply-add a step, over the detached values and ratios, as
``ray_tpu``'s ``stop_gradient``s make it.

``num_env_runners > 0`` runs the asynchronous loop: ``EnvRunner`` actors
on the CPU (``env_runner.py``'s rule), one rollout in flight per runner,
its metrics riding on it (``sample(include_metrics=True)``). Each
``training_step`` takes whichever rollout lands first
(``ray_tpu_torch.wait``), updates, and re-arms that runner with a host
snapshot of the fresh weights, while the others keep sampling with their
stale ones.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch import resolve_device
from ray_tpu_torch.rllib import models
from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.env_runner import (EnvRunnerGroup, host_weights,
                                            merge_runner_metrics)
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
    """The actor-learner loop: local, or asynchronous over runner
    actors."""

    def __init__(self, config: IMPALAConfig):
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
        self.env_runners = EnvRunnerGroup(
            config.env, num_env_runners=config.num_env_runners,
            num_envs_per_runner=config.num_envs_per_runner,
            rollout_len=config.rollout_len, seed=config.seed,
            device=config.device)
        self.env_runners.sync_weights(self.learner.get_weights())
        self._inflight: Dict[Any, Any] = {}  # rollout ref -> its runner
        self._cached_metrics: Dict[int, Dict[str, Any]] = {}
        # One rollout in flight per runner actor. Metrics ride the
        # rollouts: a get_metrics call would queue behind the runner's
        # next sample.
        for a in self.env_runners.actors:
            self._inflight[a.sample.remote(True)] = a

    # ------------------------------------------------------------- train

    def _merge_metrics(self, key: int, m: Dict[str, Any]) -> None:
        """Episode-count-weighted merge of one runner's successive
        piggybacked metrics (several rollouts may land between train()
        calls)."""
        prev = self._cached_metrics.get(key)
        if prev is None:
            self._cached_metrics[key] = dict(m)
            return
        n1 = prev.get("num_episodes", 0)
        n2 = m.get("num_episodes", 0)
        r1, r2 = prev.get("episode_return_mean"), m.get("episode_return_mean")
        if r2 is not None:
            prev["episode_return_mean"] = (
                r2 if r1 is None else (r1 * n1 + r2 * n2) / max(n1 + n2, 1))
        prev["num_episodes"] = n1 + n2

    def training_step(self) -> Dict[str, Any]:
        """Local: sample, update, re-sync. Asynchronous: consume the first
        rollout to land, update, re-arm its runner with fresh weights."""
        if not self.env_runners.actors:
            (batch,) = self.env_runners.sample()
            stats = self.learner.update_from_batch(batch)
            self.env_runners.sync_weights(self.learner.get_weights())
            self._total_steps += int(np.prod(batch["actions"].shape))
            return stats
        ready, _ = ray_tpu_torch.wait(list(self._inflight), num_returns=1,
                                      timeout=120)
        if not ready:
            raise TimeoutError("no rollout completed within 120s")
        actor = self._inflight.pop(ready[0])
        batch = ray_tpu_torch.get(ready[0])
        m = batch.pop("metrics", None)
        if m is not None:
            self._merge_metrics(id(actor), m)
        stats = self.learner.update_from_batch(batch)
        # The runner that finished gets fresh weights and is re-armed at
        # once (its calls run in order); the others sample on with theirs.
        actor.set_weights.remote(ray_tpu_torch.put(
            host_weights(self.learner.get_weights())))
        self._inflight[actor.sample.remote(True)] = actor
        self._total_steps += int(np.prod(batch["actions"].shape))
        return stats

    def train(self) -> Dict[str, Any]:
        t0 = time.monotonic()
        learner_stats = self.training_step()
        self._iteration += 1
        if not self.env_runners.actors:
            metrics = self.env_runners.get_metrics()
        else:
            # Only metrics that rode consumed rollouts: never a blocking
            # get_metrics behind in-flight samples.
            metrics = list(self._cached_metrics.values())
            self._cached_metrics.clear()
        return {
            "training_iteration": self._iteration,
            "num_env_steps_sampled_lifetime": self._total_steps,
            "time_this_iter_s": time.monotonic() - t0,
            "env_runners": merge_runner_metrics(metrics),
            "learners": {"default_policy": learner_stats},
        }

    def get_weights(self):
        return self.learner.get_weights()

    def set_weights(self, params) -> None:
        self.learner.set_weights(params)

    def stop(self) -> None:
        self.env_runners.stop()
