"""SAC: soft actor-critic for continuous control (``ray_tpu/rllib/sac.py``).

Twin-Q critics with Polyak-averaged targets, a tanh-squashed Gaussian
actor and a learned temperature, as ``ray_tpu``'s. Both gradients come
from the state before either update: the critic's against the soft TD
target (actor, target critic and alpha before the step), the actor's
through the pre-update critic. The actor loss is differentiated with
``torch.autograd.grad`` over the actor's tensors only, so nothing lands in
the critic's. Three Adams (actor, critic, the 0-dim ``log_alpha``), then
the Polyak step ``(1 - tau) * target + tau * critic``.

``ray_tpu`` splits its state's key into (key, next, pi) each update; the
port draws the next-action and the actor's noise, in that order, from
the learner's generator unless ``compute_grads`` is given them. Only the
local runner and learner are ported.
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
from ray_tpu_torch.rllib.env_runner import obs_tensor, require_local
from ray_tpu_torch.rllib.learner import Adam, host_stats, to_tensors
from ray_tpu_torch.rllib.learner_group import LearnerGroup
from ray_tpu_torch.rllib.replay_buffers import ReplayBuffer

_COLUMNS = ("obs", "actions", "rewards", "next_obs", "dones")


class SACLearner:
    """Twin-Q soft actor-critic. ``device=None`` is the card."""

    STATS = ("critic_loss", "actor_loss", "alpha_loss", "alpha", "q_mean",
             "entropy")

    def __init__(self, obs_size: int, act_size: int, *, hidden: int = 64,
                 actor_lr: float = 3e-4, critic_lr: float = 3e-4,
                 alpha_lr: float = 3e-4, gamma: float = 0.99,
                 tau: float = 0.005, act_scale: float = 1.0,
                 target_entropy: Optional[float] = None, seed: int = 0,
                 device=None):
        self.device = resolve_device(device)
        self.gamma = gamma
        self.tau = tau
        self.act_scale = act_scale
        # Reference default: -dim(A) (target_entropy="auto").
        self.target_entropy = (-float(act_size) if target_entropy is None
                               else float(target_entropy))
        self.act_size = act_size
        g = torch.Generator().manual_seed(seed)
        self.actor = models.init_squashed_gaussian_params(
            g, obs_size, act_size, hidden, self.device)
        self.critic = models.init_twin_q_params(g, obs_size, act_size,
                                                hidden, self.device)
        self.target_critic = models.snapshot(self.critic, self.device)
        self.log_alpha = torch.zeros((), device=self.device)
        self.actor_opt = Adam(self.actor, actor_lr)
        self.critic_opt = Adam(self.critic, critic_lr)
        self.alpha_opt = Adam({"log_alpha": self.log_alpha}, alpha_lr)
        self._gen = torch.Generator(self.device).manual_seed(seed)

    # ------------------------------------------------------------- weights

    def get_weights(self):
        return self.actor

    def set_weights(self, actor) -> None:
        models.assign_(self.actor, actor)

    # -------------------------------------------------------------- update

    def update_from_batch(self, batch: Dict[str, np.ndarray]
                          ) -> Dict[str, float]:
        grads, stats, _ = self.compute_grads(batch)
        self.apply_grads(grads)
        return stats

    def compute_grads(self, batch: Dict[str, np.ndarray],
                      noise: Optional[Tuple[Any, Any]] = None):
        """(grads {actor, critic, alpha}, scalar stats, None). ``noise``:
        the standard normal draws [N, A] of the next action and of the
        actor's action, drawn from the learner's generator unless given."""
        b = to_tensors({k: batch[k] for k in _COLUMNS}, self.device,
                       int_keys=())
        n = b["obs"].shape[0]
        if noise is None:
            noise = [torch.randn((n, self.act_size), generator=self._gen,
                                 device=self.device) for _ in range(2)]
        next_noise, pi_noise = (torch.as_tensor(x).to(self.device,
                                                      torch.float32)
                                for x in noise)
        alpha = torch.exp(self.log_alpha.detach())

        # Soft TD target: r + gamma * (min_i Q_i(s', a') - alpha*logp(a')).
        with torch.no_grad():
            next_a, next_logp = models.squashed_gaussian_sample(
                self.actor, b["next_obs"], act_scale=self.act_scale,
                noise=next_noise)
            tq1, tq2 = models.twin_q_apply(self.target_critic,
                                           b["next_obs"], next_a)
            target = b["rewards"] + self.gamma * (1.0 - b["dones"]) * (
                torch.minimum(tq1, tq2) - alpha * next_logp)

        q1, q2 = models.twin_q_apply(self.critic, b["obs"], b["actions"])
        critic_loss = ((q1 - target) ** 2).mean() + ((q2 - target) ** 2
                                                     ).mean()
        critic_grads = torch.autograd.grad(critic_loss,
                                           self.critic_opt.leaves)

        a, logp = models.squashed_gaussian_sample(
            self.actor, b["obs"], act_scale=self.act_scale, noise=pi_noise)
        pq1, pq2 = models.twin_q_apply(self.critic, b["obs"], a)
        actor_loss = (alpha * logp - torch.minimum(pq1, pq2)).mean()
        actor_grads = torch.autograd.grad(actor_loss, self.actor_opt.leaves)

        # Temperature: push entropy toward target_entropy; the alpha loss
        # is -log_alpha * stop_gradient(logp_mean + target_entropy).
        logp_mean = logp.detach().mean()
        push = logp_mean + self.target_entropy
        alpha_loss = -self.log_alpha.detach() * push
        grads = {"actor": actor_grads, "critic": critic_grads,
                 "alpha": [-push]}
        stats = host_stats(self.STATS, (
            critic_loss.detach(), actor_loss.detach(), alpha_loss, alpha,
            q1.detach().mean(), -logp_mean))
        return grads, stats, None

    def apply_grads(self, grads) -> None:
        self.critic_opt.step(grads["critic"])
        self.actor_opt.step(grads["actor"])
        self.alpha_opt.step(grads["alpha"])
        # Polyak averaging: (1 - tau) * target + tau * critic.
        with torch.no_grad():
            target = models.leaves(self.target_critic)
            torch._foreach_mul_(target, 1.0 - self.tau)
            torch._foreach_add_(target, torch._foreach_mul(
                self.critic_opt.leaves, self.tau))


class _SACRunner:
    """Stochastic-policy transition collector over a continuous vector
    env, sampling from the live actor."""

    def __init__(self, env_spec, num_envs: int, seed: int = 0,
                 warmup_uniform_steps: int = 0, device=None):
        self.device = resolve_device(device)
        self.env = make_env(env_spec, num_envs=num_envs, seed=seed)
        if not self.env.action_size:
            raise ValueError("SAC requires a continuous env")
        self.obs = self.env.reset(seed=seed)
        self._gen = torch.Generator(self.device).manual_seed(seed)
        self._scale = float(self.env.action_high)
        self._params = None
        self._rng = np.random.default_rng(seed)
        self._uniform_left = int(warmup_uniform_steps)
        self._ep_return = np.zeros(num_envs, np.float64)
        self._completed: list = []

    def set_weights(self, params) -> bool:
        self._params = models.snapshot(params, self.device)
        return True

    def sample_transitions(self, n_steps: int) -> Dict[str, np.ndarray]:
        if self._params is None:
            raise RuntimeError("set_weights() before sample_transitions()")
        B = self.env.num_envs
        obs_l, act_l, rew_l, next_l, done_l = [], [], [], [], []
        for _ in range(n_steps):
            if self._uniform_left > 0:
                # Uniform warmup seeds the buffer with diverse actions
                # before the actor knows anything.
                a = self._rng.uniform(self.env.action_low,
                                      self.env.action_high,
                                      (B, self.env.action_size)
                                      ).astype(np.float32)
                self._uniform_left -= 1
            else:
                with torch.no_grad():
                    a = models.squashed_gaussian_sample(
                        self._params,
                        obs_tensor(self.obs, self.device),
                        self._gen, self._scale)[0].cpu().numpy()
            prev_obs = self.obs
            self.obs, r, done, info = self.env.step(a)
            terminated = info.get("terminated", done)
            final_obs = info.get("final_obs", self.obs)
            next_obs = np.where(done[:, None], final_obs, self.obs)
            obs_l.append(prev_obs)
            act_l.append(a)
            rew_l.append(r)
            next_l.append(next_obs)
            done_l.append(terminated.astype(np.float32))
            self._ep_return += r
            for i in np.flatnonzero(done):
                self._completed.append(float(self._ep_return[i]))
                self._ep_return[i] = 0.0
        return {
            "obs": np.concatenate(obs_l),
            "actions": np.concatenate(act_l),
            "rewards": np.concatenate(rew_l),
            "next_obs": np.concatenate(next_l),
            "dones": np.concatenate(done_l),
            "steps": n_steps * B,
        }

    def get_metrics(self) -> Dict[str, Any]:
        completed, self._completed = self._completed, []
        return {
            "episode_return_mean":
                float(np.mean(completed)) if completed else None,
            "num_episodes": len(completed),
        }


@dataclasses.dataclass
class SACConfig:
    """Fluent config (reference: SACConfig fluent API)."""

    env: Union[str, Callable] = "Pendulum"
    num_env_runners: int = 0
    num_envs_per_runner: int = 8
    rollout_steps: int = 16
    hidden: int = 64
    actor_lr: float = 3e-4
    critic_lr: float = 3e-4
    alpha_lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.005
    target_entropy: Optional[float] = None
    buffer_capacity: int = 100_000
    learning_starts: int = 1_000
    warmup_uniform_steps: int = 64   # per runner, env steps
    train_batch_size: int = 128
    updates_per_iteration: int = 64
    num_learners: int = 0
    seed: int = 0
    device: Any = None

    def environment(self, env) -> "SACConfig":
        self.env = env
        return self

    def env_runners(self, *, num_env_runners: int = None,
                    num_envs_per_env_runner: int = None,
                    rollout_fragment_length: int = None) -> "SACConfig":
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_env_runner is not None:
            self.num_envs_per_runner = num_envs_per_env_runner
        if rollout_fragment_length is not None:
            self.rollout_steps = rollout_fragment_length
        return self

    def training(self, *, actor_lr: float = None, critic_lr: float = None,
                 alpha_lr: float = None, gamma: float = None,
                 tau: float = None, train_batch_size: int = None,
                 target_entropy: float = None,
                 num_steps_sampled_before_learning_starts: int = None,
                 updates_per_iteration: int = None,
                 buffer_capacity: int = None) -> "SACConfig":
        for name, val in (("actor_lr", actor_lr), ("critic_lr", critic_lr),
                          ("alpha_lr", alpha_lr), ("gamma", gamma),
                          ("tau", tau),
                          ("train_batch_size", train_batch_size),
                          ("target_entropy", target_entropy),
                          ("learning_starts",
                           num_steps_sampled_before_learning_starts),
                          ("updates_per_iteration", updates_per_iteration),
                          ("buffer_capacity", buffer_capacity)):
            if val is not None:
                setattr(self, name, val)
        return self

    def learners(self, *, num_learners: int = None) -> "SACConfig":
        if num_learners is not None:
            self.num_learners = num_learners
        return self

    def build(self) -> "SAC":
        return SAC(self)


class SAC:
    """The algorithm object: sample -> store -> replay -> twin-Q/actor/
    alpha update -> Polyak -> weight sync."""

    def __init__(self, config: SACConfig):
        require_local("num_env_runners", config.num_env_runners)
        self.config = config
        probe = make_env(config.env, num_envs=1, seed=config.seed)
        if not probe.action_size:
            raise ValueError("SAC requires a continuous-action env")
        obs_size, act_size = probe.observation_size, probe.action_size
        act_scale = float(probe.action_high)

        def factory():
            return SACLearner(
                obs_size, act_size, hidden=config.hidden,
                actor_lr=config.actor_lr, critic_lr=config.critic_lr,
                alpha_lr=config.alpha_lr, gamma=config.gamma,
                tau=config.tau, act_scale=act_scale,
                target_entropy=config.target_entropy, seed=config.seed,
                device=config.device)

        self.learner_group = LearnerGroup(
            factory, num_learners=config.num_learners)
        self.buffer = ReplayBuffer(config.buffer_capacity, obs_size,
                                   seed=config.seed, action_size=act_size)
        self._local_runner = _SACRunner(
            config.env, config.num_envs_per_runner, config.seed,
            config.warmup_uniform_steps, config.device)
        self._sync_runner_weights()
        self._iteration = 0
        self._total_steps = 0

    def _sync_runner_weights(self) -> None:
        self._local_runner.set_weights(self.learner_group.get_weights())

    def _collect(self) -> int:
        b = self._local_runner.sample_transitions(self.config.rollout_steps)
        self.buffer.add_batch(b["obs"], b["actions"], b["rewards"],
                              b["next_obs"], b["dones"])
        return int(b["steps"])

    def training_step(self) -> Dict[str, Any]:
        self._total_steps += self._collect()
        stats: Dict[str, Any] = {}
        if len(self.buffer) >= self.config.learning_starts:
            for _ in range(self.config.updates_per_iteration):
                batch = self.buffer.sample(self.config.train_batch_size)
                stats = self.learner_group.update_from_batch(batch)
            self._sync_runner_weights()
        return stats

    def train(self) -> Dict[str, Any]:
        t0 = time.monotonic()
        learner_stats = self.training_step()
        self._iteration += 1
        m = self._local_runner.get_metrics()
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
        return self.learner_group.get_weights()

    def stop(self) -> None:
        self.learner_group.stop()
