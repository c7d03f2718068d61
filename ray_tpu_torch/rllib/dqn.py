"""DQN: replay-buffer off-policy learning, double DQN with a target
network (``ray_tpu/rllib/dqn.py``).

``ray_tpu`` jits the TD update in two halves, ``compute_grads`` and
``apply_grads``, so a learner group can allreduce between them; the port
keeps the two halves. ``compute_grads`` brings the loss, the mean Q and
the TD errors (which the prioritised buffer needs on the host) back in one
copy. The target network takes the online weights on every
``target_update_freq``-th update, counted from 1 as ``ray_tpu`` counts.

``num_env_runners > 0`` collects with ``_DQNRunner`` actors on the CPU
(``env_runner.py``'s rule); ``num_learners > 0`` updates through a
learner gang on ``device`` (``learner_group.py``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Union

import numpy as np
import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.rllib import models
from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.env_runner import (RunnerGroup, fetch,
                                            merge_runner_metrics, obs_tensor)
from ray_tpu_torch.rllib.learner import Adam, to_tensors
from ray_tpu_torch.rllib.learner_group import LearnerGroup
from ray_tpu_torch.rllib.replay_buffers import (PrioritizedReplayBuffer,
                                                ReplayBuffer)


#: The columns the TD update reads (``indices`` stays on the host).
COLUMNS = ("obs", "actions", "rewards", "next_obs", "dones", "weights")


def huber(td: torch.Tensor, delta: float) -> torch.Tensor:
    return torch.where(td.abs() <= delta, 0.5 * td ** 2,
                       delta * (td.abs() - 0.5 * delta))


class DQNLearner:
    """Double-DQN learner. ``device=None`` is the card."""

    def __init__(self, obs_size: int, num_actions: int, *,
                 hidden: int = 64, lr: float = 1e-3, gamma: float = 0.99,
                 target_update_freq: int = 200, huber_delta: float = 1.0,
                 max_grad_norm: float = 10.0, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.gamma = gamma
        self.target_update_freq = target_update_freq
        self.huber_delta = huber_delta
        self.params = models.init_q_params(
            torch.Generator().manual_seed(seed), obs_size, num_actions,
            hidden, self.device)
        self.target_params = models.snapshot(self.params, self.device)
        self.optimizer = Adam(self.params, lr, max_grad_norm=max_grad_norm)
        self.updates = 0   # gradient steps taken (drives the target sync)

    # ------------------------------------------------------------- weights

    def get_weights(self):
        return self.params

    def set_weights(self, params) -> None:
        models.assign_(self.params, params)

    # -------------------------------------------------------------- update

    def update_from_batch(self, batch: Dict[str, np.ndarray]
                          ) -> Dict[str, Any]:
        grads, stats, td = self.compute_grads(batch)
        self.apply_grads(grads)
        stats["td_errors"] = td
        return stats

    def compute_grads(self, batch: Dict[str, np.ndarray]):
        """(grads, scalar stats, td_errors [N] numpy): the cut point where
        a learner gang would allreduce."""
        b = to_tensors({k: batch[k] for k in COLUMNS if k in batch},
                       self.device)
        with torch.no_grad():
            targets = self._targets(b)
        loss, qmean, td = self._loss(b, targets)
        grads = torch.autograd.grad(loss, self.optimizer.leaves)
        host = torch.cat([loss.detach()[None], qmean.detach()[None],
                          td.detach()]).cpu().numpy()
        return grads, {"loss": float(host[0]),
                       "q_mean": float(host[1])}, host[2:]

    def apply_grads(self, grads) -> None:
        self.optimizer.step(grads)
        self.updates += 1
        if self.updates % self.target_update_freq == 0:
            with torch.no_grad():
                torch._foreach_copy_(models.leaves(self.target_params),
                                     self.optimizer.leaves)

    # ---------------------------------------------------------------- impl

    def _targets(self, b: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Double DQN: the online net picks the next action, the target
        net scores it."""
        next_a = torch.argmax(models.q_apply(self.params, b["next_obs"]), -1)
        next_q = models.q_apply(self.target_params, b["next_obs"]).gather(
            -1, next_a[:, None])[:, 0]
        return b["rewards"] + self.gamma * (1.0 - b["dones"]) * next_q

    def _loss(self, b: Dict[str, torch.Tensor], targets: torch.Tensor):
        q = models.q_apply(self.params, b["obs"]).gather(
            -1, b["actions"][:, None])[:, 0]
        td = q - targets
        hub = huber(td, self.huber_delta)
        if "weights" in b:
            hub = hub * b["weights"]
        return hub.mean(), q.mean(), td


class _DQNRunner:
    """Epsilon-greedy transition collector over a vector env."""

    def __init__(self, env_spec, num_envs: int, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.env = make_env(env_spec, num_envs=num_envs, seed=seed)
        self.obs = self.env.reset(seed=seed)
        self._gen = torch.Generator(self.device).manual_seed(seed)
        self._params = None
        self._ep_return = np.zeros(num_envs, np.float64)
        self._completed: list = []

    def set_weights(self, params) -> bool:
        self._params = models.snapshot(fetch(params), self.device)
        return True

    def sample_transitions(self, n_steps: int,
                           epsilon: float) -> Dict[str, np.ndarray]:
        if self._params is None:
            raise RuntimeError("set_weights() before sample_transitions()")
        B = self.env.num_envs
        obs_l, act_l, rew_l, next_l, done_l = [], [], [], [], []
        for _ in range(n_steps):
            with torch.no_grad():
                a = models.epsilon_greedy_action(
                    self._params, obs_tensor(self.obs, self.device),
                    self._gen, epsilon)
                a = a.to(torch.int32).cpu().numpy()
            prev_obs = self.obs
            self.obs, r, done, info = self.env.step(a)
            terminated = info.get("terminated", done)
            # next_obs for the transition is the PRE-reset observation;
            # the TD target zeroes only on true termination.
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
class DQNConfig:
    """Fluent config (reference: DQNConfig fluent API)."""

    env: Union[str, Callable] = "CartPole"
    num_env_runners: int = 0
    num_envs_per_runner: int = 8
    rollout_steps: int = 32          # env steps per runner per iteration
    hidden: int = 64
    lr: float = 1e-3
    gamma: float = 0.99
    buffer_capacity: int = 50_000
    prioritized_replay: bool = False
    learning_starts: int = 1_000
    train_batch_size: int = 64
    updates_per_iteration: int = 32
    target_update_freq: int = 200
    epsilon_initial: float = 1.0
    epsilon_final: float = 0.05
    epsilon_decay_steps: int = 8_000
    num_learners: int = 0            # 0 = in-process
    seed: int = 0
    device: Any = None

    def environment(self, env) -> "DQNConfig":
        self.env = env
        return self

    def env_runners(self, *, num_env_runners: int = None,
                    num_envs_per_env_runner: int = None,
                    rollout_fragment_length: int = None) -> "DQNConfig":
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_env_runner is not None:
            self.num_envs_per_runner = num_envs_per_env_runner
        if rollout_fragment_length is not None:
            self.rollout_steps = rollout_fragment_length
        return self

    def training(self, *, lr: float = None, gamma: float = None,
                 train_batch_size: int = None,
                 target_network_update_freq: int = None,
                 num_steps_sampled_before_learning_starts: int = None,
                 updates_per_iteration: int = None,
                 prioritized_replay: bool = None,
                 buffer_capacity: int = None) -> "DQNConfig":
        for name, val in (("lr", lr), ("gamma", gamma),
                          ("train_batch_size", train_batch_size),
                          ("target_update_freq",
                           target_network_update_freq),
                          ("learning_starts",
                           num_steps_sampled_before_learning_starts),
                          ("updates_per_iteration", updates_per_iteration),
                          ("prioritized_replay", prioritized_replay),
                          ("buffer_capacity", buffer_capacity)):
            if val is not None:
                setattr(self, name, val)
        return self

    def learners(self, *, num_learners: int = None) -> "DQNConfig":
        if num_learners is not None:
            self.num_learners = num_learners
        return self

    def build(self) -> "DQN":
        return DQN(self)


class DQN:
    """The algorithm object: sample -> store -> replay -> update -> target
    sync -> weight sync."""

    def __init__(self, config: DQNConfig):
        self.config = config
        probe = make_env(config.env, num_envs=1, seed=config.seed)
        obs_size, num_actions = probe.observation_size, probe.num_actions

        def factory():
            return DQNLearner(
                obs_size, num_actions, hidden=config.hidden, lr=config.lr,
                gamma=config.gamma,
                target_update_freq=config.target_update_freq,
                seed=config.seed, device=config.device)

        self.learner_group = LearnerGroup(
            factory, num_learners=config.num_learners, device=config.device)
        self.env_runners = RunnerGroup(
            _DQNRunner, config.num_env_runners, config.seed, config.env,
            config.num_envs_per_runner, device=config.device)
        buf_cls = (PrioritizedReplayBuffer if config.prioritized_replay
                   else ReplayBuffer)
        self.buffer = buf_cls(config.buffer_capacity, obs_size,
                              seed=config.seed)
        self._sync_runner_weights()
        self._iteration = 0
        self._total_steps = 0

    # ------------------------------------------------------------- helpers

    def _sync_runner_weights(self) -> None:
        self.env_runners.sync_weights(self.learner_group.get_weights())

    def _epsilon(self) -> float:
        c = self.config
        frac = min(1.0, self._total_steps / max(1, c.epsilon_decay_steps))
        return c.epsilon_initial + frac * (c.epsilon_final
                                           - c.epsilon_initial)

    def _collect(self) -> int:
        batches = self.env_runners.call("sample_transitions",
                                        self.config.rollout_steps,
                                        self._epsilon())
        steps = 0
        for b in batches:
            self.buffer.add_batch(b["obs"], b["actions"], b["rewards"],
                                  b["next_obs"], b["dones"])
            steps += int(b["steps"])
        return steps

    # --------------------------------------------------------------- train

    def training_step(self) -> Dict[str, Any]:
        self._total_steps += self._collect()
        stats: Dict[str, Any] = {}
        if len(self.buffer) >= self.config.learning_starts:
            for _ in range(self.config.updates_per_iteration):
                batch = self.buffer.sample(self.config.train_batch_size)
                stats = self.learner_group.update_from_batch(batch)
                td = stats.pop("td_errors", None)
                if (td is not None
                        and isinstance(self.buffer,
                                       PrioritizedReplayBuffer)):
                    self.buffer.update_priorities(batch["indices"], td)
            self._sync_runner_weights()
        return stats

    def train(self) -> Dict[str, Any]:
        t0 = time.monotonic()
        learner_stats = self.training_step()
        self._iteration += 1
        metrics = self.env_runners.call("get_metrics")
        return {
            "training_iteration": self._iteration,
            "num_env_steps_sampled_lifetime": self._total_steps,
            "epsilon": self._epsilon(),
            "time_this_iter_s": time.monotonic() - t0,
            "env_runners": merge_runner_metrics(metrics),
            "learners": {"default_policy": learner_stats},
        }

    def get_weights(self):
        return self.learner_group.get_weights()

    def stop(self) -> None:
        self.learner_group.stop()
        self.env_runners.stop()
