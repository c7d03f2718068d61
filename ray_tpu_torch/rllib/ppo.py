"""PPO: env runner rollouts -> learner -> weight sync
(``ray_tpu/rllib/ppo.py``).

The same fluent config (``PPOConfig().environment(...).env_runners(...)
.training(...).build()``), loop and ``train()`` result dict as
``ray_tpu``'s; the config also carries ``device`` (None = the card) for
the learner and the runner. Only the local runner is ported
(``num_env_runners=0``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Union

import numpy as np

from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.env_runner import EnvRunnerGroup
from ray_tpu_torch.rllib.learner import PPOLearner


@dataclasses.dataclass
class PPOConfig:
    """Fluent config (reference: PPOConfig.environment/env_runners/
    training fluent API)."""

    env: Union[str, Callable] = "CartPole"
    num_env_runners: int = 0
    num_envs_per_runner: int = 8
    rollout_len: int = 128
    hidden: int = 64
    lr: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    entropy_coef: float = 0.01
    num_epochs: int = 4
    minibatch_size: int = 256
    max_grad_norm: float = 0.5
    seed: int = 0
    device: Any = None

    # Fluent sections, reference-style.
    def environment(self, env) -> "PPOConfig":
        self.env = env
        return self

    def env_runners(self, *, num_env_runners: int = None,
                    num_envs_per_env_runner: int = None,
                    rollout_fragment_length: int = None) -> "PPOConfig":
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_env_runner is not None:
            self.num_envs_per_runner = num_envs_per_env_runner
        if rollout_fragment_length is not None:
            self.rollout_len = rollout_fragment_length
        return self

    def training(self, *, lr: float = None, gamma: float = None,
                 lambda_: float = None, clip_param: float = None,
                 vf_loss_coeff: float = None, entropy_coeff: float = None,
                 num_epochs: int = None, minibatch_size: int = None,
                 grad_clip: float = None) -> "PPOConfig":
        for name, val in (("lr", lr), ("gamma", gamma),
                          ("gae_lambda", lambda_), ("clip_eps", clip_param),
                          ("vf_coef", vf_loss_coeff),
                          ("entropy_coef", entropy_coeff),
                          ("num_epochs", num_epochs),
                          ("minibatch_size", minibatch_size),
                          ("max_grad_norm", grad_clip)):
            if val is not None:
                setattr(self, name, val)
        return self

    def build(self) -> "PPO":
        return PPO(self)


class PPO:
    """The algorithm object: owns the learner and the env-runner group."""

    def __init__(self, config: PPOConfig):
        self.config = config
        probe = make_env(config.env, num_envs=1, seed=config.seed)
        self.env_runners = EnvRunnerGroup(
            config.env, num_env_runners=config.num_env_runners,
            num_envs_per_runner=config.num_envs_per_runner,
            rollout_len=config.rollout_len, seed=config.seed,
            device=config.device)
        self.learner = PPOLearner(
            probe.observation_size, probe.num_actions,
            hidden=config.hidden, lr=config.lr, gamma=config.gamma,
            gae_lambda=config.gae_lambda, clip_eps=config.clip_eps,
            vf_coef=config.vf_coef, entropy_coef=config.entropy_coef,
            num_epochs=config.num_epochs,
            minibatch_size=config.minibatch_size,
            max_grad_norm=config.max_grad_norm, seed=config.seed,
            device=config.device)
        self.env_runners.sync_weights(self.learner.get_weights())
        self._iteration = 0
        self._total_steps = 0

    # ------------------------------------------------------------- train

    def training_step(self) -> Dict[str, Any]:
        """One iteration: sample -> learn -> broadcast."""
        rollouts = self.env_runners.sample()
        batch = _concat_rollouts(rollouts)
        stats = self.learner.update_from_batch(batch)
        self.env_runners.sync_weights(self.learner.get_weights())
        self._total_steps += int(np.prod(batch["actions"].shape))
        return stats

    def train(self) -> Dict[str, Any]:
        """One ``Algorithm.train`` result round: env_runners/learner stat
        trees + counters."""
        t0 = time.monotonic()
        learner_stats = self.training_step()
        self._iteration += 1
        metrics = self.env_runners.get_metrics()
        returns = [m["episode_return_mean"] for m in metrics
                   if m.get("episode_return_mean") is not None]
        episodes = sum(m.get("num_episodes", 0) for m in metrics)
        return {
            "training_iteration": self._iteration,
            "num_env_steps_sampled_lifetime": self._total_steps,
            "time_this_iter_s": time.monotonic() - t0,
            "env_runners": {
                "episode_return_mean":
                    float(np.mean(returns)) if returns else None,
                "num_episodes": episodes,
            },
            "learners": {"default_policy": learner_stats},
        }

    def get_weights(self):
        return self.learner.get_weights()

    def set_weights(self, params) -> None:
        self.learner.set_weights(params)
        self.env_runners.sync_weights(params)

    def stop(self) -> None:
        self.env_runners.stop()


def _concat_rollouts(rollouts: List[Dict[str, np.ndarray]]
                     ) -> Dict[str, np.ndarray]:
    """Stack runner rollouts along the batch (B) axis; last_value is [B]."""
    if len(rollouts) == 1:
        return rollouts[0]
    out: Dict[str, np.ndarray] = {}
    for key in rollouts[0]:
        axis = 0 if key == "last_value" else 1
        out[key] = np.concatenate([r[key] for r in rollouts], axis=axis)
    return out
