"""Experience collection: ``EnvRunner`` and its local ``EnvRunnerGroup``
(``ray_tpu/rllib/env_runner.py``).

The runner steps a numpy vector env on the host and runs the policy on
its device. Each step moves the observation to the device in one copy
and brings the action, its log-prob and the value back in one copy (a
[3, B] f32 tensor: ``ray_tpu`` makes three ``np.asarray`` calls). The
rollout dict keeps ``ray_tpu``'s keys, shapes and dtypes.

``set_weights`` takes a tree of tensors (the learner's, on any device) or
of numpy arrays and keeps a detached copy on the runner's device, so a
rollout runs with the weights of the last sync, as ``ray_tpu``'s does.

Only the local group (``num_env_runners=0``) is ported: remote runners
are actors of ``ray_tpu``'s runtime, which the port has not copied yet.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.rllib import models
from ray_tpu_torch.rllib.env import make_env

#: What a remote mode raises: the cluster runtime is ported, the remote
#: runners, learner gangs and collectives on it are not yet.
RUNTIME_ITEM = ("the remote runner and learner actors on the cluster "
                "runtime, not ported yet (ROADMAP.md, queue 1, item 7)")


def obs_tensor(obs: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host observation batch -> f32 on ``device``, one copy (JAX's
    x64-off conversion of any numeric array)."""
    return torch.from_numpy(np.ascontiguousarray(obs, np.float32)).to(
        device)


def require_local(what: str, n: int) -> None:
    """Raise for a remote mode (``n`` > 0 actors): they wait for the
    runtime."""
    if n:
        raise NotImplementedError(
            f"{what}={n}: remote actors wait for {RUNTIME_ITEM}; use 0, the "
            "local mode")


class EnvRunner:
    """Owns a vector env and the policy's weights; samples fixed-length
    rollouts. ``device=None`` is the card."""

    def __init__(self, env_spec, num_envs: int, rollout_len: int,
                 seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.env = make_env(env_spec, num_envs=num_envs, seed=seed)
        self.rollout_len = rollout_len
        self.obs = self.env.reset(seed=seed)
        self._gen = torch.Generator(self.device).manual_seed(seed)
        self._params = None
        # Per-sub-env running episode returns for metrics.
        self._ep_return = np.zeros(num_envs, np.float64)
        self._completed: List[float] = []

    def set_weights(self, params) -> bool:
        self._params = models.snapshot(params, self.device)
        return True

    def _value(self, obs: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            return models.value_apply(self._params, obs_tensor(
                obs, self.device)).cpu().numpy()

    def sample(self, include_metrics: bool = False) -> Dict[str, np.ndarray]:
        """Collect one [T, B] rollout with the current weights.

        ``include_metrics`` adds get_metrics() under a "metrics" key."""
        if self._params is None:
            raise RuntimeError("set_weights() before sample()")
        T, B = self.rollout_len, self.env.num_envs
        obs = np.empty((T, B, self.env.observation_size), np.float32)
        actions = np.empty((T, B), np.int32)
        logps = np.empty((T, B), np.float32)
        values = np.empty((T, B), np.float32)
        rewards = np.empty((T, B), np.float32)
        terminated = np.zeros((T, B), np.bool_)
        truncated = np.zeros((T, B), np.bool_)
        # v(final_obs) at truncated steps — the learner bootstraps
        # time-limit cutoffs with the critic instead of 0.
        bootstrap = np.zeros((T, B), np.float32)
        for t in range(T):
            with torch.no_grad():
                a, lp, v = models.sample_action(
                    self._params, obs_tensor(self.obs, self.device),
                    self._gen)
                step = torch.stack([a.float(), lp, v]).cpu().numpy()
            a = step[0].astype(np.int32)
            obs[t] = self.obs
            actions[t], logps[t], values[t] = a, step[1], step[2]
            self.obs, rewards[t], done_t, info = self.env.step(a)
            terminated[t] = info.get("terminated", done_t)
            truncated[t] = info.get("truncated", False)
            if truncated[t].any():
                final_obs = info.get("final_obs")
                if final_obs is not None:
                    bootstrap[t] = np.where(truncated[t],
                                            self._value(final_obs), 0.0)
            self._ep_return += rewards[t]
            for i in np.flatnonzero(done_t):
                self._completed.append(float(self._ep_return[i]))
                self._ep_return[i] = 0.0
        batch = {
            "obs": obs, "actions": actions, "logp": logps,
            "values": values, "rewards": rewards,
            "terminated": terminated, "truncated": truncated,
            "bootstrap_value": bootstrap,
            # Bootstrap value for the final observation (GAE tail).
            "last_value": self._value(self.obs),
        }
        if include_metrics:
            batch["metrics"] = self.get_metrics()
        return batch

    def get_metrics(self) -> Dict[str, Any]:
        completed, self._completed = self._completed, []
        return {
            "episode_return_mean":
                float(np.mean(completed)) if completed else None,
            "num_episodes": len(completed),
        }


class EnvRunnerGroup:
    """The local runner (``num_env_runners=0``); remote runners raise."""

    def __init__(self, env_spec, *, num_env_runners: int,
                 num_envs_per_runner: int, rollout_len: int, seed: int = 0,
                 device=None):
        require_local("num_env_runners", num_env_runners)
        self._local = EnvRunner(env_spec, num_envs_per_runner, rollout_len,
                                seed, device)

    def sync_weights(self, params) -> None:
        self._local.set_weights(params)

    def sample(self) -> List[Dict[str, np.ndarray]]:
        return [self._local.sample()]

    def get_metrics(self) -> List[Dict[str, Any]]:
        return [self._local.get_metrics()]

    def stop(self) -> None:
        pass
