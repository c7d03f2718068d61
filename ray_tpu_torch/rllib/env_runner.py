"""Experience collection: ``EnvRunner`` and ``EnvRunnerGroup``
(``ray_tpu/rllib/env_runner.py``).

The runner steps a numpy vector env on the host and runs the policy on
its device. Each step moves the observation to the device in one copy
and brings the action, its log-prob and the value back in one copy (a
[3, B] f32 tensor: ``ray_tpu`` makes three ``np.asarray`` calls). The
rollout dict keeps ``ray_tpu``'s keys, shapes and dtypes.

``set_weights`` takes an ``ObjectRef`` or a tree of tensors (the
learner's, on any device) or of numpy arrays and keeps a detached copy on
the runner's device, so a rollout runs with the weights of the last sync,
as ``ray_tpu``'s does.

``EnvRunnerGroup`` keeps one runner in-process (``num_env_runners=0``,
on the group's ``device``) or starts N runner actors on the cluster
runtime with seeds ``seed + 1000*i``. Remote runners run on the CPU, in
CPU workers, as ``ray_tpu``'s do (its CPU workers force
``JAX_PLATFORMS=cpu``; the port's see no card): each actor is built with
``device="cpu"``, never the card's default, which would raise there.
``sync_weights`` makes one host snapshot of the learner's weights, puts
it once, and every runner gets that one object (a CUDA tensor cannot be
got in a process without a card). ``EnvRunnerGroup`` is a
``RunnerGroup``, which holds one runner of any class in-process or N
actors of it, created in parallel (``actor.create_actors``), and calls
them alike: every algorithm's runners go through one.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch import resolve_device
from ray_tpu_torch.actor import create_actors
from ray_tpu_torch.rllib import models
from ray_tpu_torch.rllib.env import make_env

HOST = torch.device("cpu")


def obs_tensor(obs: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host observation batch -> f32 on ``device``, one copy (JAX's
    x64-off conversion of any numeric array)."""
    return torch.from_numpy(np.ascontiguousarray(obs, np.float32)).to(
        device)


def host_weights(tree) -> Any:
    """The weights a runner actor is sent: detached CPU copies, put once
    and got by every runner."""
    return models.snapshot(tree, HOST)


def fetch(value):
    """An ``ObjectRef`` got from the store; any other value as is."""
    if isinstance(value, ray_tpu_torch.ObjectRef):
        return ray_tpu_torch.get(value)
    return value


def merge_runner_metrics(metrics: List[Dict[str, Any]]) -> Dict[str, Any]:
    """The runners' metrics as one: the mean of their mean returns (those
    that finished an episode) and the sum of their episodes."""
    returns = [m["episode_return_mean"] for m in metrics
               if m.get("episode_return_mean") is not None]
    return {"episode_return_mean":
            float(np.mean(returns)) if returns else None,
            "num_episodes": sum(m.get("num_episodes", 0) for m in metrics)}


def kill_all(actors: List[Any]) -> None:
    for a in actors:
        try:
            ray_tpu_torch.kill(a)
        except Exception:  # already dead, or the runtime is gone
            pass


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
        """params: an ObjectRef or a tree (the group puts once a sync)."""
        self._params = models.snapshot(fetch(params), self.device)
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


class RunnerGroup:
    """One runner ``cls(*args, seed=seed, device=device, **kwargs)`` in
    this process (``n == 0``), or ``n`` runner actors of ``cls`` on the
    CPU with seeds ``seed + 1000*i`` (``device="cpu"``, see the module
    docstring), created in parallel. The algorithms step their runners
    through ``call`` alike in both modes."""

    def __init__(self, cls, n: int, seed: int, *args, device=None,
                 **kwargs):
        self._local = None
        self._actors: List[Any] = []
        if n == 0:
            self._local = cls(*args, seed=seed, device=device, **kwargs)
            return
        remote_cls = ray_tpu_torch.remote(cls)
        self._actors = create_actors(
            lambda i: remote_cls.remote(*args, seed=seed + 1000 * i,
                                        device="cpu", **kwargs), n)

    @property
    def actors(self) -> List[Any]:
        return self._actors

    def call(self, method: str, *args, **kwargs) -> List[Any]:
        """``method(*args, **kwargs)`` on every runner; their results in
        order."""
        if self._local is not None:
            return [getattr(self._local, method)(*args, **kwargs)]
        return ray_tpu_torch.get([getattr(a, method).remote(*args, **kwargs)
                                  for a in self._actors])

    def sync_weights(self, params) -> None:
        """The local runner takes ``params`` as they are; runner actors
        get one host snapshot, put once."""
        if self._local is not None:
            self._local.set_weights(params)
            return
        self.call("set_weights", ray_tpu_torch.put(host_weights(params)))

    def stop(self) -> None:
        kill_all(self._actors)


class EnvRunnerGroup(RunnerGroup):
    """N ``EnvRunner`` actors on the CPU, or one local runner on
    ``device`` when ``num_env_runners == 0``."""

    def __init__(self, env_spec, *, num_env_runners: int,
                 num_envs_per_runner: int, rollout_len: int, seed: int = 0,
                 device=None):
        super().__init__(EnvRunner, num_env_runners, seed, env_spec,
                         num_envs_per_runner, rollout_len, device=device)

    def sample(self) -> List[Dict[str, np.ndarray]]:
        return self.call("sample")

    def get_metrics(self) -> List[Dict[str, Any]]:
        return self.call("get_metrics")
