"""Multi-agent environments, runner and independent-learner PPO
(``ray_tpu/rllib/multi_agent.py``).

Each policy id owns one ``PPOLearner``; the agents that map to a policy
share its parameters and pool their experience into it, across runners.
The runner acts for every agent each step, one forward and one copy to
the host an agent, as ``EnvRunner`` does. ``num_env_runners > 0`` samples
with ``MultiAgentEnvRunner`` actors on the CPU (``env_runner.py``'s
rule); their weights are one put of a dict of per-policy host trees.

A multi-agent vector env steps a dict of per-agent action arrays and
returns dict-of-arrays observations. All agents act every step;
per-agent episode boundaries are independent.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.rllib import models
from ray_tpu_torch.rllib.env import VectorEnv, make_env
from ray_tpu_torch.rllib.env_runner import (RunnerGroup, fetch,
                                            merge_runner_metrics, obs_tensor)
from ray_tpu_torch.rllib.learner import PPOLearner


class MultiAgentVecEnv:
    """B copies of an N-agent environment stepped in lockstep.

    Contract mirrors VectorEnv but dict-keyed by agent id:
      reset() -> {agent: obs [B, obs_size]}
      step({agent: actions [B]}) ->
          (obs_dict, reward_dict, dones: {agent: [B] bool}, info)
    info carries per-agent "terminated"/"truncated"/"final_obs" dicts.
    """

    num_envs: int
    agent_ids: Tuple[str, ...]
    observation_sizes: Dict[str, int]
    num_actions: Dict[str, int]

    def reset(self, seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def step(self, actions: Dict[str, np.ndarray]):
        raise NotImplementedError


class IndependentEnsembleEnv(MultiAgentVecEnv):
    """N independent single-agent envs presented as one multi-agent env
    (each agent's episodes run and reset independently)."""

    def __init__(self, env_specs: Dict[str, Union[str, Callable]],
                 num_envs: int = 8, seed: int = 0):
        self.num_envs = num_envs
        self._envs: Dict[str, VectorEnv] = {
            aid: make_env(spec, num_envs=num_envs, seed=seed + 17 * i)
            for i, (aid, spec) in enumerate(sorted(env_specs.items()))
        }
        self.agent_ids = tuple(sorted(env_specs))
        self.observation_sizes = {a: e.observation_size
                                  for a, e in self._envs.items()}
        self.num_actions = {a: e.num_actions for a, e in self._envs.items()}

    def reset(self, seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        return {a: e.reset(seed) for a, e in self._envs.items()}

    def step(self, actions: Dict[str, np.ndarray]):
        obs, rewards, dones = {}, {}, {}
        term: Dict[str, np.ndarray] = {}
        trunc: Dict[str, np.ndarray] = {}
        final_obs: Dict[str, np.ndarray] = {}
        for a, e in self._envs.items():
            obs[a], rewards[a], d, info = e.step(actions[a])
            dones[a] = d
            term[a] = info.get("terminated", d)
            trunc[a] = info.get("truncated", np.zeros_like(d))
            final_obs[a] = info.get("final_obs", obs[a])
        return obs, rewards, dones, {
            "terminated": term, "truncated": trunc, "final_obs": final_obs,
        }


class MultiAgentEnvRunner:
    """Samples [T, B] rollouts per agent with per-policy weights.
    ``device=None`` is the card."""

    def __init__(self, env_ctor, num_envs: int, rollout_len: int,
                 policy_mapping: Dict[str, str], seed: int = 0,
                 device=None):
        self.device = resolve_device(device)
        self.env: MultiAgentVecEnv = env_ctor(num_envs=num_envs, seed=seed)
        self.rollout_len = rollout_len
        self.policy_mapping = dict(policy_mapping)
        self.obs = self.env.reset(seed=seed)
        self._gen = torch.Generator(self.device).manual_seed(seed)
        self._weights: Dict[str, Any] = {}
        self._ep_return = {a: np.zeros(num_envs, np.float64)
                           for a in self.env.agent_ids}
        self._completed: Dict[str, List[float]] = {a: []
                                                   for a in self.env.agent_ids}

    def set_weights(self, weights) -> bool:
        """weights: {policy id: tree}, or an ObjectRef of one."""
        self._weights.update({pid: models.snapshot(w, self.device)
                              for pid, w in fetch(weights).items()})
        return True

    def _params(self, agent: str):
        return self._weights[self.policy_mapping[agent]]

    def _value(self, agent: str, obs: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            return models.value_apply(
                self._params(agent), obs_tensor(obs, self.device)
            ).cpu().numpy()

    def sample(self) -> Dict[str, Dict[str, np.ndarray]]:
        """One rollout -> {agent_id: single-agent batch} (each feedable to
        the single-agent learners unchanged)."""
        T, B = self.rollout_len, self.env.num_envs
        agents = self.env.agent_ids
        buf = {a: {
            "obs": np.empty((T, B, self.env.observation_sizes[a]), np.float32),
            "actions": np.empty((T, B), np.int32),
            "logp": np.empty((T, B), np.float32),
            "values": np.empty((T, B), np.float32),
            "rewards": np.empty((T, B), np.float32),
            "terminated": np.zeros((T, B), np.bool_),
            "truncated": np.zeros((T, B), np.bool_),
            "bootstrap_value": np.zeros((T, B), np.float32),
        } for a in agents}
        for t in range(T):
            actions = {}
            for a in agents:
                with torch.no_grad():
                    act, lp, v = models.sample_action(
                        self._params(a),
                        obs_tensor(self.obs[a], self.device),
                        self._gen)
                    step = torch.stack([act.float(), lp, v]).cpu().numpy()
                actions[a] = step[0].astype(np.int32)
                buf[a]["obs"][t] = self.obs[a]
                buf[a]["actions"][t] = actions[a]
                buf[a]["logp"][t] = step[1]
                buf[a]["values"][t] = step[2]
            self.obs, rewards, dones, info = self.env.step(actions)
            for a in agents:
                buf[a]["rewards"][t] = rewards[a]
                buf[a]["terminated"][t] = info["terminated"][a]
                buf[a]["truncated"][t] = info["truncated"][a]
                if info["truncated"][a].any():
                    buf[a]["bootstrap_value"][t] = np.where(
                        info["truncated"][a],
                        self._value(a, info["final_obs"][a]), 0.0)
                self._ep_return[a] += rewards[a]
                for i in np.flatnonzero(dones[a]):
                    self._completed[a].append(float(self._ep_return[a][i]))
                    self._ep_return[a][i] = 0.0
        for a in agents:
            buf[a]["last_value"] = self._value(a, self.obs[a])
        return buf

    def get_metrics(self) -> Dict[str, Dict[str, Any]]:
        out = {}
        for a in self.env.agent_ids:
            completed, self._completed[a] = self._completed[a], []
            out[a] = {
                "episode_return_mean":
                    float(np.mean(completed)) if completed else None,
                "num_episodes": len(completed),
            }
        return out


@dataclasses.dataclass
class MultiAgentPPOConfig:
    env: Callable = None                    # ctor(num_envs=, seed=)
    policies: Tuple[str, ...] = ()          # policy ids
    policy_mapping: Dict[str, str] = None   # agent id -> policy id
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

    def build(self) -> "MultiAgentPPO":
        return MultiAgentPPO(self)


class MultiAgentPPO:
    """Independent PPO per policy id; agents mapped to a shared policy pool
    experience (parameter sharing)."""

    def __init__(self, config: MultiAgentPPOConfig):
        self.config = config
        probe: MultiAgentVecEnv = config.env(num_envs=1, seed=config.seed)
        mapping = config.policy_mapping or {
            a: a for a in probe.agent_ids}
        policies = config.policies or tuple(sorted(set(mapping.values())))
        unmapped = [a for a in probe.agent_ids if a not in mapping]
        if unmapped:
            raise ValueError(f"agents missing from policy_mapping: "
                             f"{unmapped}")
        orphans = [p for p in policies
                   if not any(mapping[a] == p for a in probe.agent_ids)]
        if orphans:
            raise ValueError(f"policies with no mapped agent: {orphans}")
        self.policy_mapping = mapping
        self.learners: Dict[str, PPOLearner] = {}
        for i, pid in enumerate(policies):
            # The policy's obs/action space comes from any agent mapped to it.
            agent = next(a for a in probe.agent_ids if mapping[a] == pid)
            self.learners[pid] = PPOLearner(
                probe.observation_sizes[agent], probe.num_actions[agent],
                hidden=config.hidden, lr=config.lr, gamma=config.gamma,
                gae_lambda=config.gae_lambda, clip_eps=config.clip_eps,
                vf_coef=config.vf_coef, entropy_coef=config.entropy_coef,
                num_epochs=config.num_epochs,
                minibatch_size=config.minibatch_size,
                max_grad_norm=config.max_grad_norm, seed=config.seed + i,
                device=config.device)
        self.env_runners = RunnerGroup(
            MultiAgentEnvRunner, config.num_env_runners, config.seed,
            config.env, config.num_envs_per_runner, config.rollout_len,
            mapping, device=config.device)
        self._sync_weights()
        self._iteration = 0
        self._total_steps = 0

    def _sync_weights(self) -> None:
        self.env_runners.sync_weights(self.get_weights())

    def training_step(self) -> Dict[str, Dict[str, float]]:
        rollouts = self.env_runners.call("sample")
        # Pool experience per policy id across agents and runners.
        stats: Dict[str, Dict[str, float]] = {}
        for pid, learner in self.learners.items():
            batches = [r[a] for r in rollouts for a in r
                       if self.policy_mapping[a] == pid]
            merged = _concat_agent_batches(batches)
            stats[pid] = learner.update_from_batch(merged)
            self._total_steps += int(np.prod(merged["actions"].shape))
        self._sync_weights()
        return stats

    def train(self) -> Dict[str, Any]:
        t0 = time.monotonic()
        learner_stats = self.training_step()
        self._iteration += 1
        metrics = self.env_runners.call("get_metrics")
        per_agent = {a: merge_runner_metrics([m[a] for m in metrics])
                     for a in metrics[0]}
        return {
            "training_iteration": self._iteration,
            "num_env_steps_sampled_lifetime": self._total_steps,
            "time_this_iter_s": time.monotonic() - t0,
            "env_runners": per_agent,
            "learners": learner_stats,
        }

    def get_weights(self) -> Dict[str, Any]:
        return {pid: l.get_weights() for pid, l in self.learners.items()}

    def stop(self) -> None:
        self.env_runners.stop()


def _concat_agent_batches(batches: List[Dict[str, np.ndarray]]
                          ) -> Dict[str, np.ndarray]:
    if len(batches) == 1:
        return batches[0]
    out: Dict[str, np.ndarray] = {}
    for key in batches[0]:
        axis = 0 if key == "last_value" else 1
        out[key] = np.concatenate([b[key] for b in batches], axis=axis)
    return out
