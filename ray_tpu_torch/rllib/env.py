"""Vectorized numpy environments (a copy of ``ray_tpu/rllib/env.py``).

The port keeps its own copy, since it imports nothing of ``ray_tpu``:
the same classes, seeds and arithmetic, so the same seeds and actions give
bit-equal observations, rewards and flags
(``tests/test_torch_rllib.py`` holds them so). The envs are numpy on the
host; only the policies that act in them run on the card.

Parity target: the reference wraps gymnasium vector envs inside
`SingleAgentEnvRunner` (reference: rllib/env/single_agent_env_runner.py:65).
This framework keeps the same contract — batched reset/step with auto-reset —
but ships a dependency-free numpy CartPole so the library and its learning
tests run anywhere.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np


class VectorEnv:
    """B independent environment copies stepped in lockstep.

    Auto-reset semantics: when a sub-env terminates, `step` returns the
    terminal reward/done for that index and the NEXT observation is the
    reset state (matching gymnasium's VectorEnv autoreset contract that the
    reference's EnvRunner relies on).

    Discrete envs set ``num_actions`` (actions are [B] ints); continuous
    envs set ``action_size``/``action_low``/``action_high`` instead
    (actions are [B, action_size] floats) — the same split gymnasium's
    Discrete/Box spaces give the reference's runners.
    """

    num_envs: int
    observation_size: int
    num_actions: int = 0          # discrete action count (0 = continuous)
    action_size: int = 0          # continuous action dim (0 = discrete)
    action_low: float = -1.0
    action_high: float = 1.0

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        raise NotImplementedError

    def step(self, actions: np.ndarray) -> Tuple[np.ndarray, np.ndarray,
                                                 np.ndarray, Dict[str, Any]]:
        """actions [B] int -> (obs [B, obs_size], reward [B], done [B], info).

        `done` = terminated | truncated (the auto-reset trigger). `info`
        carries the split the learner needs for correct bootstrapping
        (gymnasium separates terminateds/truncateds the same way):
          - "terminated" [B] bool: true environment termination (value 0)
          - "truncated"  [B] bool: time-limit cutoff (bootstrap with critic)
          - "final_obs" [B, obs_size]: the pre-reset observation for done
            rows (valid only where done; elsewhere it equals obs)
        """
        raise NotImplementedError


class CartPoleVecEnv(VectorEnv):
    """Classic cart-pole balancing, vectorized in numpy.

    Standard physics (Barto, Sutton & Anderson 1983): a pole hinged on a
    cart; actions push the cart left/right with a fixed force; episode ends
    when the pole tips past 12 degrees, the cart leaves +/-2.4, or after
    `max_steps`. Reward 1 per surviving step.
    """

    GRAVITY = 9.8
    CART_MASS = 1.0
    POLE_MASS = 0.1
    POLE_HALF_LEN = 0.5
    FORCE = 10.0
    DT = 0.02
    X_LIMIT = 2.4
    THETA_LIMIT = 12 * 2 * np.pi / 360

    observation_size = 4
    num_actions = 2

    def __init__(self, num_envs: int = 8, max_steps: int = 500,
                 seed: int = 0):
        self.num_envs = num_envs
        self.max_steps = max_steps
        self._rng = np.random.default_rng(seed)
        self._state = np.zeros((num_envs, 4), np.float64)
        self._steps = np.zeros(num_envs, np.int64)

    def _reset_indices(self, idx: np.ndarray) -> None:
        self._state[idx] = self._rng.uniform(-0.05, 0.05, (len(idx), 4))
        self._steps[idx] = 0

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._reset_indices(np.arange(self.num_envs))
        return self._state.astype(np.float32)

    def step(self, actions: np.ndarray):
        x, x_dot, th, th_dot = self._state.T
        force = np.where(actions == 1, self.FORCE, -self.FORCE)
        total_mass = self.CART_MASS + self.POLE_MASS
        pm_len = self.POLE_MASS * self.POLE_HALF_LEN
        cos_t, sin_t = np.cos(th), np.sin(th)
        temp = (force + pm_len * th_dot ** 2 * sin_t) / total_mass
        th_acc = (self.GRAVITY * sin_t - cos_t * temp) / (
            self.POLE_HALF_LEN
            * (4.0 / 3.0 - self.POLE_MASS * cos_t ** 2 / total_mass))
        x_acc = temp - pm_len * th_acc * cos_t / total_mass
        x = x + self.DT * x_dot
        x_dot = x_dot + self.DT * x_acc
        th = th + self.DT * th_dot
        th_dot = th_dot + self.DT * th_acc
        self._state = np.stack([x, x_dot, th, th_dot], axis=1)
        self._steps += 1

        terminated = ((np.abs(x) > self.X_LIMIT)
                      | (np.abs(th) > self.THETA_LIMIT))
        truncated = (self._steps >= self.max_steps) & ~terminated
        done = terminated | truncated
        reward = np.ones(self.num_envs, np.float32)
        final_obs = self._state.astype(np.float32)
        if done.any():
            self._reset_indices(np.flatnonzero(done))
        return (self._state.astype(np.float32), reward,
                done.astype(np.bool_),
                {"terminated": terminated.astype(np.bool_),
                 "truncated": truncated.astype(np.bool_),
                 "final_obs": final_obs})


class PendulumVecEnv(VectorEnv):
    """Inverted-pendulum swing-up, vectorized in numpy — the canonical
    continuous-control test env (SAC's CartPole). Standard dynamics
    (gymnasium Pendulum-v1): state (theta, theta_dot), observation
    (cos, sin, theta_dot), torque action in [-2, 2], cost
    theta^2 + 0.1*theta_dot^2 + 0.001*torque^2; 200-step episodes,
    truncation only (no termination)."""

    GRAVITY = 10.0
    MASS = 1.0
    LENGTH = 1.0
    DT = 0.05
    MAX_SPEED = 8.0
    MAX_TORQUE = 2.0

    observation_size = 3
    num_actions = 0
    action_size = 1
    action_low = -2.0
    action_high = 2.0

    def __init__(self, num_envs: int = 8, max_steps: int = 200,
                 seed: int = 0):
        self.num_envs = num_envs
        self.max_steps = max_steps
        self._rng = np.random.default_rng(seed)
        self._theta = np.zeros(num_envs, np.float64)
        self._theta_dot = np.zeros(num_envs, np.float64)
        self._steps = np.zeros(num_envs, np.int64)

    def _reset_indices(self, idx: np.ndarray) -> None:
        self._theta[idx] = self._rng.uniform(-np.pi, np.pi, len(idx))
        self._theta_dot[idx] = self._rng.uniform(-1.0, 1.0, len(idx))
        self._steps[idx] = 0

    def _obs(self) -> np.ndarray:
        return np.stack([np.cos(self._theta), np.sin(self._theta),
                         self._theta_dot], axis=1).astype(np.float32)

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._reset_indices(np.arange(self.num_envs))
        return self._obs()

    def step(self, actions: np.ndarray):
        u = np.clip(np.asarray(actions, np.float64).reshape(self.num_envs),
                    -self.MAX_TORQUE, self.MAX_TORQUE)
        th = ((self._theta + np.pi) % (2 * np.pi)) - np.pi  # wrap to +-pi
        cost = th ** 2 + 0.1 * self._theta_dot ** 2 + 0.001 * u ** 2
        g, m, l, dt = self.GRAVITY, self.MASS, self.LENGTH, self.DT
        th_dot = self._theta_dot + dt * (
            3 * g / (2 * l) * np.sin(self._theta)
            + 3.0 / (m * l ** 2) * u)
        th_dot = np.clip(th_dot, -self.MAX_SPEED, self.MAX_SPEED)
        self._theta = self._theta + dt * th_dot
        self._theta_dot = th_dot
        self._steps += 1

        truncated = self._steps >= self.max_steps
        terminated = np.zeros(self.num_envs, np.bool_)
        done = truncated.copy()
        final_obs = self._obs()
        if done.any():
            self._reset_indices(np.flatnonzero(done))
        return (self._obs(), (-cost).astype(np.float32), done,
                {"terminated": terminated, "truncated": truncated,
                 "final_obs": final_obs})


_ENV_REGISTRY = {"CartPole": CartPoleVecEnv, "Pendulum": PendulumVecEnv}


def register_env(name: str, ctor) -> None:
    """Parity: ray.tune.registry.register_env."""
    _ENV_REGISTRY[name] = ctor


def make_env(name_or_ctor, num_envs: int, seed: int = 0) -> VectorEnv:
    if callable(name_or_ctor):
        return name_or_ctor(num_envs=num_envs, seed=seed)
    ctor = _ENV_REGISTRY.get(name_or_ctor)
    if ctor is None:
        raise KeyError(f"unknown env {name_or_ctor!r}; register_env() it")
    return ctor(num_envs=num_envs, seed=seed)
