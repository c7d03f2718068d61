"""Replay buffers for off-policy RL (a copy of
``ray_tpu/rllib/replay_buffers.py``).

The port keeps its own copy, since it imports nothing of ``ray_tpu``:
the same numpy storage and ``np.random.default_rng`` streams, so the same
seeds give the same samples and indices. Storage stays on the host; a
sampled batch goes to the learner's device in one copy per column.

Parity target: the reference's replay buffer family
(reference: rllib/utils/replay_buffers/replay_buffer.py ReplayBuffer —
ring storage + uniform sample — and prioritized_episode_buffer.py).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


class ReplayBuffer:
    """Uniform ring replay buffer over [obs, action, reward, next_obs,
    done] transitions."""

    def __init__(self, capacity: int, obs_size: int, seed: int = 0,
                 action_size: int = 0):
        """``action_size`` 0 = discrete scalar int actions (DQN); N > 0 =
        continuous [N]-float actions (SAC)."""
        self.capacity = int(capacity)
        self._obs = np.empty((capacity, obs_size), np.float32)
        self._next_obs = np.empty((capacity, obs_size), np.float32)
        if action_size:
            self._actions = np.empty((capacity, action_size), np.float32)
        else:
            self._actions = np.empty((capacity,), np.int32)
        self._rewards = np.empty((capacity,), np.float32)
        self._dones = np.empty((capacity,), np.float32)
        self._size = 0
        self._head = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._size

    def add_batch(self, obs, actions, rewards, next_obs, dones) -> None:
        """Append a batch of transitions (vector-env steps arrive
        batched; one at a time would be a Python-loop tax)."""
        n = len(actions)
        idx = (self._head + np.arange(n)) % self.capacity
        self._obs[idx] = obs
        self._actions[idx] = actions
        self._rewards[idx] = rewards
        self._next_obs[idx] = next_obs
        self._dones[idx] = dones
        self._head = int((self._head + n) % self.capacity)
        self._size = int(min(self._size + n, self.capacity))

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        idx = self._rng.integers(0, self._size, batch_size)
        return {
            "obs": self._obs[idx],
            "actions": self._actions[idx],
            "rewards": self._rewards[idx],
            "next_obs": self._next_obs[idx],
            "dones": self._dones[idx],
        }


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritized replay (reference:
    prioritized_replay_buffer.py): sample probability ~ priority^alpha,
    importance weights correct the bias; new transitions enter at max
    priority so everything is seen at least once."""

    def __init__(self, capacity: int, obs_size: int, *, alpha: float = 0.6,
                 beta: float = 0.4, seed: int = 0):
        super().__init__(capacity, obs_size, seed)
        self.alpha = alpha
        self.beta = beta
        self._prio = np.zeros((capacity,), np.float64)
        self._max_prio = 1.0

    def add_batch(self, obs, actions, rewards, next_obs, dones) -> None:
        n = len(actions)
        idx = (self._head + np.arange(n)) % self.capacity
        super().add_batch(obs, actions, rewards, next_obs, dones)
        self._prio[idx] = self._max_prio

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        p = self._prio[:self._size] ** self.alpha
        p = p / p.sum()
        idx = self._rng.choice(self._size, batch_size, p=p)
        w = (self._size * p[idx]) ** (-self.beta)
        out = {
            "obs": self._obs[idx],
            "actions": self._actions[idx],
            "rewards": self._rewards[idx],
            "next_obs": self._next_obs[idx],
            "dones": self._dones[idx],
            "weights": (w / w.max()).astype(np.float32),
            "indices": idx,
        }
        return out

    def update_priorities(self, indices: np.ndarray,
                          td_errors: np.ndarray) -> None:
        prio = np.abs(td_errors) + 1e-6
        self._prio[indices] = prio
        self._max_prio = max(self._max_prio, float(prio.max()))
