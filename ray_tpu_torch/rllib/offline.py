"""Offline RL: experience datasets, BC and discrete CQL
(``ray_tpu/rllib/offline.py``).

``OfflineData`` holds the transition columns as numpy on the host:
``from_batches`` and ``from_buffer`` keep the merged columns directly,
which is what ``ray_tpu``'s ``_materialize`` makes of its ``Dataset``, so
``sample`` and ``iter_epochs`` give ``ray_tpu``'s indices from the same
numpy generators. The constructor also takes any object with
``iter_batches(batch_size=None)`` yielding column dicts (read once, then
held). A ``ray_tpu.data`` ``Dataset`` lives in ``ray_tpu``'s runtime and
raises until the port has that runtime.

``BCLearner`` (cross-entropy on the dataset's actions) and ``CQLLearner``
(the double-DQN TD update plus ``cql_alpha * (logsumexp_a Q - Q(s,
a_data))``) share the learner protocol of ``dqn.py``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, Optional, Union

import numpy as np
import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.rllib import models
from ray_tpu_torch.rllib.dqn import DQNLearner, huber
from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.env_runner import RUNTIME_ITEM, obs_tensor
from ray_tpu_torch.rllib.learner import Adam, host_stats, to_tensors
from ray_tpu_torch.rllib.learner_group import LearnerGroup

_COLUMNS = ("obs", "actions", "rewards", "next_obs", "dones")


class OfflineData:
    """Transition columns for offline learners: a dict of numpy columns,
    or any object with ``iter_batches(batch_size=None)``."""

    def __init__(self, dataset):
        if type(dataset).__module__.split(".")[0] == "ray_tpu":
            raise NotImplementedError(
                f"OfflineData over a ray_tpu Dataset waits for "
                f"{RUNTIME_ITEM}; pass numpy columns (from_batches, "
                "from_buffer) or an object with iter_batches()")
        if isinstance(dataset, dict):
            self.dataset = None
            self._cached: Optional[Dict[str, np.ndarray]] = {
                k: np.asarray(dataset[k]) for k in _COLUMNS}
        elif hasattr(dataset, "iter_batches"):
            self.dataset = dataset
            self._cached = None
        else:
            raise TypeError(f"OfflineData takes a dict of columns or an "
                            f"object with iter_batches(), not "
                            f"{type(dataset).__name__}")

    # ------------------------------------------------------ constructors

    @classmethod
    def from_batches(cls, batches) -> "OfflineData":
        """From transition dicts as produced by the env runners."""
        return cls({k: np.concatenate([np.asarray(b[k]) for b in batches])
                    for k in _COLUMNS})

    @classmethod
    def from_buffer(cls, buffer) -> "OfflineData":
        """Snapshot a live ReplayBuffer's contents."""
        n = len(buffer)
        return cls({
            "obs": buffer._obs[:n].copy(),
            "actions": buffer._actions[:n].copy(),
            "rewards": buffer._rewards[:n].copy(),
            "next_obs": buffer._next_obs[:n].copy(),
            "dones": buffer._dones[:n].copy(),
        })

    # ------------------------------------------------------------ access

    def _materialize(self) -> Dict[str, np.ndarray]:
        """Read the dataset once, then sample from host memory."""
        if self._cached is None:
            parts: Dict[str, list] = {k: [] for k in _COLUMNS}
            for block in self.dataset.iter_batches(batch_size=None):
                for k in _COLUMNS:
                    parts[k].append(np.asarray(block[k]))
            self._cached = {k: np.concatenate(v) for k, v in parts.items()}
        return self._cached

    def __len__(self) -> int:
        return len(self._materialize()["actions"])

    def sample(self, batch_size: int,
               rng: np.random.Generator) -> Dict[str, np.ndarray]:
        data = self._materialize()
        idx = rng.integers(0, len(data["actions"]), batch_size)
        return {k: v[idx] for k, v in data.items()}

    def iter_epochs(self, batch_size: int, epochs: int,
                    seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Shuffled epoch iteration (BC-style supervised passes)."""
        data = self._materialize()
        n = len(data["actions"])
        rng = np.random.default_rng(seed)
        for _ in range(epochs):
            perm = rng.permutation(n)
            for lo in range(0, n - batch_size + 1, batch_size):
                idx = perm[lo:lo + batch_size]
                yield {k: v[idx] for k, v in data.items()}


# --------------------------------------------------------------------------
# Behavior cloning
# --------------------------------------------------------------------------


class BCLearner:
    """Discrete behavior cloning: cross-entropy on dataset actions.
    ``device=None`` is the card."""

    def __init__(self, obs_size: int, num_actions: int, *,
                 hidden: int = 64, lr: float = 1e-3, seed: int = 0,
                 device=None):
        self.device = resolve_device(device)
        self.params = models.init_q_params(
            torch.Generator().manual_seed(seed), obs_size, num_actions,
            hidden, self.device)
        self.optimizer = Adam(self.params, lr)

    def get_weights(self):
        return self.params

    def set_weights(self, params) -> None:
        models.assign_(self.params, params)

    def update_from_batch(self, batch: Dict[str, np.ndarray]
                          ) -> Dict[str, float]:
        grads, stats, _ = self.compute_grads(batch)
        self.apply_grads(grads)
        return stats

    def compute_grads(self, batch: Dict[str, np.ndarray]):
        b = to_tensors({k: batch[k] for k in ("obs", "actions")},
                       self.device)
        logits = models.q_apply(self.params, b["obs"])
        logp = torch.log_softmax(logits, -1)
        loss = -logp.gather(-1, b["actions"][:, None])[:, 0].mean()
        acc = (torch.argmax(logits.detach(), -1) == b["actions"]).float(
        ).mean()
        grads = torch.autograd.grad(loss, self.optimizer.leaves)
        return grads, host_stats(("loss", "action_accuracy"),
                                 (loss.detach(), acc)), None

    def apply_grads(self, grads) -> None:
        self.optimizer.step(grads)


# --------------------------------------------------------------------------
# Discrete CQL
# --------------------------------------------------------------------------


class CQLLearner(DQNLearner):
    """Conservative Q-learning on the double-DQN TD update: TD loss +
    cql_alpha * (logsumexp_a Q(s,a) - Q(s, a_data)). The TD term carries
    no replay weights."""

    def __init__(self, obs_size: int, num_actions: int, *,
                 cql_alpha: float = 1.0, **kw):
        self.cql_alpha = cql_alpha
        super().__init__(obs_size, num_actions, **kw)

    def _loss(self, b: Dict[str, torch.Tensor], targets: torch.Tensor):
        q_all = models.q_apply(self.params, b["obs"])
        q = q_all.gather(-1, b["actions"][:, None])[:, 0]
        td = q - targets
        conservative = (torch.logsumexp(q_all, -1) - q).mean()
        loss = huber(td, self.huber_delta).mean() \
            + self.cql_alpha * conservative
        return loss, q.mean(), td


# --------------------------------------------------------------------------
# Algorithms
# --------------------------------------------------------------------------


def _evaluate_greedy(params, env_spec, *, episodes: int = 8,
                     seed: int = 123) -> float:
    """Roll the greedy policy on the params' device; returns the mean
    return of each slot's first episode."""
    device = models.leaves(params)[0].device
    env = make_env(env_spec, num_envs=episodes, seed=seed)
    obs = env.reset(seed=seed)
    ep_return = np.zeros(episodes, np.float64)
    total = np.full(episodes, np.nan)
    for _ in range(2000):
        with torch.no_grad():
            a = models.q_apply(params, obs_tensor(obs, device)
                               ).argmax(-1).cpu().numpy()
        obs, r, done, _info = env.step(a)
        ep_return += r * np.isnan(total)  # only first episode per slot
        for i in np.flatnonzero(done):
            if np.isnan(total[i]):
                total[i] = ep_return[i]
        if not np.isnan(total).any():
            break
    return float(np.nanmean(np.where(np.isnan(total), ep_return, total)))


@dataclasses.dataclass
class BCConfig:
    """(reference: BCConfig fluent API, trimmed)."""

    env: Union[str, Callable] = "CartPole"   # for evaluation only
    data: Optional[OfflineData] = None       # set via .offline_data()
    hidden: int = 64
    lr: float = 1e-3
    train_batch_size: int = 256
    updates_per_iteration: int = 100
    num_learners: int = 0
    seed: int = 0
    device: Any = None

    def training(self, *, lr: float = None, train_batch_size: int = None,
                 updates_per_iteration: int = None) -> "BCConfig":
        for name, val in (("lr", lr),
                          ("train_batch_size", train_batch_size),
                          ("updates_per_iteration", updates_per_iteration)):
            if val is not None:
                setattr(self, name, val)
        return self

    def offline_data(self, data: OfflineData) -> "BCConfig":
        self.data = data
        return self

    def environment(self, env) -> "BCConfig":
        self.env = env
        return self

    def build(self) -> "BC":
        return BC(self)


class _OfflineAlgo:
    """Shared offline train loop: sample from the dataset, update the
    learner group, evaluate greedily on the real env."""

    def __init__(self, config, learner_factory):
        self.config = config
        if config.data is None:
            raise ValueError(
                "no offline data configured: pass an OfflineData via "
                "config.offline_data(...) before build()")
        self.data: OfflineData = config.data
        self.learner_group = LearnerGroup(
            learner_factory, num_learners=config.num_learners)
        self._rng = np.random.default_rng(config.seed)
        self._iteration = 0

    def training_step(self) -> Dict[str, Any]:
        stats: Dict[str, Any] = {}
        for _ in range(self.config.updates_per_iteration):
            batch = self.data.sample(self.config.train_batch_size,
                                     self._rng)
            stats = self.learner_group.update_from_batch(batch)
            stats.pop("td_errors", None)
        return stats

    def train(self) -> Dict[str, Any]:
        t0 = time.monotonic()
        stats = self.training_step()
        self._iteration += 1
        return {
            "training_iteration": self._iteration,
            "time_this_iter_s": time.monotonic() - t0,
            "learners": {"default_policy": stats},
        }

    def evaluate(self, episodes: int = 8) -> Dict[str, Any]:
        ret = _evaluate_greedy(self.learner_group.get_weights(),
                               self.config.env, episodes=episodes,
                               seed=self.config.seed + 777)
        return {"env_runners": {"episode_return_mean": ret}}

    def get_weights(self):
        return self.learner_group.get_weights()

    def stop(self) -> None:
        self.learner_group.stop()


class BC(_OfflineAlgo):
    """Pure supervised policy extraction."""

    def __init__(self, config: BCConfig):
        probe = make_env(config.env, num_envs=1, seed=config.seed)
        obs_size, num_actions = probe.observation_size, probe.num_actions

        def factory():
            return BCLearner(obs_size, num_actions, hidden=config.hidden,
                             lr=config.lr, seed=config.seed,
                             device=config.device)

        super().__init__(config, factory)


@dataclasses.dataclass
class CQLConfig:
    """(reference: CQLConfig fluent API, trimmed to the discrete case)."""

    env: Union[str, Callable] = "CartPole"
    data: Optional[OfflineData] = None       # set via .offline_data()
    hidden: int = 64
    lr: float = 1e-3
    gamma: float = 0.99
    cql_alpha: float = 1.0
    target_update_freq: int = 200
    train_batch_size: int = 256
    updates_per_iteration: int = 100
    num_learners: int = 0
    seed: int = 0
    device: Any = None

    def training(self, *, lr: float = None, gamma: float = None,
                 cql_alpha: float = None, train_batch_size: int = None,
                 target_network_update_freq: int = None,
                 updates_per_iteration: int = None) -> "CQLConfig":
        for name, val in (("lr", lr), ("gamma", gamma),
                          ("cql_alpha", cql_alpha),
                          ("train_batch_size", train_batch_size),
                          ("target_update_freq",
                           target_network_update_freq),
                          ("updates_per_iteration", updates_per_iteration)):
            if val is not None:
                setattr(self, name, val)
        return self

    def offline_data(self, data: OfflineData) -> "CQLConfig":
        self.data = data
        return self

    def environment(self, env) -> "CQLConfig":
        self.env = env
        return self

    def build(self) -> "CQL":
        return CQL(self)


class CQL(_OfflineAlgo):
    """Offline TD with the conservative regularizer; discrete variant."""

    def __init__(self, config: CQLConfig):
        probe = make_env(config.env, num_envs=1, seed=config.seed)
        obs_size, num_actions = probe.observation_size, probe.num_actions

        def factory():
            return CQLLearner(
                obs_size, num_actions, cql_alpha=config.cql_alpha,
                hidden=config.hidden, lr=config.lr, gamma=config.gamma,
                target_update_freq=config.target_update_freq,
                seed=config.seed, device=config.device)

        super().__init__(config, factory)
