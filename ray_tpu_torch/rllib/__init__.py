"""RLlib-lite in PyTorch (``ray_tpu/rllib``), local modes.

The same surface as ``ray_tpu.rllib``: env runners, PPO/DQN/SAC/IMPALA
learners and algorithms, offline BC and CQL, multi-agent PPO, the numpy
envs and replay buffers. Learners, runners and configs take ``device``
(None = the card; ``"cpu"`` runs on the CPU). Remote env runners, learner
gangs, IMPALA's asynchronous runners and ``OfflineData`` over a
``ray_tpu.data`` ``Dataset`` ride the cluster runtime's actors and
collectives, and raise ``NotImplementedError`` until the port has them.
"""

from ray_tpu_torch.rllib.dqn import DQN, DQNConfig, DQNLearner
from ray_tpu_torch.rllib.env import (CartPoleVecEnv, PendulumVecEnv,
                                     VectorEnv, make_env, register_env)
from ray_tpu_torch.rllib.env_runner import EnvRunner, EnvRunnerGroup
from ray_tpu_torch.rllib.learner import PPOLearner
from ray_tpu_torch.rllib.learner_group import LearnerGroup
from ray_tpu_torch.rllib.offline import (BC, BCConfig, BCLearner, CQL,
                                         CQLConfig, CQLLearner, OfflineData)
from ray_tpu_torch.rllib.ppo import PPO, PPOConfig
from ray_tpu_torch.rllib.replay_buffers import (PrioritizedReplayBuffer,
                                                ReplayBuffer)
from ray_tpu_torch.rllib.sac import SAC, SACConfig, SACLearner

__all__ = [
    "CartPoleVecEnv", "PendulumVecEnv", "VectorEnv", "make_env",
    "register_env", "EnvRunner", "EnvRunnerGroup", "PPOLearner",
    "PPO", "PPOConfig", "DQN", "DQNConfig", "DQNLearner", "LearnerGroup",
    "SAC", "SACConfig", "SACLearner",
    "BC", "BCConfig", "BCLearner", "CQL", "CQLConfig", "CQLLearner",
    "OfflineData", "PrioritizedReplayBuffer", "ReplayBuffer",
]
