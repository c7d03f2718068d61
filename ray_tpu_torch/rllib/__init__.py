"""RLlib-lite in PyTorch (``ray_tpu/rllib``).

The same surface as ``ray_tpu.rllib``: env runners, PPO/DQN/SAC/IMPALA
learners and algorithms, offline BC and CQL, multi-agent PPO, the numpy
envs and replay buffers. Learners, runners and configs take ``device``
(None = the card; ``"cpu"`` runs on the CPU). ``OfflineData`` reads
a ``ray_tpu_torch.data`` ``Dataset``. The remote modes ride the runtime's
actors (``ray_tpu_torch.init()``): ``num_env_runners > 0`` starts env
runner actors on the CPU (IMPALA's asynchronous), and ``num_learners >
0`` a learner gang on ``device`` that averages gradients over
``ray_tpu_torch.util.collective``.
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
