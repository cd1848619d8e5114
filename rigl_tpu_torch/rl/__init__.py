"""Sparse RL workload: device-resident envs and replay, sparse DQN, PPO
and SAC (counterpart of rigl_tpu/rl)."""

from rigl_tpu_torch.rl.dqn import DQNConfig, SparseDQN
from rigl_tpu_torch.rl.envs import CartPole
from rigl_tpu_torch.rl.networks import ImpalaNet, MLPQNetwork, NatureDQN
from rigl_tpu_torch.rl.envs import Pendulum
from rigl_tpu_torch.rl.ppo import PPOConfig, SparsePPO
from rigl_tpu_torch.rl.sac import SACConfig, SparseSAC
from rigl_tpu_torch.rl.runner import PhaseRunner
