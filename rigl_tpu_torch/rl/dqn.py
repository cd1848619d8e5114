"""Sparse DQN, in PyTorch.

Counterpart of rigl_tpu/rl/dqn.py (capability parity with
rigl/rl/dqn_agents.py SparseDQNAgent, :309-494): modes {dense, prune,
rigl, static, set, snip, dnw}, the mask update wired into the optimizer
step (transforms/sparse_training.py), and target-network syncs that copy
masks along with weights (:459-472).

What changes in PyTorch:
  * no jit: `collect_and_learn` runs `learn_every` env steps and the
    gated learn step eagerly, on the env's device.  The counters that
    gate work are host integers: env steps, the replay size, the learn
    cadence, the min-replay gate and the target-sync test on
    SparseState.step (itself a host integer).  Returns and episode counts
    stay on the device and are read at log points, so a step makes no
    host sync.
  * the network is an nn.Module whose own parameters are the state's
    `params` ({path: tensor}); SparseTraining's Adam
    (torch.optim.Adam(lr, eps=1e-8), optax.adam's update) updates them in
    place.  The target network's params and masks are clones: an alias
    would make the target the online network.
  * JAX's keys become torch generators on the device: the agent's
    (`DQNState.gen`: epsilon, the random action, replay indices) and the
    env's.  `_env_step` and `_learn` take their draws as arguments, which
    a test fills with JAX's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from rigl_tpu_torch.rl import replay
from rigl_tpu_torch.rl.envs import CartPole, EnvState
from rigl_tpu_torch.sparsity import masks as masks_lib
from rigl_tpu_torch.transforms.sparse_training import (SparseState,
                                                       SparseTraining, _seed)


@dataclasses.dataclass
class DQNConfig:
  training_method: str = 'rigl'
  sparsity: float = 0.9
  mask_init_method: str = 'erdos_renyi_kernel'
  maskupdate_frequency: int = 500
  maskupdate_begin_step: int = 200
  maskupdate_end_step: int = -1
  drop_fraction: float = 0.3
  learning_rate: float = 1e-3
  gamma: float = 0.99
  buffer_capacity: int = 10000
  batch_size: int = 64
  learn_every: int = 4          # env steps between learn steps
  min_replay: int = 500
  target_update_period: int = 100   # in learn steps
  epsilon_start: float = 1.0
  epsilon_end: float = 0.05
  epsilon_decay_steps: int = 5000
  # L2 on the online network's weights, added to the TD loss
  # (dqn_agents.py:391-394; tfagents kernel_regularizer parity).
  weight_decay: float = 0.0
  seed: int = 0
  # Pre-masked parameter storage (transforms/sparse_training.py): skips
  # the mask multiply in both the per-env-step action selection and the
  # learn step.  Drop/grow family only.
  premask_params: bool = False


# ------------------------------------------------------- shared helpers ---
def adam(lr: float):
  """optax.adam(lr) as SparseTraining's `tx`."""
  return lambda params: torch.optim.Adam(params, lr=lr, eps=1e-8)


def build_sparse_training(cfg, anneal: str, seed: int) -> SparseTraining:
  """SparseTraining over Adam with the algorithm the Trainer builds from
  the agent's schedule fields (JAX's TrainConfig of the same fields)."""
  from rigl_tpu_torch.train.trainer import TrainConfig, build_algorithm
  algo = build_algorithm(TrainConfig(
      training_method=cfg.training_method, sparsity=cfg.sparsity,
      maskupdate_begin_step=cfg.maskupdate_begin_step,
      maskupdate_end_step=cfg.maskupdate_end_step,
      maskupdate_frequency=cfg.maskupdate_frequency,
      drop_fraction=cfg.drop_fraction, drop_fraction_anneal=anneal))
  return SparseTraining(adam(cfg.learning_rate), algo,
                        distribution=cfg.mask_init_method,
                        default_sparsity=cfg.sparsity, seed=seed,
                        premask_params=cfg.premask_params)


def effective(params: Dict[str, torch.Tensor], masks, premask: bool,
              grad: bool = False) -> Dict[str, torch.Tensor]:
  """The effective parameters: the stored ones under pre-masked storage,
  else the masked copies (one foreach product).  With `grad`, leaves
  whose gradient is the dense gradient at masked entries (the masked
  copies detached from the stored weights); without, detached tensors."""
  if premask:
    return dict(params) if grad else {p: t.detach()
                                      for p, t in params.items()}
  out = {p: t.detach() for p, t in params.items()}
  masked = [p for p in out if p in masks]
  if masked:
    prods = torch._foreach_mul([out[p] for p in masked],
                               [masks[p].to(out[p].dtype) for p in masked])
    out.update(zip(masked, prods))
  if grad:
    for t in out.values():
      t.requires_grad_()
  return out


def grads_of(loss: torch.Tensor, eff: Dict[str, torch.Tensor]):
  names = list(eff)
  gs = torch.autograd.grad(loss, [eff[p] for p in names], allow_unused=True)
  return {p: torch.zeros_like(eff[p]) if g is None else g
          for p, g in zip(names, gs)}


def l2_half(eff: Dict[str, torch.Tensor]) -> torch.Tensor:
  """tf.nn.l2_loss over every leaf: sum(w^2) / 2 per tensor, summed in
  JAX's leaf order."""
  total = None
  for p in masks_lib.path_sorted(eff):
    term = torch.sum(torch.square(eff[p])) / 2
    total = term if total is None else total + term
  return total


def clone_dict(d: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
  return {p: t.detach().clone() for p, t in d.items()}


def episode_bookkeeping(state, reward, done):
  """(episode_return, completed_returns_sum, completed_episodes) after a
  step with `reward` and `done`, on the device."""
  ep_ret = state.episode_return + reward
  return (torch.where(done, torch.zeros_like(ep_ret), ep_ret),
          state.completed_returns_sum
          + torch.where(done, ep_ret, torch.zeros_like(ep_ret)),
          state.completed_episodes + done.to(torch.int32))


def avg_return(state) -> torch.Tensor:
  return state.completed_returns_sum / torch.clamp(state.completed_episodes,
                                                   min=1)


def zero_counters(device):
  return dict(episode_return=torch.zeros((), device=device),
              completed_returns_sum=torch.zeros((), device=device),
              completed_episodes=torch.zeros((), dtype=torch.int32,
                                             device=device))


def generator(device, seed: int, *tags) -> torch.Generator:
  return torch.Generator(device=device).manual_seed(_seed(seed, *tags))


# ------------------------------------------------------------------ DQN ---
@dataclasses.dataclass
class DQNState:
  params: Dict[str, torch.Tensor]
  target_params: Dict[str, torch.Tensor]
  target_masks: Dict[str, torch.Tensor]
  optimizer: torch.optim.Optimizer
  sparse: SparseState
  buffer: replay.ReplayBuffer
  env_state: EnvState
  gen: torch.Generator
  env_steps: int
  # episode-return bookkeeping, on the device
  episode_return: torch.Tensor
  completed_returns_sum: torch.Tensor
  completed_episodes: torch.Tensor

  def replace(self, **changes) -> 'DQNState':
    return dataclasses.replace(self, **changes)


class SparseDQN:
  """DQN with dynamic sparse Q-networks.  `network` is a module of
  rl/networks.py on the env's device."""

  def __init__(self, network, env: CartPole,
               config: Optional[DQNConfig] = None):
    self.net = network
    self.env = env
    self.device = env.device
    self.config = config or DQNConfig()
    cfg = self.config
    self.st = build_sparse_training(
        cfg, 'cosine' if cfg.maskupdate_end_step > 0 else 'constant',
        cfg.seed)
    self.algo = self.st.algo

  # ------------------------------------------------------------------------
  def init(self, seed: int) -> DQNState:
    """Fresh weights, masks, optimizer, replay and env from `seed` (the
    weights from a CPU generator, so every device starts equal)."""
    cfg = self.config
    self.net.reset_parameters(torch.Generator().manual_seed(_seed(seed, 0)))
    params = masks_lib.param_dict(self.net)
    optimizer, sstate = self.st.init(_seed(seed, 1), params)
    if cfg.premask_params:
      with torch.no_grad():
        for p, m in sstate.masks.items():
          params[p].mul_(m.to(params[p].dtype))
    return DQNState(
        params=params, target_params=clone_dict(params),
        target_masks=clone_dict(sstate.masks), optimizer=optimizer,
        sparse=sstate,
        buffer=replay.create(cfg.buffer_capacity, self.env.obs_shape,
                             device=self.device),
        env_state=self.env.reset(generator(self.device, seed, 2)),
        gen=generator(self.device, seed, 3), env_steps=0,
        **zero_counters(self.device))

  def _q(self, params, masks, obs):
    with torch.no_grad():
      return self.net.apply_params(
          effective(params, masks, self.config.premask_params), obs)

  def _epsilon(self, env_steps: int) -> float:
    """JAX's float32 schedule: start + clip(steps / decay, 0, 1) * (end -
    start)."""
    cfg = self.config
    frac = np.clip(np.float32(env_steps) / np.float32(cfg.epsilon_decay_steps),
                   np.float32(0.0), np.float32(1.0))
    return float(np.float32(cfg.epsilon_start)
                 + frac * np.float32(cfg.epsilon_end - cfg.epsilon_start))

  def _loss(self, eff_params, target_params, target_masks, batch):
    cfg = self.config
    q = self.net.apply_params(eff_params, batch['obs'])
    q_sa = q.gather(1, batch['action'].to(torch.int64)[:, None])[:, 0]
    q_next = self._q(target_params, target_masks, batch['next_obs'])
    target = batch['reward'] + cfg.gamma * (
        1.0 - batch['done'].to(torch.float32)) * q_next.max(dim=1).values
    loss = F.huber_loss(q_sa, target.detach(), delta=1.0)
    if cfg.weight_decay:
      # tf.nn.l2_loss convention: sum(w^2) / 2 per tensor
      # (dqn_agents.py:391-394).
      loss = loss + cfg.weight_decay * l2_half(eff_params)
    return loss

  # ------------------------------------------------------------------------
  def draw_env_step(self, state: DQNState) -> Dict[str, Any]:
    """One env step's agent draws: 'u' (uniform, explore below epsilon)
    and 'random_action'."""
    u = torch.rand(2, generator=state.gen, device=self.device)
    n = self.env.num_actions
    return {'u': u[0],
            'random_action': torch.clamp((u[1] * n).floor().to(torch.int64),
                                         max=n - 1)}

  def _env_step(self, state: DQNState, draws=None, env_draws=None
                ) -> DQNState:
    draws = draws if draws is not None else self.draw_env_step(state)
    obs = state.env_state.obs
    q = self._q(state.params, state.sparse.masks, obs[None])[0]
    greedy = torch.argmax(q)
    explore = draws['u'] < self._epsilon(state.env_steps)
    action = torch.where(explore, draws['random_action'].to(greedy.dtype),
                         greedy)
    next_env, reward, done = self.env.step(state.env_state, action,
                                           env_draws)
    buf = replay.add(state.buffer, obs, action, reward, next_env.obs, done)
    ep, total, count = episode_bookkeeping(state, reward, done)
    return state.replace(env_state=next_env, buffer=buf,
                         env_steps=state.env_steps + 1, episode_return=ep,
                         completed_returns_sum=total,
                         completed_episodes=count)

  def _learn(self, state: DQNState, idx=None) -> DQNState:
    """One learn step on the replay indices `idx` (drawn from the state's
    generator when None)."""
    cfg = self.config
    if idx is None:
      idx = replay.sample_indices(state.buffer, state.gen, cfg.batch_size)
    batch = replay.gather(state.buffer, idx)
    eff = effective(state.params, state.sparse.masks, cfg.premask_params,
                    grad=True)
    loss = self._loss(eff, state.target_params, state.target_masks, batch)
    grads = grads_of(loss, eff)
    params, optimizer, sstate, _ = self.st.step(
        state.params, state.optimizer, state.sparse, grads)
    target_params, target_masks = state.target_params, state.target_masks
    # Target sync every target_update_period learn steps: copies weights
    # AND masks (dqn_agents.py:459-472), checked after the step.
    if sstate.step % cfg.target_update_period == 0:
      target_params = clone_dict(params)
      target_masks = clone_dict(sstate.masks)
    return state.replace(params=params, optimizer=optimizer, sparse=sstate,
                         target_params=target_params,
                         target_masks=target_masks)

  def collect_and_learn(self, state: DQNState
                        ) -> Tuple[DQNState, Dict[str, Any]]:
    """`learn_every` env steps + one (replay-gated) learn step."""
    cfg = self.config
    for _ in range(cfg.learn_every):
      state = self._env_step(state)
    if state.buffer.size >= cfg.min_replay:
      state = self._learn(state)
    metrics = {
        'env_steps': state.env_steps,
        'learn_steps': state.sparse.step,
        'avg_return': avg_return(state),
        'episodes': state.completed_episodes,
    }
    return state, metrics

  # ------------------------------------------------------------------------
  def train(self, total_env_steps: int, log_every: int = 1000,
            progress_fn=None) -> Dict[str, Any]:
    state = self.init(self.config.seed)
    metrics = {}
    n_chunks = total_env_steps // self.config.learn_every
    for i in range(n_chunks):
      state, metrics = self.collect_and_learn(state)
      if progress_fn and log_every and (
          (i + 1) % max(log_every // self.config.learn_every, 1) == 0):
        progress_fn({k: float(v) for k, v in metrics.items()})
    self.state = state
    result = {k: float(v) for k, v in metrics.items()}
    if state.sparse.masks:
      result['global_sparsity'] = float(
          masks_lib.calculate_sparsity(state.sparse.masks))
    return result
