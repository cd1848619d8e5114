"""Sparse SAC, in PyTorch.

Counterpart of rigl_tpu/rl/sac.py (capability parity with
rigl/rl/tfagents/sac_train_eval.py: sparse actor and twin-critic
networks, mask updaters inside the train step, :378-421, soft target
updates, a tanh-squashed Gaussian policy with a learned temperature).
Actor and critic each have their own SparseTraining
(sac_train_eval.py:309-313); log alpha has its own Adam.

As in rl/dqn.py: eager on the env's device, host counters, returns on
the device, torch generators for JAX's keys, and `_env_step` / `_learn`
take their draws as arguments.  The target critic's params are clones
blended in place ((1 - tau) t + tau o) and its masks copies of the
online critic's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from rigl_tpu_torch.models.packed_convnet import Dense
from rigl_tpu_torch.rl import dqn as common
from rigl_tpu_torch.rl import replay
from rigl_tpu_torch.rl.envs import EnvState, Pendulum
from rigl_tpu_torch.rl.networks import _Net, dense, reset_parameters
from rigl_tpu_torch.sparsity import masks as masks_lib
from rigl_tpu_torch.transforms.sparse_training import SparseState, _seed

LOG_STD_MIN, LOG_STD_MAX = -10.0, 2.0


class GaussianActor(_Net):
  def __init__(self, action_dim: int, max_action: float,
               hidden: Sequence[int] = (64, 64), obs_dim: int = 3,
               generator: Optional[torch.Generator] = None, device='cuda'):
    super().__init__()
    self.max_action, self.hidden = max_action, tuple(hidden)
    widths = (obs_dim,) + self.hidden
    kw = dict(generator=generator, device=device)
    for i, h in enumerate(self.hidden):
      self.add_module(f'dense{i + 1}', Dense(widths[i], h, **kw))
    self.mean = Dense(widths[-1], action_dim, **kw)
    self.log_std = Dense(widths[-1], action_dim, **kw)
    reset_parameters(self, generator)

  def apply_params(self, params, x):
    for i in range(len(self.hidden)):
      x = torch.relu(dense(params, f'dense{i + 1}', x))
    return dense(params, 'mean', x), torch.clamp(
        dense(params, 'log_std', x), LOG_STD_MIN, LOG_STD_MAX)


def sample(actor: GaussianActor, eff, obs, eps):
  """A tanh-squashed Gaussian action and its log-prob with the tanh
  correction, from the standard normal noise `eps` (mean's shape)."""
  mean, log_std = actor.apply_params(eff, obs)
  std = torch.exp(log_std)
  pre_tanh = mean + std * eps
  action = torch.tanh(pre_tanh)
  logp = (-0.5 * (eps ** 2 + 2 * log_std + math.log(2 * math.pi))).sum(-1)
  logp = logp - torch.log(1 - action ** 2 + 1e-6).sum(-1)
  return action * actor.max_action, logp


class TwinCritic(_Net):
  def __init__(self, hidden: Sequence[int] = (64, 64), in_dim: int = 4,
               generator: Optional[torch.Generator] = None, device='cuda'):
    super().__init__()
    self.hidden = tuple(hidden)
    widths = (in_dim,) + self.hidden
    kw = dict(generator=generator, device=device)
    for head in ('q1', 'q2'):
      for i, w in enumerate(self.hidden):
        self.add_module(f'{head}_dense{i + 1}', Dense(widths[i], w, **kw))
      self.add_module(f'{head}_out', Dense(widths[-1], 1, **kw))
    reset_parameters(self, generator)

  def apply_params(self, params, obs, action):
    x = torch.cat([obs, action], dim=-1)
    qs = []
    for head in ('q1', 'q2'):
      h = x
      for i in range(len(self.hidden)):
        h = torch.relu(dense(params, f'{head}_dense{i + 1}', h))
      qs.append(dense(params, f'{head}_out', h)[:, 0])
    return qs[0], qs[1]


@dataclasses.dataclass
class SACConfig:
  training_method: str = 'rigl'
  sparsity: float = 0.8
  mask_init_method: str = 'erdos_renyi_kernel'
  maskupdate_frequency: int = 500
  maskupdate_begin_step: int = 200
  maskupdate_end_step: int = -1
  drop_fraction: float = 0.3
  learning_rate: float = 3e-4
  gamma: float = 0.99
  tau: float = 0.005            # soft target update rate
  buffer_capacity: int = 20000
  batch_size: int = 128
  learn_every: int = 1
  min_replay: int = 500
  target_entropy_scale: float = 1.0  # target entropy = -scale * action_dim
  # L2 on actor / critic weights, added to their losses (tfagents
  # sac_train_eval.py train_eval.weight_decay parity).
  weight_decay: float = 0.0
  seed: int = 0
  # Pre-masked parameter storage for the ONLINE actor / critic
  # (transforms/sparse_training.py).  The polyak-blended target critic
  # always keeps its mask multiply: blended weights at recently-dropped
  # positions are nonzero until the mask removes them.
  premask_params: bool = False


@dataclasses.dataclass
class SACState:
  actor_params: Dict[str, torch.Tensor]
  critic_params: Dict[str, torch.Tensor]
  target_critic_params: Dict[str, torch.Tensor]
  target_critic_masks: Dict[str, torch.Tensor]
  log_alpha: torch.Tensor
  actor_opt: torch.optim.Optimizer
  critic_opt: torch.optim.Optimizer
  alpha_opt: torch.optim.Optimizer
  actor_sparse: SparseState
  critic_sparse: SparseState
  buffer: replay.ReplayBuffer
  env_state: EnvState
  gen: torch.Generator
  env_steps: int
  episode_return: torch.Tensor
  completed_returns_sum: torch.Tensor
  completed_episodes: torch.Tensor

  def replace(self, **changes) -> 'SACState':
    return dataclasses.replace(self, **changes)


class SparseSAC:
  """Soft actor-critic with dynamic sparse actor / critic networks."""

  def __init__(self, env: Pendulum, config: Optional[SACConfig] = None,
               hidden: Tuple[int, ...] = (64, 64)):
    self.env = env
    self.device = env.device
    self.config = config or SACConfig()
    cfg = self.config
    obs_dim = env.obs_shape[0]
    self.actor = GaussianActor(env.action_dim, env.max_action, hidden,
                               obs_dim, device=self.device)
    self.critic = TwinCritic(hidden, obs_dim + env.action_dim,
                             device=self.device)
    self.actor_st = common.build_sparse_training(cfg, 'constant', cfg.seed)
    self.critic_st = common.build_sparse_training(cfg, 'constant',
                                                  cfg.seed + 1)
    self.alpha_tx = common.adam(cfg.learning_rate)
    self.target_entropy = -cfg.target_entropy_scale * env.action_dim

  def init(self, seed: int) -> SACState:
    cfg = self.config
    self.actor.reset_parameters(torch.Generator().manual_seed(_seed(seed, 0)))
    self.critic.reset_parameters(
        torch.Generator().manual_seed(_seed(seed, 1)))
    actor_params = masks_lib.param_dict(self.actor)
    critic_params = masks_lib.param_dict(self.critic)
    actor_opt, actor_sparse = self.actor_st.init(_seed(seed, 2), actor_params)
    critic_opt, critic_sparse = self.critic_st.init(_seed(seed, 3),
                                                    critic_params)
    if cfg.premask_params:
      with torch.no_grad():
        for params, sp in ((actor_params, actor_sparse),
                           (critic_params, critic_sparse)):
          for p, m in sp.masks.items():
            params[p].mul_(m.to(params[p].dtype))
    log_alpha = torch.zeros((), device=self.device, requires_grad=True)
    return SACState(
        actor_params=actor_params, critic_params=critic_params,
        target_critic_params=common.clone_dict(critic_params),
        target_critic_masks=common.clone_dict(critic_sparse.masks),
        log_alpha=log_alpha, actor_opt=actor_opt, critic_opt=critic_opt,
        alpha_opt=self.alpha_tx([log_alpha]), actor_sparse=actor_sparse,
        critic_sparse=critic_sparse,
        buffer=replay.create(cfg.buffer_capacity, self.env.obs_shape,
                             action_shape=(self.env.action_dim,),
                             device=self.device),
        env_state=self.env.reset(common.generator(self.device, seed, 4)),
        gen=common.generator(self.device, seed, 5), env_steps=0,
        **common.zero_counters(self.device))

  def _vars(self, params, masks, online: bool = True, grad: bool = False):
    """The effective params: pre-masked storage is used as it is for the
    online networks only; the target critic is always masked."""
    return common.effective(params, masks,
                            online and self.config.premask_params, grad)

  # ------------------------------------------------------------------------
  def _env_step(self, state: SACState, eps=None, env_draws=None) -> SACState:
    """One env step; `eps` (action_dim,) is the policy's normal noise."""
    if eps is None:
      eps = torch.randn(self.env.action_dim, generator=state.gen,
                        device=self.device)
    obs = state.env_state.obs
    with torch.no_grad():
      action, _ = sample(self.actor, self._vars(state.actor_params,
                                                state.actor_sparse.masks),
                         obs[None], eps[None])
    action = action[0]
    next_env, reward, done = self.env.step(state.env_state, action,
                                           env_draws)
    buf = replay.add(state.buffer, obs, action, reward, next_env.obs, done)
    ep, total, count = common.episode_bookkeeping(state, reward, done)
    return state.replace(env_state=next_env, buffer=buf,
                         env_steps=state.env_steps + 1, episode_return=ep,
                         completed_returns_sum=total,
                         completed_episodes=count)

  def draw_learn(self, state: SACState) -> Dict[str, torch.Tensor]:
    """A learn step's draws: replay indices and the two noise tensors."""
    cfg = self.config
    shape = (cfg.batch_size, self.env.action_dim)
    return {'idx': replay.sample_indices(state.buffer, state.gen,
                                         cfg.batch_size),
            'eps_next': torch.randn(shape, generator=state.gen,
                                    device=self.device),
            'eps_pi': torch.randn(shape, generator=state.gen,
                                  device=self.device)}

  def _learn(self, state: SACState, draws=None) -> SACState:
    cfg = self.config
    draws = draws if draws is not None else self.draw_learn(state)
    batch = replay.gather(state.buffer, draws['idx'])
    alpha = torch.exp(state.log_alpha.detach())

    # Critic update: soft Bellman target from the target critic.
    with torch.no_grad():
      next_a, next_logp = sample(
          self.actor, self._vars(state.actor_params, state.actor_sparse.masks),
          batch['next_obs'], draws['eps_next'])
      tq1, tq2 = self.critic.apply_params(
          self._vars(state.target_critic_params, state.target_critic_masks,
                     online=False), batch['next_obs'], next_a)
      target_q = batch['reward'] + cfg.gamma * (
          1.0 - batch['done'].to(torch.float32)) * (
              torch.minimum(tq1, tq2) - alpha * next_logp)

    eff_c = self._vars(state.critic_params, state.critic_sparse.masks,
                       grad=True)
    q1, q2 = self.critic.apply_params(eff_c, batch['obs'], batch['action'])
    c_loss = ((q1 - target_q) ** 2 + (q2 - target_q) ** 2).mean()
    if cfg.weight_decay:
      c_loss = c_loss + cfg.weight_decay * common.l2_half(eff_c)
    critic_params, critic_opt, critic_sparse, _ = self.critic_st.step(
        state.critic_params, state.critic_opt, state.critic_sparse,
        common.grads_of(c_loss, eff_c))

    # Actor update, against the updated critic.
    eff_a = self._vars(state.actor_params, state.actor_sparse.masks,
                       grad=True)
    a, logp = sample(self.actor, eff_a, batch['obs'], draws['eps_pi'])
    q1, q2 = self.critic.apply_params(
        self._vars(critic_params, critic_sparse.masks), batch['obs'], a)
    a_loss = (alpha * logp - torch.minimum(q1, q2)).mean()
    if cfg.weight_decay:
      a_loss = a_loss + cfg.weight_decay * common.l2_half(eff_a)
    actor_params, actor_opt, actor_sparse, _ = self.actor_st.step(
        state.actor_params, state.actor_opt, state.actor_sparse,
        common.grads_of(a_loss, eff_a))

    # Temperature update toward the entropy target.
    log_alpha = state.log_alpha
    al_loss = (-torch.exp(log_alpha)
               * (logp.detach() + self.target_entropy)).mean()
    log_alpha.grad = torch.autograd.grad(al_loss, [log_alpha])[0]
    state.alpha_opt.step()
    log_alpha.grad = None

    # Soft (polyak) target update; masks copied with weights, as in the
    # reference's target sync (dqn_agents.py:459-472 convention).
    tau = cfg.tau
    targets = list(state.target_critic_params.values())
    with torch.no_grad():
      torch._foreach_mul_(targets, 1 - tau)
      torch._foreach_add_(targets, [critic_params[p].detach() for p in
                                    state.target_critic_params], alpha=tau)
    target_masks = state.target_critic_masks
    if critic_sparse.masks is not state.critic_sparse.masks:
      target_masks = common.clone_dict(critic_sparse.masks)
    return state.replace(
        actor_params=actor_params, critic_params=critic_params,
        target_critic_masks=target_masks, actor_opt=actor_opt,
        critic_opt=critic_opt, actor_sparse=actor_sparse,
        critic_sparse=critic_sparse)

  def collect_and_learn(self, state: SACState
                        ) -> Tuple[SACState, Dict[str, Any]]:
    cfg = self.config
    for _ in range(cfg.learn_every):
      state = self._env_step(state)
    if state.buffer.size >= cfg.min_replay:
      state = self._learn(state)
    metrics = {
        'env_steps': state.env_steps,
        'learn_steps': state.critic_sparse.step,
        'avg_return': common.avg_return(state),
        'episodes': state.completed_episodes,
        'alpha': torch.exp(state.log_alpha.detach()),
    }
    return state, metrics

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
    if state.critic_sparse.masks:
      result['global_sparsity'] = float(masks_lib.calculate_sparsity(
          {**state.critic_sparse.masks,
           **{f'a/{k}': v for k, v in state.actor_sparse.masks.items()}}))
    return result
