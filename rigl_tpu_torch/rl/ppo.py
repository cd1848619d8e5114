"""Sparse PPO, in PyTorch.

Counterpart of rigl_tpu/rl/ppo.py (capability parity with
rigl/rl/tfagents/ppo_train_eval.py: sparse actor / value networks, mask
updaters driven inside the train step, :289-330, clipped-surrogate PPO
with GAE).  One iteration: a rollout of `rollout_length` env steps
(actions by the Gumbel-max trick, jax.random.categorical's rule), GAE by
a reverse loop, then `num_epochs` x `num_minibatches` clipped-objective
steps over a permutation, each through SparseTraining's Adam.

As in rl/dqn.py: eager on the env's device, host counters, returns on
the device, torch generators for JAX's keys, and the step-level
functions take their draws (`gumbels`, `perms`) as arguments.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from rigl_tpu_torch.models.packed_convnet import Dense
from rigl_tpu_torch.rl import dqn as common
from rigl_tpu_torch.rl.envs import CartPole, EnvState
from rigl_tpu_torch.rl.networks import _Net, dense, reset_parameters
from rigl_tpu_torch.sparsity import masks as masks_lib
from rigl_tpu_torch.transforms.sparse_training import SparseState, _seed


class ActorCritic(_Net):
  """Separate policy / value MLP towers (tf-agents actor + value
  networks), tanh activations."""

  def __init__(self, num_actions: int, hidden: Sequence[int] = (64, 64),
               obs_shape: Tuple[int, ...] = (4,),
               generator: Optional[torch.Generator] = None, device='cuda'):
    super().__init__()
    self.hidden = tuple(hidden)
    n_in = 1
    for s in obs_shape:
      n_in *= s
    widths = (n_in,) + self.hidden
    kw = dict(generator=generator, device=device)
    for tower in ('actor', 'value'):
      for i, h in enumerate(self.hidden):
        self.add_module(f'{tower}{i + 1}', Dense(widths[i], h, **kw))
    self.actor_head = Dense(widths[-1], num_actions, **kw)
    self.value_head = Dense(widths[-1], 1, **kw)
    reset_parameters(self, generator)

  def apply_params(self, params, x):
    x = x.reshape(x.shape[0], -1)
    a = x
    for i in range(len(self.hidden)):
      a = torch.tanh(dense(params, f'actor{i + 1}', a))
    logits = dense(params, 'actor_head', a)
    v = x
    for i in range(len(self.hidden)):
      v = torch.tanh(dense(params, f'value{i + 1}', v))
    return logits, dense(params, 'value_head', v)[:, 0]


@dataclasses.dataclass
class PPOConfig:
  training_method: str = 'rigl'
  sparsity: float = 0.8
  mask_init_method: str = 'erdos_renyi_kernel'
  maskupdate_frequency: int = 20      # in PPO update steps
  maskupdate_begin_step: int = 10
  maskupdate_end_step: int = -1
  drop_fraction: float = 0.3
  learning_rate: float = 3e-4
  rollout_length: int = 256
  num_epochs: int = 4
  num_minibatches: int = 4
  gamma: float = 0.99
  gae_lambda: float = 0.95
  clip_eps: float = 0.2
  value_coef: float = 0.5
  entropy_coef: float = 0.01
  # L2 on actor / critic weights, added to the clipped objective
  # (tfagents ppo_train_eval.py weight_decay / kernel_regularizer parity).
  weight_decay: float = 0.0
  seed: int = 0
  # Pre-masked parameter storage (transforms/sparse_training.py): skips
  # the mask multiply in rollout forwards and minibatch steps.
  premask_params: bool = False


@dataclasses.dataclass
class PPOTrainState:
  params: Dict[str, torch.Tensor]
  optimizer: torch.optim.Optimizer
  sparse: SparseState
  env_state: EnvState
  gen: torch.Generator
  env_steps: int
  episode_return: torch.Tensor
  completed_returns_sum: torch.Tensor
  completed_episodes: torch.Tensor

  def replace(self, **changes) -> 'PPOTrainState':
    return dataclasses.replace(self, **changes)


class SparsePPO:
  def __init__(self, env: CartPole, config: Optional[PPOConfig] = None,
               hidden: Tuple[int, ...] = (64, 64)):
    self.env = env
    self.device = env.device
    self.config = config or PPOConfig()
    cfg = self.config
    self.net = ActorCritic(env.num_actions, hidden, env.obs_shape,
                           device=self.device)
    self.st = common.build_sparse_training(cfg, 'constant', cfg.seed)
    self.algo = self.st.algo

  def init(self, seed: int) -> PPOTrainState:
    cfg = self.config
    self.net.reset_parameters(torch.Generator().manual_seed(_seed(seed, 0)))
    params = masks_lib.param_dict(self.net)
    optimizer, sstate = self.st.init(_seed(seed, 1), params)
    if cfg.premask_params:
      with torch.no_grad():
        for p, m in sstate.masks.items():
          params[p].mul_(m.to(params[p].dtype))
    return PPOTrainState(
        params=params, optimizer=optimizer, sparse=sstate,
        env_state=self.env.reset(common.generator(self.device, seed, 2)),
        gen=common.generator(self.device, seed, 3), env_steps=0,
        **common.zero_counters(self.device))

  # ---------------------------------------------------------------- rollout
  def _rollout(self, state: PPOTrainState, gumbels=None, env_draws=None):
    """`rollout_length` env steps; returns (state, traj, last_value).
    `gumbels` (rollout_length, num_actions): the Gumbel noise of each
    step's categorical draw; `env_draws`: a list of each step's env draws
    (both drawn from the generators when None)."""
    cfg = self.config
    n, na, dev = cfg.rollout_length, self.env.num_actions, self.device
    traj = {'obs': torch.zeros((n,) + tuple(self.env.obs_shape), device=dev),
            'action': torch.zeros(n, dtype=torch.int64, device=dev),
            'logp': torch.zeros(n, device=dev),
            'value': torch.zeros(n, device=dev),
            'reward': torch.zeros(n, device=dev),
            'done': torch.zeros(n, dtype=torch.bool, device=dev)}
    if gumbels is None:
      u = torch.rand((n, na), generator=state.gen, device=dev)
      u = torch.clamp(u, min=torch.finfo(u.dtype).tiny)
      gumbels = -torch.log(-torch.log(u))
    with torch.no_grad():
      eff = common.effective(state.params, state.sparse.masks,
                             cfg.premask_params)
      for i in range(n):
        obs = state.env_state.obs
        logits, value = self.net.apply_params(eff, obs[None])
        logits, value = logits[0], value[0]
        action = torch.argmax(logits + gumbels[i])
        logp = torch.log_softmax(logits, -1).gather(0, action[None])[0]
        next_env, reward, done = self.env.step(
            state.env_state, action,
            None if env_draws is None else env_draws[i])
        ep, total, count = common.episode_bookkeeping(state, reward, done)
        state = state.replace(env_state=next_env,
                              env_steps=state.env_steps + 1,
                              episode_return=ep, completed_returns_sum=total,
                              completed_episodes=count)
        for key, v in (('obs', obs), ('action', action), ('logp', logp),
                       ('value', value), ('reward', reward), ('done', done)):
          traj[key][i] = v
      _, last_value = self.net.apply_params(eff, state.env_state.obs[None])
    return state, traj, last_value[0]

  def _gae(self, traj, last_value):
    """Advantages by a reverse loop over the rollout; returns
    (advantages, returns)."""
    cfg = self.config
    n = traj['reward'].shape[0]
    advantages = torch.zeros_like(traj['reward'])
    gae = torch.zeros((), device=advantages.device)
    next_value = last_value
    for t in reversed(range(n)):
      nonterminal = 1.0 - traj['done'][t].to(torch.float32)
      delta = (traj['reward'][t] + cfg.gamma * next_value * nonterminal
               - traj['value'][t])
      gae = delta + cfg.gamma * cfg.gae_lambda * nonterminal * gae
      advantages[t] = gae
      next_value = traj['value'][t]
    return advantages, advantages + traj['value']

  # ----------------------------------------------------------------- update
  def _loss(self, eff_params, batch):
    cfg = self.config
    logits, value = self.net.apply_params(eff_params, batch['obs'])
    logp_all = torch.log_softmax(logits, -1)
    logp = logp_all.gather(1, batch['action'].to(torch.int64)[:, None])[:, 0]
    ratio = torch.exp(logp - batch['logp'])
    adv = batch['adv']
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    pg = -torch.minimum(
        ratio * adv,
        torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv).mean()
    v_loss = torch.mean((value - batch['ret']) ** 2)
    entropy = -torch.sum(torch.exp(logp_all) * logp_all, dim=-1).mean()
    loss = pg + cfg.value_coef * v_loss - cfg.entropy_coef * entropy
    if cfg.weight_decay:
      loss = loss + cfg.weight_decay * common.l2_half(eff_params)
    return loss

  def _update(self, state: PPOTrainState, data, perms=None
              ) -> PPOTrainState:
    """`num_epochs` passes of `num_minibatches` steps over `data`; epoch
    e's minibatches are slices of perms[e] (a permutation drawn from the
    state's generator when None)."""
    cfg = self.config
    n = cfg.rollout_length
    mb = n // cfg.num_minibatches
    params, optimizer, sstate = state.params, state.optimizer, state.sparse
    for e in range(cfg.num_epochs):
      perm = (perms[e] if perms is not None else
              torch.randperm(n, generator=state.gen, device=self.device))
      for j in range(cfg.num_minibatches):
        idx = perm[j * mb:(j + 1) * mb]
        batch = {k: v[idx] for k, v in data.items()}
        eff = common.effective(params, sstate.masks, cfg.premask_params,
                               grad=True)
        grads = common.grads_of(self._loss(eff, batch), eff)
        params, optimizer, sstate, _ = self.st.step(params, optimizer,
                                                    sstate, grads)
    return state.replace(params=params, optimizer=optimizer, sparse=sstate)

  def train_iteration(self, state: PPOTrainState, gumbels=None,
                      perms=None) -> Tuple[PPOTrainState, Dict[str, Any]]:
    state, traj, last_value = self._rollout(state, gumbels)
    adv, ret = self._gae(traj, last_value)
    data = {'obs': traj['obs'], 'action': traj['action'],
            'logp': traj['logp'], 'adv': adv, 'ret': ret}
    state = self._update(state, data, perms)
    metrics = {
        'env_steps': state.env_steps,
        'update_steps': state.sparse.step,
        'avg_return': common.avg_return(state),
        'episodes': state.completed_episodes,
    }
    return state, metrics

  def train(self, total_env_steps: int, progress_fn=None) -> Dict[str, Any]:
    state = self.init(self.config.seed)
    n_iters = total_env_steps // self.config.rollout_length
    metrics = {}
    for _ in range(n_iters):
      state, metrics = self.train_iteration(state)
      if progress_fn:
        progress_fn({k: float(v) for k, v in metrics.items()})
    self.state = state
    result = {k: float(v) for k, v in metrics.items()}
    if state.sparse.masks:
      result['global_sparsity'] = float(
          masks_lib.calculate_sparsity(state.sparse.masks))
    return result
