"""Sparse RL driver, in PyTorch: DQN, PPO or SAC with any sparse training
method on the device-resident envs (CartPole for MLP nets, MinAtar-style
Breakout for the conv Nature-DQN / Impala nets, Pendulum for SAC's
continuous control).

Counterpart of rigl_tpu/drivers/rl.py (parity with rigl/rl/train.py and
the tfagents entry points), its absl flags on argparse with the same
names and defaults, plus --device (default cuda).  Presets in
configs/rl_*.json mirror the reference's 19 gin files, with the env
substitutions documented in each file's "_substitutions" key; flags given
on the command line override the preset.

  python -m rigl_tpu_torch.drivers.rl --config=configs/rl_dqn_atari_rigl.json
  python -m rigl_tpu_torch.drivers.rl --agent=dqn --training_method=rigl \\
      --end_sparsity=0.9 --total_env_steps=20000
  python -m rigl_tpu_torch.drivers.rl --agent=sac --env=pendulum \\
      --training_method=rigl --end_sparsity=0.8
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

# Driver option keys a preset may set (everything in run()'s signature).
_OPTION_KEYS = ('agent', 'env', 'network', 'width', 'training_method',
                'end_sparsity', 'mask_init_method', 'total_env_steps',
                'maskupdate_frequency', 'maskupdate_begin_step',
                'maskupdate_end_step', 'drop_fraction', 'learning_rate',
                'weight_decay', 'seed', 'log_every')


def build_parser(suppress_defaults: bool = False) -> argparse.ArgumentParser:
  """The driver's flags; with `suppress_defaults`, a namespace holds only
  the flags given on the command line."""
  p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])

  def add(name, default, type_=str, help_=''):
    p.add_argument(f'--{name}', type=type_,
                   default=argparse.SUPPRESS if suppress_defaults else default,
                   help=help_)

  add('device', 'cuda', help_='torch device')
  add('config', None, help_='path to an rl_*.json preset (configs/); keys '
      'mirror these flags, plus "agent_kwargs" passed through to the agent '
      'config dataclass.  Keys starting with "_" are documentation.  '
      'Explicit CLI flags override the preset.')
  add('agent', 'dqn', help_='dqn | ppo | sac')
  add('env', 'cartpole', help_='cartpole | breakout | freeway | asterix | '
      'space_invaders | pendulum')
  add('network', 'auto', help_='auto | mlp | nature | impala (conv nets '
      'need an image env, i.e. breakout)')
  add('width', 1.0, float, 'network width multiplier (dqn_agents.py:211-306)')
  add('training_method', 'rigl',
      help_='rigl|set|static|momentum|prune|snip|dnw|none')
  add('end_sparsity', 0.9, float)
  add('mask_init_method', 'erdos_renyi_kernel')
  add('total_env_steps', 20000, int)
  add('maskupdate_frequency', 500, int, 'in learn steps')
  add('maskupdate_begin_step', 200, int)
  add('maskupdate_end_step', -1, int, 'in learn steps; -1 forever')
  add('drop_fraction', 0.3, float)
  add('learning_rate', 1e-3, float)
  add('weight_decay', 0.0, float,
      'L2 added to the loss (dqn_agents.py:391-394)')
  add('seed', 0, int)
  add('log_every', 1000, int)
  add('output_dir', None)
  return p


def load_preset(path: str):
  """Reads an rl_*.json preset -> (driver options, agent kwargs)."""
  with open(path) as f:
    raw = {k: v for k, v in json.load(f).items() if not k.startswith('_')}
  agent_kwargs = raw.pop('agent_kwargs', {})
  unknown = set(raw) - set(_OPTION_KEYS)
  if unknown:
    raise ValueError(f'unknown preset keys {sorted(unknown)} in {path}')
  return raw, agent_kwargs


def run(agent='dqn', env='cartpole', network='auto', width=1.0,
        training_method='rigl', end_sparsity=0.9,
        mask_init_method='erdos_renyi_kernel', total_env_steps=20000,
        maskupdate_frequency=500, maskupdate_begin_step=200,
        maskupdate_end_step=-1, drop_fraction=0.3, learning_rate=1e-3,
        weight_decay=0.0, seed=0, log_every=1000, agent_kwargs=None,
        progress_fn=print, device='cuda'):
  """Builds the requested agent on `device` and trains it; returns the
  result dict."""
  from rigl_tpu_torch.rl import envs
  from rigl_tpu_torch.rl.networks import ImpalaNet, MLPQNetwork, NatureDQN
  env_obj = envs.ENVS[env](device=device)
  method = 'none' if training_method in ('none', 'dense') else training_method

  common = dict(
      training_method=method,
      sparsity=end_sparsity,
      mask_init_method=mask_init_method,
      maskupdate_frequency=maskupdate_frequency,
      maskupdate_begin_step=maskupdate_begin_step,
      maskupdate_end_step=maskupdate_end_step,
      drop_fraction=drop_fraction,
      learning_rate=learning_rate,
      weight_decay=weight_decay,
      seed=seed)
  common.update(agent_kwargs or {})

  if agent == 'sac':
    # SAC builds its own actor / twin-critic towers (rl/sac.py, mirroring
    # the tfagents sac_train_eval.py wiring); continuous control only.
    from rigl_tpu_torch.rl.sac import SACConfig, SparseSAC
    if env != 'pendulum':
      raise ValueError('SAC needs a continuous-action env (pendulum)')
    sac_agent = SparseSAC(env_obj, SACConfig(**common))
    return sac_agent.train(total_env_steps, log_every=log_every,
                           progress_fn=progress_fn)

  net_kind = network
  if net_kind == 'auto':
    image_envs = ('breakout', 'freeway', 'asterix', 'space_invaders')
    net_kind = 'nature' if env in image_envs and agent == 'dqn' else 'mlp'
  if agent == 'ppo' and net_kind != 'mlp':
    raise ValueError('PPO uses the MLP actor-critic towers '
                     '(rl/ppo.py); conv networks are DQN-only')
  kw = dict(obs_shape=env_obj.obs_shape, device=device)
  if net_kind == 'mlp':
    net = MLPQNetwork(env_obj.num_actions, **kw)
  elif net_kind == 'nature':
    net = NatureDQN(num_actions=env_obj.num_actions, width=width, **kw)
  elif net_kind == 'impala':
    net = ImpalaNet(num_actions=env_obj.num_actions, width=width, **kw)
  else:
    raise ValueError(f'unknown network {net_kind!r}')

  if agent == 'dqn':
    from rigl_tpu_torch.rl import DQNConfig, SparseDQN
    dqn_agent = SparseDQN(net, env_obj, DQNConfig(**common))
    return dqn_agent.train(total_env_steps, log_every=log_every,
                           progress_fn=progress_fn)
  if agent == 'ppo':
    from rigl_tpu_torch.rl.ppo import PPOConfig, SparsePPO
    ppo_agent = SparsePPO(env_obj, PPOConfig(**common))
    return ppo_agent.train(total_env_steps, progress_fn=progress_fn)
  raise ValueError(f'unknown agent {agent!r}')


def parse_options(argv: Optional[Sequence[str]] = None):
  """(options for run(), agent kwargs, device, output_dir) of a command
  line: the preset's values where the flag was not given."""
  args = build_parser().parse_args(argv)
  given = vars(build_parser(suppress_defaults=True).parse_args(argv))
  agent_kwargs = {}
  if args.config:
    preset, agent_kwargs = load_preset(args.config)
    for key, value in preset.items():
      if key not in given:
        setattr(args, key, value)
  opts = {k: getattr(args, k) for k in _OPTION_KEYS}
  return opts, agent_kwargs, args.device, args.output_dir


def main(argv: Optional[Sequence[str]] = None):
  opts, agent_kwargs, device, output_dir = parse_options(argv)
  result = run(agent_kwargs=agent_kwargs, device=device, **opts)
  print(json.dumps(result, indent=2))
  if output_dir:
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, 'results.json'), 'w') as f:
      json.dump(result, f, indent=2)
  return result


if __name__ == '__main__':
  main()
