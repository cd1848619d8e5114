"""The port's RL driver (rigl_tpu_torch/drivers/rl.py) on the CPU: the
twin of tests/test_rl_presets.py.

* The 19 presets (10 Atari sparsetrain + 9 tfagents gym / mujoco gin
  files) load into the same options and agent kwargs in both packages,
  and the agent kwargs are fields of the port's config dataclasses.
* Every preset -- not only the five JAX trains -- runs through
  drivers.rl.run at the smoke scale JAX's test uses (300 env steps, the
  schedule and replay shrunk, Impala at width 0.25): the average return
  is finite and the global sparsity near the preset's (not for dense or
  gradual pruning).
* The parser has JAX's flags and defaults (run()'s signature), and a
  flag given on the command line overrides the preset.
"""

import glob
import inspect
import json
import os

import numpy as np
import pytest

from rigl_tpu.drivers import rl as jdriver
from rigl_tpu_torch.drivers import rl as tdriver
from torch_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESETS = sorted(glob.glob(os.path.join(REPO, 'configs', 'rl_*.json')))


def test_preset_inventory_matches_reference():
  names = {os.path.basename(p) for p in PRESETS}
  assert len(names) == 19, sorted(names)
  assert sum(n.startswith('rl_dqn_atari') for n in names) == 10
  for agent in ('dqn_gym', 'ppo_mujoco', 'sac_mujoco'):
    assert sum(n.startswith(f'rl_{agent}') for n in names) == 3, agent


def _smoke(preset, agent_kwargs):
  """JAX's test shrink (tests/test_rl_presets.py)."""
  preset = dict(preset, total_env_steps=300, log_every=10 ** 9)
  preset['maskupdate_frequency'] = min(preset.get('maskupdate_frequency',
                                                  500), 20)
  preset['maskupdate_begin_step'] = min(preset.get('maskupdate_begin_step',
                                                   200), 10)
  if preset.get('maskupdate_end_step', -1) > 0:
    preset['maskupdate_end_step'] = 100
  agent_kwargs = dict(agent_kwargs, buffer_capacity=512, min_replay=64,
                      batch_size=32)
  if preset['agent'] == 'ppo':
    agent_kwargs = {'rollout_length': 64, 'num_minibatches': 2,
                    'num_epochs': 2}
  if preset['agent'] == 'dqn' and preset.get('network') == 'impala':
    preset['width'] = 0.25
  return preset, agent_kwargs


@pytest.mark.parametrize('path', PRESETS,
                         ids=[os.path.basename(p) for p in PRESETS])
def test_preset_loads_and_runs(path):
  preset, agent_kwargs = tdriver.load_preset(path)
  assert (preset, agent_kwargs) == jdriver.load_preset(path)
  raw = json.load(open(path))
  assert raw.get('_reference') and raw.get('_substitutions')
  preset, agent_kwargs = _smoke(preset, agent_kwargs)
  result = tdriver.run(agent_kwargs=agent_kwargs, progress_fn=None,
                       device='cpu', **preset)
  # PPO runs whole rollouts of 64; the DQN presets learn every 4.
  assert result['env_steps'] == (256 if preset['agent'] == 'ppo' else 300)
  assert np.isfinite(result['avg_return'])
  if preset['training_method'] not in ('none', 'prune'):
    assert result['global_sparsity'] == pytest.approx(
        preset['end_sparsity'], abs=0.12)


def test_flags_match_jax_run_signature():
  jsig = inspect.signature(jdriver.run).parameters
  tsig = inspect.signature(tdriver.run).parameters
  assert {k: v.default for k, v in jsig.items()} == {
      k: v.default for k, v in tsig.items() if k != 'device'}
  args = vars(tdriver.build_parser().parse_args([]))
  for key in tdriver._OPTION_KEYS:
    assert args[key] == jsig[key].default, key
  assert tdriver._OPTION_KEYS == jdriver._OPTION_KEYS
  assert args['device'] == 'cuda' and args['config'] is None


def test_cli_flag_overrides_preset():
  path = os.path.join(REPO, 'configs', 'rl_dqn_atari_rigl.json')
  opts, kwargs, device, out = tdriver.parse_options(
      [f'--config={path}', '--total_env_steps=8', '--device=cpu',
       '--output_dir=/tmp/x'])
  preset, agent_kwargs = tdriver.load_preset(path)
  assert opts['total_env_steps'] == 8
  assert opts['maskupdate_frequency'] == preset['maskupdate_frequency']
  assert opts['network'] == 'nature' and opts['width'] == 1.0
  assert kwargs == agent_kwargs and device == 'cpu' and out == '/tmp/x'
  # A flag given on the command line wins over the preset even at its
  # default value.
  opts, _, _, _ = tdriver.parse_options([f'--config={path}',
                                         '--learning_rate=0.001'])
  assert opts['learning_rate'] == 0.001
  assert opts['total_env_steps'] == preset['total_env_steps']


def test_main_writes_results(tmp_path):
  result = tdriver.main(['--device=cpu', '--agent=dqn', '--env=cartpole',
                         '--total_env_steps=40', '--log_every=0',
                         f'--output_dir={tmp_path}'])
  with open(tmp_path / 'results.json') as f:
    assert json.load(f) == result
  assert result['env_steps'] == 40
