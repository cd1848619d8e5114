"""The port's RL envs (rigl_tpu_torch/rl/envs.py) against the JAX
package's, on the CPU.

* Trajectories: each env runs in JAX from a seeded key with JAX-drawn
  actions (one jitted scan an env, shared by the module), recording each
  step's state, action, the draws JAX's keys make inside the step and the
  result.  The port's `transition` takes JAX's state, action and draws:
  the grid envs (Breakout, Freeway, Asterix, SpaceInvaders: integer
  dynamics in float32 channels) must give the next obs, t, reward and
  done bit for bit on every step, and also when run free from JAX's reset
  obs on JAX's draws alone.  CartPole and Pendulum go through cos / sin /
  atan2, which XLA and torch round differently in the last place, so each
  is compared one step from JAX's state, never over a rollout: obs within
  CONT_TOL of max(1, |obs|), done and t equal.  The trajectories are
  long enough that every env auto-resets in them.
* The twins of tests/test_envs_minatar.py's non-slow cases and of
  tests/test_rl.py's Breakout, Pendulum and CartPole cases, on the port.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rigl_tpu.rl import envs as jenvs
from rigl_tpu_torch.rl import envs as tenvs
from torch_threads import one_thread  # noqa: F401

GRID = ['Breakout', 'Freeway', 'Asterix', 'SpaceInvaders']
CONTINUOUS = ['CartPole', 'Pendulum']
# Steps a trajectory: each env's episodes end inside them (Freeway and
# Pendulum only at max_steps, 500 and 200).
STEPS = {'Breakout': 300, 'Freeway': 520, 'Asterix': 300,
         'SpaceInvaders': 400, 'CartPole': 300, 'Pendulum': 420}
# One step of CartPole / Pendulum from the same state: XLA's and torch's
# cos / sin / atan2 differ by an ulp or two, which a step's products and
# the 8.0 speed clip carry to a few ulps of the state's largest entry.
CONT_TOL = 1e-5


def _jax_draws(name, key):
  """The draws JAX's step makes from the state key `key`, by the port's
  names."""
  split, ri = jax.random.split, jax.random.randint
  if name == 'Breakout':
    _, sub = split(key)
    k1, k2 = split(sub)
    return {'reset_col': ri(k1, (), 0, 10),
            'reset_right': jax.random.bernoulli(k2)}
  if name == 'Freeway':
    _, sub = split(key)
    return {'reset_cols': ri(sub, (8,), 0, 10)}
  if name == 'Asterix':
    key, k_gold = split(key)
    _, sub = split(key)
    k1, k2 = split(sub)
    return {'fresh': jax.random.bernoulli(k_gold, 0.5, (8,)),
            'reset_cols': ri(k1, (8,), 0, 10),
            'reset_golds': jax.random.bernoulli(k2, 0.5, (8,))}
  if name == 'SpaceInvaders':
    key, _ = split(key)
    _, sub = split(key)
    return {'reset_col': ri(sub, (), 0, 10)}
  if name == 'Pendulum':
    _, sub = split(key)
    k1, k2 = split(sub)
    return {'reset_theta': jax.random.uniform(k1, (), minval=-jnp.pi,
                                              maxval=jnp.pi),
            'reset_dot': jax.random.uniform(k2, (), minval=-1.0, maxval=1.0)}
  _, sub = split(key)
  return {'reset_obs': jax.random.uniform(sub, (4,), minval=-0.05,
                                          maxval=0.05)}


def _jax_actions(env, key, n):
  if hasattr(env, 'num_actions'):
    return jax.random.randint(key, (n,), 0, env.num_actions)
  return jax.random.uniform(key, (n, 1), minval=-2.5, maxval=2.5)


@pytest.fixture(scope='module')
def trajectories():
  """{env name: numpy arrays of a JAX trajectory}, computed on first
  use."""
  cache = {}

  def get(name):
    if name not in cache:
      env = getattr(jenvs, name)()
      n = STEPS[name]
      s0 = env.reset(jax.random.key(7))
      actions = _jax_actions(env, jax.random.key(11), n)

      def body(s, a):
        draws = _jax_draws(name, s.key)
        s2, r, d = env.step(s, a)
        return s2, dict(obs=s.obs, t=s.t, action=a, draws=draws,
                        next_obs=s2.obs, next_t=s2.t, reward=r, done=d)

      _, rec = jax.jit(lambda s: jax.lax.scan(body, s, actions))(s0)
      cache[name] = jax.tree.map(np.array, rec)
    return cache[name]

  return get


def _draws_at(rec, i):
  return {k: torch.as_tensor(np.asarray(v[i]))
          for k, v in rec['draws'].items()}


@pytest.mark.parametrize('name', GRID)
def test_grid_env_transition_bitwise(trajectories, name):
  rec = trajectories(name)
  env = getattr(tenvs, name)(device='cpu')
  assert rec['done'].any(), f'{name}: no episode ended in the trajectory'
  for i in range(len(rec['t'])):
    obs, t, r, d = env.transition(
        torch.as_tensor(rec['obs'][i]), torch.as_tensor(rec['t'][i]),
        torch.as_tensor(rec['action'][i]), _draws_at(rec, i))
    np.testing.assert_array_equal(obs.numpy(), rec['next_obs'][i],
                                  err_msg=f'{name} step {i}')
    assert int(t) == int(rec['next_t'][i]), (name, i)
    assert float(r) == float(rec['reward'][i]), (name, i)
    assert bool(d) == bool(rec['done'][i]), (name, i)
    assert t.dtype == torch.int32 and d.dtype == torch.bool


@pytest.mark.parametrize('name', GRID)
def test_grid_env_free_run_bitwise(trajectories, name):
  """From JAX's first obs, on JAX's actions and draws alone, the port's
  own states reproduce the whole trajectory."""
  rec = trajectories(name)
  env = getattr(tenvs, name)(device='cpu')
  state = tenvs.EnvState(obs=torch.as_tensor(rec['obs'][0]),
                         done=torch.zeros((), dtype=torch.bool),
                         t=torch.as_tensor(rec['t'][0]),
                         gen=torch.Generator())
  rewards = []
  for i in range(len(rec['t'])):
    state, r, d = env.step(state, torch.as_tensor(rec['action'][i]),
                           _draws_at(rec, i))
    np.testing.assert_array_equal(state.obs.numpy(), rec['next_obs'][i],
                                  err_msg=f'{name} step {i}')
    assert bool(d) == bool(rec['done'][i])
    rewards.append(float(r))
  np.testing.assert_array_equal(rewards, rec['reward'])


@pytest.mark.parametrize('name', CONTINUOUS)
def test_continuous_env_one_step(trajectories, name):
  rec = trajectories(name)
  env = getattr(tenvs, name)(device='cpu')
  assert rec['done'].any(), f'{name}: no episode ended in the trajectory'
  worst = 0.0
  for i in range(len(rec['t'])):
    obs, t, r, d = env.transition(
        torch.as_tensor(rec['obs'][i]), torch.as_tensor(rec['t'][i]),
        torch.as_tensor(rec['action'][i]), _draws_at(rec, i))
    want = rec['next_obs'][i]
    scale = max(1.0, float(np.abs(want).max()))
    worst = max(worst, float(np.abs(obs.numpy() - want).max()) / scale)
    assert abs(float(r) - float(rec['reward'][i])) <= CONT_TOL * max(
        1.0, abs(float(rec['reward'][i]))), (name, i)
    assert bool(d) == bool(rec['done'][i]), (name, i)
    assert int(t) == int(rec['next_t'][i]), (name, i)
  assert worst <= CONT_TOL, (name, worst)


def test_reset_draws_match_jax_layout():
  """reset() draws from its generator into the obs shape and dtypes JAX
  gives, with done False and t 0."""
  for name in GRID + CONTINUOUS:
    jenv, tenv = getattr(jenvs, name)(), getattr(tenvs, name)(device='cpu')
    js = jenv.reset(jax.random.key(0))
    ts = tenv.reset(torch.Generator().manual_seed(0))
    assert tuple(ts.obs.shape) == tuple(js.obs.shape) == tenv.obs_shape
    assert ts.obs.dtype == torch.float32
    assert not bool(ts.done) and int(ts.t) == 0


# ------------------------------------------- twins of the env test files --
def _clone(state):
  gen = torch.Generator()
  gen.set_state(state.gen.get_state())
  return tenvs.EnvState(obs=state.obs.clone(), done=state.done.clone(),
                        t=state.t.clone(), gen=gen)


def _gen(seed):
  return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize('name', ['Freeway', 'Asterix', 'SpaceInvaders'])
def test_env_scan_smoke(name):
  """A random-policy rollout of 200 steps keeps a valid observation."""
  env = getattr(tenvs, name)(device='cpu')
  state = env.reset(_gen(0))
  assert tuple(state.obs.shape) == env.obs_shape
  actions = torch.randint(0, env.num_actions, (200,), generator=_gen(1))
  rewards = []
  for a in actions:
    state, r, _ = env.step(state, a)
    rewards.append(float(r))
  assert np.all(np.isfinite(rewards))
  assert tuple(state.obs.shape) == env.obs_shape
  assert bool((state.obs >= 0).all()) and bool((state.obs <= 1).all())


@pytest.mark.parametrize('name', ['Freeway', 'Asterix', 'SpaceInvaders'])
def test_observation_is_markov(name):
  env = getattr(tenvs, name)(device='cpu')
  s = env.reset(_gen(2))
  for i in range(7):
    s, _, _ = env.step(s, torch.tensor(i % env.num_actions))
  clone = _clone(s)
  s1, r1, _ = env.step(s, torch.tensor(1))
  s2, r2, _ = env.step(clone, torch.tensor(1))
  np.testing.assert_array_equal(s1.obs.numpy(), s2.obs.numpy())
  assert float(r1) == float(r2)


def test_freeway_up_policy_scores():
  env = tenvs.Freeway(device='cpu')
  s = env.reset(_gen(0))
  total = 0.0
  for _ in range(200):
    s, r, d = env.step(s, torch.tensor(1))
    total += float(r)
    assert not bool(d) or int(s.t) == 0  # done only via max_steps
  assert total >= 1.0, 'always-up must cross at least once in 200 steps'


def test_asterix_enemy_ends_episode():
  env = tenvs.Asterix(device='cpu')
  s = env.reset(_gen(0))
  rng = np.random.default_rng(0)
  saw_done = False
  for _ in range(600):
    s, r, d = env.step(s, torch.tensor(int(rng.integers(0, env.num_actions))))
    if bool(d) and int(s.t) == 0:
      saw_done = True
      break
  assert saw_done, 'random walk must eventually touch an enemy'


def test_space_invaders_shooting_scores():
  env = tenvs.SpaceInvaders(device='cpu')
  s = env.reset(_gen(1))
  total = 0.0
  for _ in range(120):
    s, r, d = env.step(s, torch.tensor(3))
    total += float(r)
    if bool(d):
      break
  assert total >= 1.0, 'firing from under the block must hit aliens'


def test_space_invaders_alien_landing_or_bullet_ends():
  env = tenvs.SpaceInvaders(device='cpu')
  s = env.reset(_gen(0))
  for _ in range(400):
    s, r, d = env.step(s, torch.tensor(0))  # never fire, never move
    if bool(d):
      assert int(s.t) == 0
      return
  pytest.fail('noop policy must die to a bullet or landing aliens')


def test_cartpole_reset_and_step():
  env = tenvs.CartPole(device='cpu')
  s = env.reset(_gen(0))
  assert tuple(s.obs.shape) == (4,)
  assert float(s.obs.abs().max()) <= 0.05
  s2, r, d = env.step(s, torch.tensor(1))
  assert float(r) == 1.0
  assert not bool(d)
  assert tuple(s2.obs.shape) == (4,)


def test_cartpole_terminates_and_resets():
  env = tenvs.CartPole(device='cpu')
  s = env.reset(_gen(0))
  done_seen = False
  for _ in range(200):
    s, r, d = env.step(s, torch.tensor(1))
    if bool(d):
      done_seen = True
      assert float(s.obs.abs().max()) <= 0.05
      break
  assert done_seen


def test_cartpole_rollout_rewards():
  """The twin of test_cartpole_jit_scan: 50 steps of action 0 from a
  reset collect 50 rewards of 1."""
  env = tenvs.CartPole(device='cpu')
  s = env.reset(_gen(1))
  total = 0.0
  for _ in range(50):
    s, r, _ = env.step(s, torch.tensor(0))
    total += float(r)
  assert total == 50.0


def test_pendulum_env():
  env = tenvs.Pendulum(device='cpu')
  s = env.reset(_gen(0))
  assert tuple(s.obs.shape) == (3,)
  assert float(s.obs[0] ** 2 + s.obs[1] ** 2) == pytest.approx(1.0, abs=1e-5)
  assert -math.pi <= math.atan2(float(s.obs[1]), float(s.obs[0])) <= math.pi
  s2, r, d = env.step(s, torch.tensor([1.0]))
  assert float(r) <= 0.0
  assert not bool(d)
  for _ in range(env.max_steps - 1):
    s2, r, d = env.step(s2, torch.tensor([0.0]))
  assert bool(d)


def test_breakout_dynamics():
  env = tenvs.Breakout(device='cpu')
  state = env.reset(_gen(0))
  assert tuple(state.obs.shape) == (10, 10, 4)
  assert float(state.obs[..., 0].sum()) == 1.0
  assert float(state.obs[..., 1].sum()) == 1.0
  assert float(state.obs[..., 3].sum()) == 30.0
  total_reward = 0.0
  s = state
  for _ in range(300):
    obs = s.obs.numpy()
    ball_r, ball_col = np.unravel_index(obs[..., 1].argmax(), (10, 10))
    k = int(round(float(obs[..., 2].max()) * 4))
    dx = 1 if k % 2 == 0 else -1
    target = int(np.clip(ball_col + dx, 0, 9)) if ball_r >= 6 else ball_col
    pad_col = int(np.argmax(obs[9, :, 0]))
    action = 0 if target == pad_col else (2 if target > pad_col else 1)
    s, r, d = env.step(s, torch.tensor(action))
    total_reward += float(r)
  assert total_reward > 0, 'tracking policy must hit bricks'
  s = env.reset(_gen(3))
  saw_done = False
  for _ in range(100):
    s, r, d = env.step(s, torch.tensor(0))
    if bool(d):
      saw_done = True
      assert float(s.obs[..., 3].sum()) == 30.0
      break
  assert saw_done


def test_breakout_observation_is_markov():
  env = tenvs.Breakout(device='cpu')
  s = env.reset(_gen(1))
  for _ in range(5):
    s, _, _ = env.step(s, torch.tensor(0))
  clone = _clone(s)
  s1, _, _ = env.step(s, torch.tensor(2))
  s2, _, _ = env.step(clone, torch.tensor(2))
  np.testing.assert_array_equal(s1.obs.numpy(), s2.obs.numpy())


def test_cuda_refused_without_a_card():
  if torch.cuda.is_available():
    pytest.skip('a CUDA device is present')
  with pytest.raises(RuntimeError, match='CUDA'):
    tenvs.Breakout()
