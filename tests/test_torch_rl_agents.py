"""The port's RL agents (rigl_tpu_torch/rl: replay, networks, DQN, PPO,
SAC, the runner) against the JAX package's, on the CPU.

* Replay: adds wrap as JAX's do, and `gather` at JAX's sampled indices
  returns JAX's batch.
* Networks: MLPQNetwork, NatureDQN, ImpalaNet, the PPO actor-critic and
  SAC's actor and twin critic on JAX's variables (convert.py) give flax's
  outputs within NET_TOL of their largest value.
* Learn steps from one state: the JAX agent collects a replay (a jitted
  scan of its env steps), its state is carried to the port
  (convert.dqn_state_from_jax and the PPO / SAC twins), and both take
  the same learn steps: the replay indices, SAC's noise and PPO's
  rollout and permutations are JAX's, and the drop noise and SET draws
  come through SparseTraining's seams.  The DQN runs rigl, set, static,
  snip, dnw and prune (rigl also on NatureDQN), each four learn steps
  with mask updates and target syncs inside them; PPO one iteration's
  update over JAX's rollout (and GAE against JAX's); SAC three learn
  steps.  Masks and target masks must be equal, the first loss within
  LOSS_RTOL, params, target params and Adam's slots within TOL of each
  tensor's largest value plus ATOL.
* The port alone: the premask invariants, the smoke runs of
  tests/test_rl.py (DQN in four modes, the target sync, PPO, SAC, the
  conv DQN on Breakout, the net shapes) and PhaseRunner.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rigl_tpu.rl import dqn as jdqn
from rigl_tpu.rl import envs as jenvs
from rigl_tpu.rl import networks as jnets
from rigl_tpu.rl import ppo as jppo
from rigl_tpu.rl import replay as jreplay
from rigl_tpu.rl import sac as jsac
from rigl_tpu.sparsity import masks as jmasks
from rigl_tpu_torch import convert
from rigl_tpu_torch.rl import dqn as tdqn
from rigl_tpu_torch.rl import envs as tenvs
from rigl_tpu_torch.rl import networks as tnets
from rigl_tpu_torch.rl import ppo as tppo
from rigl_tpu_torch.rl import replay as treplay
from rigl_tpu_torch.rl import sac as tsac
from rigl_tpu_torch.rl.runner import PhaseRunner
from rigl_tpu_torch.sparsity import masks as masks_lib
from torch_threads import one_thread  # noqa: F401

NET_TOL = 1e-5
LOSS_RTOL = 1e-5
# Adam divides each gradient by its running RMS, so the packages'
# summation-order differences (1e-7 of a layer's largest gradient) become
# a part of a step of size lr (1e-3) where a gradient is near 0.
TOL, ATOL = 1e-5, 2e-5
DQN_METHODS = ['rigl', 'set', 'static', 'snip', 'dnw', 'prune']


def _np(tree):
  return jax.tree.map(
      lambda a: a if jax.dtypes.issubdtype(a.dtype, jax.dtypes.prng_key)
      else np.array(a), tree)


def _flat(tree):
  """A JAX params tree or flat dict -> {path: numpy array}."""
  return convert._paths(jax.tree.map(np.asarray, tree))


def _close(got, want, what):
  for p, w in want.items():
    g = got[p].detach().cpu().numpy()
    w = np.asarray(w)
    scale = max(float(np.abs(w).max()), 1e-30)
    err = float(np.abs(g - w).max())
    assert err <= TOL * scale + ATOL, (what, p, err, scale)


def _masks_equal(got, want, what):
  assert set(got) == set(want), what
  for p, w in want.items():
    np.testing.assert_array_equal(got[p].cpu().numpy(), np.asarray(w),
                                  err_msg=f'{what} {p}')


def _adam_close(optimizer, params, opt_state, what):
  slots = convert._adam_slots(opt_state, {})
  mu, nu = _flat(slots['mu']), _flat(slots['nu'])
  for p, t in params.items():
    st = optimizer.state[t]
    assert int(st['step']) == slots['count'], (what, p)
    _close({p: st['exp_avg']}, {p: mu[p]}, f'{what} mu')
    _close({p: st['exp_avg_sq']}, {p: nu[p]}, f'{what} nu')


def _seams(jst, tst):
  """JAX's drop noise and SET grow draws, handed to the port."""
  seen = {}
  port_grow = tst._grow_score

  def drop_noise(step, i, path, mask, w):
    seen['step'] = step
    return torch.as_tensor(np.asarray(jst._drop_noise(
        jnp.int32(step), i, path, jnp.asarray(mask.numpy()), None)))

  def grow_score(algo, path, mask, weights, grad, ema, gen):
    if algo.name == 'set':
      i = list(tst.layer_shapes).index(path)
      key = jst._layer_key(jnp.int32(seen['step']), i, 1)
      return torch.as_tensor(np.asarray(jst._grow_score(
          algo, path, jnp.asarray(mask.numpy()), None, None, None, key)))
    return port_grow(algo, path, mask, weights, grad, ema, gen)

  tst._drop_noise, tst._grow_score = drop_noise, grow_score


def _replay_idx(key, size, batch):
  return jax.random.randint(key, (batch,), 0, max(int(size), 1))


# ----------------------------------------------------------------- replay --
def test_replay_add_wraps_and_gathers_jax_indices():
  jbuf = jreplay.create(4, (2,))
  tbuf = treplay.create(4, (2,), device='cpu')
  for i in range(6):  # wraps around
    args = (np.full((2,), float(i), np.float32), np.int32(i % 2),
            np.float32(i), np.full((2,), float(i + 1), np.float32),
            np.bool_(i == 3))
    jbuf = jreplay.add(jbuf, *[jnp.asarray(a) for a in args])
    treplay.add(tbuf, *[torch.as_tensor(a) for a in args])
  assert tbuf.size == int(jbuf.size) == 4
  assert tbuf.ptr == int(jbuf.ptr) == 2
  assert sorted(tbuf.obs[:, 0].tolist()) == [2.0, 3.0, 4.0, 5.0]
  key = jax.random.key(0)
  jb = jreplay.sample(jbuf, key, 8)
  tb = treplay.gather(tbuf, torch.as_tensor(np.array(
      _replay_idx(key, jbuf.size, 8))))
  for k, v in jb.items():
    np.testing.assert_array_equal(tb[k].numpy(), np.asarray(v), err_msg=k)
  assert tuple(treplay.sample(tbuf, torch.Generator(), 8)['obs'].shape) == (
      8, 2)
  cbuf = treplay.create(3, (3,), action_shape=(1,), device='cpu')
  assert cbuf.action.dtype == torch.float32 and tuple(
      cbuf.action.shape) == (3, 1)


# --------------------------------------------------------------- networks --
NETS = {
    'mlp': (lambda: jnets.MLPQNetwork(3, hidden=(16, 8)),
            lambda: tnets.MLPQNetwork(3, hidden=(16, 8), obs_shape=(10, 10, 4),
                                      device='cpu'), (5, 10, 10, 4)),
    'nature': (lambda: jnets.NatureDQN(4, width=0.5),
               lambda: tnets.NatureDQN(4, width=0.5, device='cpu'),
               (5, 10, 10, 4)),
    'nature_84': (lambda: jnets.NatureDQN(6, width=0.25),
                  lambda: tnets.NatureDQN(6, width=0.25, obs_shape=(84, 84, 4),
                                          device='cpu'), (2, 84, 84, 4)),
    'impala': (lambda: jnets.ImpalaNet(5, width=0.5),
               lambda: tnets.ImpalaNet(5, width=0.5, device='cpu'),
               (5, 10, 10, 4)),
    'impala_84': (lambda: jnets.ImpalaNet(6, width=0.25),
                  lambda: tnets.ImpalaNet(6, width=0.25, obs_shape=(84, 84, 4),
                                          device='cpu'), (2, 84, 84, 4)),
}


@pytest.mark.parametrize('name', sorted(NETS))
def test_network_matches_flax(name):
  jmake, tmake, shape = NETS[name]
  jnet, tnet = jmake(), tmake()
  x = np.random.default_rng(0).random(shape, dtype=np.float32)
  variables = jax.jit(jnet.init)(jax.random.key(1), jnp.asarray(x))
  convert.load_jax_variables(tnet, {'params': _np(variables['params'])})
  want = np.asarray(jax.jit(jnet.apply)(variables, jnp.asarray(x)))
  got = tnet(torch.as_tensor(x)).detach().numpy()
  assert got.shape == want.shape
  assert np.abs(got - want).max() <= NET_TOL * max(np.abs(want).max(), 1.0)


def test_actor_critic_and_sac_nets_match_flax():
  rng = np.random.default_rng(1)
  x = rng.normal(size=(6, 4)).astype(np.float32)
  jac = jppo.ActorCritic(2, (16, 16))
  tac = tppo.ActorCritic(2, (16, 16), (4,), device='cpu')
  v = jac.init(jax.random.key(0), jnp.asarray(x))
  convert.load_jax_variables(tac, {'params': _np(v['params'])})
  for got, want in zip(tac(torch.as_tensor(x)),
                       jac.apply(v, jnp.asarray(x))):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=NET_TOL, atol=NET_TOL)
  obs = rng.normal(size=(6, 3)).astype(np.float32)
  act = rng.normal(size=(6, 1)).astype(np.float32)
  ja = jsac.GaussianActor(1, 2.0, (16, 16))
  ta = tsac.GaussianActor(1, 2.0, (16, 16), 3, device='cpu')
  va = ja.init(jax.random.key(1), jnp.asarray(obs))
  convert.load_jax_variables(ta, {'params': _np(va['params'])})
  eff = {p: t.detach() for p, t in masks_lib.param_dict(ta).items()}
  # JAX's sample draws eps from the key: replay its draw.
  key = jax.random.key(5)
  jeps = np.asarray(jax.random.normal(key, (6, 1)))
  want = ja.sample(va, jnp.asarray(obs), key)
  got = tsac.sample(ta, eff, torch.as_tensor(obs), torch.as_tensor(jeps))
  for g, w in zip(got, want):
    np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                               rtol=NET_TOL, atol=NET_TOL)
  jc = jsac.TwinCritic((16, 16))
  tc = tsac.TwinCritic((16, 16), 4, device='cpu')
  vc = jc.init(jax.random.key(2), jnp.asarray(obs), jnp.asarray(act))
  convert.load_jax_variables(tc, {'params': _np(vc['params'])})
  for g, w in zip(tc(torch.as_tensor(obs), torch.as_tensor(act)),
                  jc.apply(vc, jnp.asarray(obs), jnp.asarray(act))):
    np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                               rtol=NET_TOL, atol=NET_TOL)


# -------------------------------------------------------------------- DQN --
def _dqn_pair(method, net='mlp'):
  kw = dict(training_method=method, sparsity=0.7, buffer_capacity=128,
            min_replay=16, batch_size=16, learn_every=2,
            target_update_period=2, maskupdate_frequency=2,
            maskupdate_begin_step=0, epsilon_decay_steps=40,
            weight_decay=1e-4)
  if method == 'prune':
    kw.update(maskupdate_end_step=6)
  if net == 'mlp':
    jenv, tenv = jenvs.CartPole(), tenvs.CartPole(device='cpu')
    jnet = jnets.MLPQNetwork(2, hidden=(32, 16))
    tnet = tnets.MLPQNetwork(2, hidden=(32, 16), device='cpu')
  else:
    jenv, tenv = jenvs.Breakout(), tenvs.Breakout(device='cpu')
    jnet = jnets.NatureDQN(3, width=0.25)
    tnet = tnets.NatureDQN(3, width=0.25, device='cpu')
  ja = jdqn.SparseDQN(jnet, jenv, jdqn.DQNConfig(**kw))
  ta = tdqn.SparseDQN(tnet, tenv, tdqn.DQNConfig(**kw))
  return ja, ta


def _dqn_case(method, net='mlp', n_learn=4):
  """Four learn steps of both packages from one state; each step's
  states are checked as they come (the port's tensors change in
  place)."""
  ja, ta = _dqn_pair(method, net)
  state = jax.jit(ja.init)(jax.random.key(3))
  state, _ = jax.jit(lambda s: jax.lax.scan(ja._env_step, s, None,
                                            length=40))(state)
  tstate = convert.dqn_state_from_jax(ta, _np(state))
  _seams(ja.st, ta.st)
  # The first learn step's loss, both packages, on the same batch.
  _, k0 = jax.random.split(state.key)
  idx0 = _replay_idx(k0, state.buffer.size, ja.config.batch_size)
  jbatch = {k: v[idx0] for k, v in state.buffer._asdict().items()
            if k not in ('ptr', 'size')}
  jeff = jmasks.apply_masks(state.params, state.sparse.masks)
  jloss = float(jax.jit(ja._loss)(jeff, state.target_params,
                                 state.target_masks, jbatch))
  tbatch = treplay.gather(tstate.buffer, torch.as_tensor(np.asarray(idx0)))
  teff = tdqn.effective(tstate.params, tstate.sparse.masks, False)
  tloss = float(ta._loss(teff, tstate.target_params, tstate.target_masks,
                         tbatch))
  assert abs(tloss - jloss) <= LOSS_RTOL * abs(jloss), (tloss, jloss)
  learn = jax.jit(ja._learn)
  prev = {p: np.array(m) for p, m in state.sparse.masks.items()}
  updated = synced = False
  for i in range(n_learn):
    _, k = jax.random.split(state.key)
    idx = _replay_idx(k, state.buffer.size, ja.config.batch_size)
    state = learn(state)
    tstate = ta._learn(tstate, idx=torch.as_tensor(np.asarray(idx)))
    js, ts = _np(state), tstate
    what = f'{method}/{net} learn {i}'
    assert ts.sparse.step == int(js.sparse.step), what
    assert ts.sparse.last_update_step == int(js.sparse.last_update_step)
    _masks_equal(ts.sparse.masks, js.sparse.masks, what)
    _masks_equal(ts.target_masks, js.target_masks, what + ' target')
    _close(ts.params, _flat(js.params), what)
    _close(ts.target_params, _flat(js.target_params), what + ' target')
    _adam_close(ts.optimizer, ts.params, js.opt_state, what)
    masks = {p: np.asarray(m) for p, m in js.sparse.masks.items()}
    updated |= any((masks[p] != prev[p]).any() for p in masks)
    prev = masks
    synced |= ts.sparse.step % 2 == 0 and all(
        np.array_equal(np.asarray(js.target_masks[p]), masks[p])
        for p in masks)
    for p, t in ts.target_params.items():
      assert t.data_ptr() != ts.params[p].data_ptr(), 'target aliases online'
  return updated, synced


@pytest.mark.parametrize('method,net', [(m, 'mlp') for m in DQN_METHODS]
                         + [('rigl', 'nature')])
def test_dqn_learn_steps_match_jax(method, net):
  updated, synced = _dqn_case(method, net)
  assert synced
  if method != 'static':
    assert updated, f'{method}: no mask changed in the learn steps'


def test_dqn_epsilon_matches_jax():
  ja, ta = _dqn_pair('rigl')
  for steps in (0, 1, 7, 20, 39, 40, 41, 1000):
    assert np.float32(ta._epsilon(steps)) == np.float32(
        ja._epsilon(jnp.int32(steps))), steps


# -------------------------------------------------------------------- PPO --
def test_ppo_update_matches_jax():
  kw = dict(training_method='rigl', sparsity=0.7, rollout_length=32,
            num_epochs=2, num_minibatches=2, maskupdate_frequency=2,
            maskupdate_begin_step=0, learning_rate=1e-3, weight_decay=1e-4)
  ja = jppo.SparsePPO(jenvs.CartPole(), jppo.PPOConfig(**kw), hidden=(16,))
  ta = tppo.SparsePPO(tenvs.CartPole(device='cpu'), tppo.PPOConfig(**kw),
                      hidden=(16,))
  s0 = jax.jit(ja.init)(jax.random.key(2))
  ts0 = convert.ppo_state_from_jax(ta, _np(s0))
  _seams(ja.st, ta.st)
  s_roll, traj, last_value = jax.jit(ja._rollout)(s0)
  jadv, jret = ja._gae(traj, last_value)
  s1, metrics = jax.jit(ja.train_iteration)(s0)
  key, perms = s_roll.key, []
  for _ in range(kw['num_epochs']):
    key, k_perm = jax.random.split(key)
    perms.append(torch.as_tensor(np.asarray(
        jax.random.permutation(k_perm, kw['rollout_length']))))
  t = {k: torch.as_tensor(np.array(v)) for k, v in traj.items()}
  tadv, tret = ta._gae(t, torch.as_tensor(np.asarray(last_value)))
  np.testing.assert_allclose(tadv.numpy(), np.asarray(jadv), rtol=1e-5,
                             atol=1e-5)
  np.testing.assert_allclose(tret.numpy(), np.asarray(jret), rtol=1e-5,
                             atol=1e-5)
  # The rollout's stored log-probs and values are the port's forward's.
  eff = tdqn.effective(ts0.params, ts0.sparse.masks, False)
  logits, value = ta.net.apply_params(eff, t['obs'])
  logp = torch.log_softmax(logits, -1).gather(
      1, t['action'].long()[:, None])[:, 0]
  np.testing.assert_allclose(logp.detach().numpy(), np.asarray(traj['logp']),
                             rtol=1e-5, atol=1e-6)
  np.testing.assert_allclose(value.detach().numpy(),
                             np.asarray(traj['value']), rtol=1e-5, atol=1e-6)
  data = {'obs': t['obs'], 'action': t['action'], 'logp': t['logp'],
          'adv': torch.as_tensor(np.asarray(jadv)),
          'ret': torch.as_tensor(np.asarray(jret))}
  ts1 = ta._update(ts0, data, perms)
  js1 = _np(s1)
  assert ts1.sparse.step == int(js1.sparse.step) == int(
      metrics['update_steps'])
  _masks_equal(ts1.sparse.masks, js1.sparse.masks, 'ppo')
  assert any((np.asarray(js1.sparse.masks[p]) != np.asarray(
      s0.sparse.masks[p])).any() for p in js1.sparse.masks), 'no update'
  _close(ts1.params, _flat(js1.params), 'ppo')
  _adam_close(ts1.optimizer, ts1.params, js1.opt_state, 'ppo')


# -------------------------------------------------------------------- SAC --
def test_sac_learn_steps_match_jax():
  kw = dict(training_method='rigl', sparsity=0.6, buffer_capacity=128,
            min_replay=16, batch_size=16, maskupdate_frequency=2,
            maskupdate_begin_step=0, learning_rate=1e-3, weight_decay=1e-4)
  ja = jsac.SparseSAC(jenvs.Pendulum(), jsac.SACConfig(**kw), hidden=(16, 16))
  ta = tsac.SparseSAC(tenvs.Pendulum(device='cpu'), tsac.SACConfig(**kw),
                      hidden=(16, 16))
  state = jax.jit(ja.init)(jax.random.key(4))
  state, _ = jax.jit(lambda s: jax.lax.scan(ja._env_step, s, None,
                                            length=32))(state)
  ts = convert.sac_state_from_jax(ta, _np(state))
  _seams(ja.actor_st, ta.actor_st)
  _seams(ja.critic_st, ta.critic_st)
  learn = jax.jit(ja._learn)
  shape = (kw['batch_size'], 1)
  for i in range(3):
    _, k_samp, k_next, k_pi = jax.random.split(state.key, 4)
    draws = {'idx': _replay_idx(k_samp, state.buffer.size, kw['batch_size']),
             'eps_next': jax.random.normal(k_next, shape),
             'eps_pi': jax.random.normal(k_pi, shape)}
    state = learn(state)
    ts = ta._learn(ts, {k: torch.as_tensor(np.asarray(v))
                        for k, v in draws.items()})
    js = _np(state)
    what = f'sac learn {i}'
    for net in ('actor', 'critic'):
      jsp, tsp = getattr(js, f'{net}_sparse'), getattr(ts, f'{net}_sparse')
      assert tsp.step == int(jsp.step), what
      _masks_equal(tsp.masks, jsp.masks, f'{what} {net}')
      _close(getattr(ts, f'{net}_params'),
             _flat(getattr(js, f'{net}_params')), f'{what} {net}')
      _adam_close(getattr(ts, f'{net}_opt'), getattr(ts, f'{net}_params'),
                  getattr(js, f'{net}_opt'), f'{what} {net}')
    _masks_equal(ts.target_critic_masks, js.target_critic_masks, what)
    _close(ts.target_critic_params, _flat(js.target_critic_params),
           what + ' target')
    assert abs(float(ts.log_alpha.detach()) - float(js.log_alpha)) <= (
        TOL + ATOL)
    for p, t in ts.target_critic_params.items():
      assert t.data_ptr() != ts.critic_params[p].data_ptr()


# ------------------------------------------------- the port alone (test_rl) --
def _assert_premasked(params, masks):
  for p, m in masks.items():
    w = params[p].detach()
    assert bool((w[m == 0] == 0).all()), p


def test_sparse_dqn_premask_invariant_and_runs():
  env = tenvs.CartPole(device='cpu')
  cfg = tdqn.DQNConfig(training_method='rigl', sparsity=0.8,
                       buffer_capacity=256, min_replay=32, batch_size=16,
                       learn_every=4, epsilon_decay_steps=100,
                       maskupdate_frequency=10, maskupdate_begin_step=0,
                       premask_params=True)
  agent = tdqn.SparseDQN(tnets.MLPQNetwork(2, hidden=(32, 32), device='cpu'),
                         env, cfg)
  state = agent.init(0)
  for _ in range(20):
    state, metrics = agent.collect_and_learn(state)
  _assert_premasked(state.params, state.sparse.masks)
  _assert_premasked(state.target_params, state.target_masks)
  assert metrics['learn_steps'] >= 0


def test_sparse_ppo_premask_invariant_and_runs():
  cfg = tppo.PPOConfig(training_method='rigl', sparsity=0.7,
                       rollout_length=32, num_epochs=2, num_minibatches=2,
                       maskupdate_frequency=2, maskupdate_begin_step=0,
                       premask_params=True)
  algo = tppo.SparsePPO(tenvs.CartPole(device='cpu'), cfg)
  state = algo.init(0)
  for _ in range(5):
    state, metrics = algo.train_iteration(state)
  _assert_premasked(state.params, state.sparse.masks)
  assert np.isfinite(float(metrics['avg_return']))


def test_sparse_sac_premask_invariant_and_runs():
  cfg = tsac.SACConfig(training_method='rigl', sparsity=0.6,
                       buffer_capacity=256, min_replay=32, batch_size=16,
                       maskupdate_frequency=10, maskupdate_begin_step=0,
                       premask_params=True)
  algo = tsac.SparseSAC(tenvs.Pendulum(device='cpu'), cfg)
  state = algo.init(0)
  for _ in range(15):
    state, _ = algo.collect_and_learn(state)
  _assert_premasked(state.actor_params, state.actor_sparse.masks)
  _assert_premasked(state.critic_params, state.critic_sparse.masks)


@pytest.mark.parametrize('method', ['rigl', 'set', 'static', 'dense'])
def test_sparse_dqn_smoke(method):
  env = tenvs.CartPole(device='cpu')
  cfg = tdqn.DQNConfig(
      training_method=method if method != 'dense' else 'none', sparsity=0.8,
      buffer_capacity=256, min_replay=32, batch_size=16, learn_every=4,
      epsilon_decay_steps=100, maskupdate_frequency=10,
      maskupdate_begin_step=0)
  agent = tdqn.SparseDQN(tnets.MLPQNetwork(2, hidden=(32, 32), device='cpu'),
                         env, cfg)
  result = agent.train(total_env_steps=200, log_every=0)
  assert result['env_steps'] == 200
  assert result['learn_steps'] > 0
  if method != 'dense':
    assert result['global_sparsity'] == pytest.approx(0.8, abs=0.05)


def test_sparse_dqn_target_sync_copies_masks():
  env = tenvs.CartPole(device='cpu')
  cfg = tdqn.DQNConfig(training_method='set', sparsity=0.5,
                       buffer_capacity=128, min_replay=16, batch_size=8,
                       learn_every=2, target_update_period=5,
                       maskupdate_frequency=3, maskupdate_begin_step=0)
  agent = tdqn.SparseDQN(tnets.MLPQNetwork(2, hidden=(16,), device='cpu'),
                         env, cfg)
  state = agent.init(0)
  for _ in range(60):
    state, _ = agent.collect_and_learn(state)
  for p, m in state.target_masks.items():
    assert float(m.sum()) == float(state.sparse.masks[p].sum())
    assert m.data_ptr() != state.sparse.masks[p].data_ptr()


def test_sparse_ppo_smoke():
  env = tenvs.CartPole(device='cpu')
  cfg = tppo.PPOConfig(training_method='set', sparsity=0.7,
                       rollout_length=64, num_epochs=2, num_minibatches=2,
                       maskupdate_frequency=4, maskupdate_begin_step=0)
  agent = tppo.SparsePPO(env, cfg, hidden=(32,))
  result = agent.train(total_env_steps=256)
  assert result['env_steps'] == 256
  assert result['update_steps'] > 0
  assert result['global_sparsity'] == pytest.approx(0.7, abs=0.05)


def test_sparse_sac_smoke():
  env = tenvs.Pendulum(device='cpu')
  cfg = tsac.SACConfig(training_method='set', sparsity=0.6,
                       buffer_capacity=512, min_replay=64, batch_size=32,
                       learn_every=4, maskupdate_frequency=10,
                       maskupdate_begin_step=0)
  agent = tsac.SparseSAC(env, cfg, hidden=(32, 32))
  result = agent.train(total_env_steps=256, log_every=0)
  assert result['env_steps'] == 256
  assert result['learn_steps'] > 0
  assert result['global_sparsity'] == pytest.approx(0.6, abs=0.06)
  assert np.isfinite(result['alpha'])


def test_sparse_dqn_breakout_conv_smoke():
  env = tenvs.Breakout(device='cpu')
  cfg = tdqn.DQNConfig(training_method='rigl', sparsity=0.5,
                       maskupdate_begin_step=1, maskupdate_frequency=2,
                       buffer_capacity=200, batch_size=8, min_replay=10,
                       learn_every=2, epsilon_decay_steps=50)
  agent = tdqn.SparseDQN(tnets.ImpalaNet(env.num_actions, width=0.25,
                                         device='cpu'), env, cfg)
  state = agent.init(0)
  for _ in range(10):
    state, metrics = agent.collect_and_learn(state)
  assert state.env_steps == 10 * cfg.learn_every
  assert int(metrics['learn_steps']) > 0
  assert np.isfinite(float(metrics['avg_return']))


def test_nature_dqn_and_impala_shapes():
  for net in (tnets.NatureDQN(6, width=0.25, obs_shape=(84, 84, 4),
                              device='cpu'),
              tnets.ImpalaNet(6, width=0.25, obs_shape=(84, 84, 4),
                              device='cpu')):
    assert tuple(net(torch.zeros(2, 84, 84, 4)).shape) == (2, 6)


def test_phase_runner():
  env = tenvs.CartPole(device='cpu')
  cfg = tdqn.DQNConfig(training_method='set', sparsity=0.5,
                       buffer_capacity=256, min_replay=32, batch_size=16,
                       learn_every=4, maskupdate_frequency=20,
                       maskupdate_begin_step=0, epsilon_decay_steps=200)
  agent = tdqn.SparseDQN(tnets.MLPQNetwork(2, hidden=(16,), device='cpu'),
                         env, cfg)
  result = PhaseRunner(agent, num_phases=4, steps_per_phase=100).run(seed=0)
  assert len(result['phases']) == 4
  assert result['total_episodes'] > 0
  assert np.isfinite(result['final_score'])
  ppo = tppo.SparsePPO(env, tppo.PPOConfig(
      training_method='static', rollout_length=32, num_epochs=1,
      num_minibatches=2), hidden=(8,))
  res = PhaseRunner(ppo, num_phases=2, steps_per_phase=64).run(seed=1)
  assert [r['env_steps'] for r in res['phases']] == [64.0, 128.0]


def test_configs_have_jax_fields():
  for jcls, tcls in ((jdqn.DQNConfig, tdqn.DQNConfig),
                     (jppo.PPOConfig, tppo.PPOConfig),
                     (jsac.SACConfig, tsac.SACConfig)):
    assert dataclasses.asdict(jcls()) == dataclasses.asdict(tcls())
