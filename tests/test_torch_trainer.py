"""The port's Trainer (rigl_tpu_torch/train/trainer.py) against the JAX
package's, on the CPU.

* Config: TrainConfig's fields, defaults and resolved() equal JAX's, and
  every preset under configs/ loads into equal configs in both packages
  (or is refused by both).
* Step accounting: simulate_step_sequence and predict_update_batches equal
  JAX's for every method, start step and last update step.
* Learning rates: every build_lr_fn schedule equals JAX's over a grid of
  steps holding every boundary; the piecewise and warmup ones bit for
  bit, sgdr and mnist (XLA's cos / log / pow against numpy's) within one
  float32 ulp of the schedule's peak (near the cosine's zero XLA's cos
  differs by 6e-8, many ulps of so small a rate).
* Step for step: JAX's Trainer and the port's train from one state
  (convert.trainer_state_from_jax), JAX's drop noise and SET draws handed
  to the port through SparseTraining's seams, for all nine methods with
  the optimizers and schedules spread over them, a LeNet5 case with
  weight decay and label smoothing, and MobileNetV1 under the mobilenet
  ImageNet warmup (its rate moves every step).  Masks must be equal,
  losses at every log within LOSS_RTOL, params and optimizer slots
  within TOL of each tensor's largest value plus ATOL, the history's keys
  and the result's batches and eval metrics equal.  MobileNetV1 runs in
  float64 in both packages (JAX under enable_x64), as
  tests/test_torch_models.py does: at init its float32 train-mode
  gradients differ by a few percent between evaluation orders, and its
  loss follows them.  JAX runs on the tests' 8-device mesh, which only
  reorders its reductions.  Each case's runs are shared by the tests of
  the case (module fixture).
* The port alone: every other case of tests/test_trainer.py.
"""

import dataclasses
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rigl_tpu.drivers import train as jdriver
from rigl_tpu.train import trainer as jtr
from rigl_tpu_torch import convert
from rigl_tpu_torch.drivers import train as tdriver
from rigl_tpu_torch.sparsity import masks as masks_lib
from rigl_tpu_torch.sparsity.schedules import UpdateSchedule
from rigl_tpu_torch.train import trainer as ttr
from rigl_tpu_torch.train.trainer import (TrainConfig, Trainer,
                                          predict_update_batches,
                                          simulate_step_sequence)
from rigl_tpu_torch.transforms import algorithms
from torch_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(
    p for p in glob.glob(os.path.join(REPO, 'configs', '*.json'))
    if not os.path.basename(p).startswith(('rl_', 'routing_')))
METHODS = ['rigl', 'set', 'static', 'momentum', 'snip', 'dnw', 'prune',
           'scratch', 'none']
LOSS_RTOL = 1e-5
TOL, ATOL = 1e-5, 1e-7
# Adam divides each gradient by its own running RMS, so where a weight's
# gradients are near 0 the packages' summation-order differences (1e-7
# of a layer's largest gradient) become a part of a whole lr-sized step:
# its params within 2% of one step (lr 1e-3) over the run.
ADAM_ATOL = 2e-5


def _base(**kw):
  base = dict(
      model='mnist_mlp', dataset='mnist', batch_size=32, train_steps=8,
      log_every=4, maskupdate_frequency=2, maskupdate_begin_step=0,
      maskupdate_end_step=-1, drop_fraction=0.3,
      drop_fraction_anneal='constant', base_learning_rate=0.1,
      lr_schedule='constant', n_synthetic=256, seed=0)
  base.update(kw)
  return base


def _cfg(**kw):
  return TrainConfig(**_base(**kw))


def _trainer(**kw):
  return Trainer(_cfg(**kw), device='cpu')


# ------------------------------------------------------------------ config --
def test_train_config_fields_and_defaults_equal_jax():
  assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(
      jtr.TrainConfig())
  kw = dict(training_steps_multiplier=2.5, train_steps=1000,
            maskupdate_begin_step=30, maskupdate_end_step=700)
  assert dataclasses.asdict(TrainConfig(**kw).resolved()) == (
      dataclasses.asdict(jtr.TrainConfig(**kw).resolved()))
  kw['maskupdate_end_step'] = -1
  assert dataclasses.asdict(TrainConfig(**kw).resolved()) == (
      dataclasses.asdict(jtr.TrainConfig(**kw).resolved()))
  assert TrainConfig(**kw).to_json() == jtr.TrainConfig(**kw).to_json()


@pytest.mark.parametrize('path', CONFIGS,
                         ids=[os.path.basename(p) for p in CONFIGS])
def test_preset_loads_as_in_jax(path):
  overrides = ['train_steps=7', "model_kwargs={'features': (16, 8)}",
               'log_every=3', 'data_dir=/nowhere']
  try:
    want = jdriver.load_config(path, overrides)
  except TypeError:
    with pytest.raises(TypeError):
      tdriver.load_config(path, overrides)
    return
  got = tdriver.load_config(path, overrides)
  assert dataclasses.asdict(got) == dataclasses.asdict(want)
  assert dataclasses.asdict(tdriver.load_config(path)) == (
      dataclasses.asdict(jdriver.load_config(path)))


# --------------------------------------------------------- step accounting --
def _algo_pair(method, **kw):
  cfg = dict(training_method=method, maskupdate_begin_step=2,
             maskupdate_end_step=40, maskupdate_frequency=3,
             drop_fraction_anneal='cosine', **kw)
  return (ttr.build_algorithm(TrainConfig(**cfg)),
          jtr.build_algorithm(jtr.TrainConfig(**cfg)))


@pytest.mark.parametrize('method', METHODS + ['rigl_inverted'])
def test_step_accounting_equals_jax(method):
  talgo, jalgo = _algo_pair(method)
  for start, last in ((0, None), (1, None), (5, 2), (9, 8), (30, 29),
                      (39, 36), (45, 39)):
    for total in (0, 4, 10, 41, 60):
      assert simulate_step_sequence(talgo, total, start, last) == (
          jtr.simulate_step_sequence(jalgo, total, start, last)), (
              start, last, total)
    for n in (0, 1, 7, 30):
      assert predict_update_batches(talgo, n, start, last) == (
          jtr.predict_update_batches(jalgo, n, start, last)), (start, last, n)


def test_simulate_step_sequence_rigl():
  algo = algorithms.RigL(schedule=UpdateSchedule(
      begin_step=2, end_step=-1, frequency=3, drop_fraction=0.3))
  # steps 0..5: updates at 2, 5 -> 8 batches for 6 steps.
  assert simulate_step_sequence(algo, 6) == 8
  set_algo = algorithms.SET(schedule=UpdateSchedule(frequency=2))
  assert simulate_step_sequence(set_algo, 6) == 6
  assert simulate_step_sequence(algorithms.SNIP(), 6) == 7


def test_predict_update_batches():
  rigl = algorithms.RigL(schedule=UpdateSchedule(begin_step=2, end_step=-1,
                                                 frequency=3))
  assert predict_update_batches(rigl, 8) == {2, 6}
  set_algo = algorithms.SET(schedule=UpdateSchedule(begin_step=1, end_step=4,
                                                    frequency=2))
  assert predict_update_batches(set_algo, 8) == {0, 2}
  assert predict_update_batches(algorithms.SNIP(), 5) == {0}


def test_auto_resume_rigl_batch_accounting():
  rigl = algorithms.RigL(schedule=UpdateSchedule(begin_step=0, end_step=-1,
                                                 frequency=3))
  full = simulate_step_sequence(rigl, 9)
  first = simulate_step_sequence(rigl, 5)
  rest = simulate_step_sequence(rigl, 9, start_step=5, start_last_update=3)
  assert first + rest == full


# ---------------------------------------------------------- learning rates --
_STEPS = np.array(sorted(set(
    list(range(0, 300)) + [int(x) for x in np.linspace(0, 200000, 801)]
    + [b + d for b in (30000, 60000, 90000, 51000, 102000, 153000,
                       37536, 87584, 112590, 150120, 25000, 50000)
       for d in (-1, 0, 1)])), np.int64)
_LR_CASES = {
    'constant': dict(lr_schedule='constant', base_learning_rate=0.3),
    'mnist': dict(lr_schedule='mnist', base_learning_rate=0.2),
    'cifar': dict(lr_schedule='cifar'),
    'cifar_x1.7': dict(lr_schedule='cifar', training_steps_multiplier=1.7),
    'sgdr': dict(lr_schedule='sgdr', base_learning_rate=0.1),
    'imagenet_resnet': dict(lr_schedule='imagenet', model='resnet'),
    'imagenet_vgg': dict(lr_schedule='imagenet', model='vgg'),
    'imagenet_mobilenet': dict(lr_schedule='imagenet', model='mobilenet_v1'),
    'imagenet_resnet_x5': dict(lr_schedule='imagenet', model='resnet',
                               training_steps_multiplier=5.0),
    'imagenet_mobilenet_x2.5': dict(lr_schedule='imagenet',
                                    model='mobilenet_v1',
                                    training_steps_multiplier=2.5),
}


@pytest.mark.parametrize('case', list(_LR_CASES))
@pytest.mark.parametrize('steps_per_epoch', [1251.2, 8.0])
def test_lr_schedule_equals_jax(case, steps_per_epoch):
  kw = dict(batch_size=1024, **_LR_CASES[case])
  tfn = ttr.build_lr_fn(TrainConfig(**kw), steps_per_epoch)
  jfn = jtr.build_lr_fn(jtr.TrainConfig(**kw), steps_per_epoch)
  want = np.broadcast_to(np.asarray(jfn(jnp.asarray(_STEPS))),
                         _STEPS.shape).astype(np.float32)
  got = np.array([tfn(int(s)) for s in _STEPS])
  assert got.dtype == np.float32
  if kw['lr_schedule'] in ('sgdr', 'mnist'):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=np.spacing(np.float32(want.max())))
  else:
    np.testing.assert_array_equal(got, want)
  if kw.get('model', '').startswith('mobilenet'):
    # The warmup: the rate moves every step.
    assert np.all(np.diff(got[:20]) > 0)


# ------------------------------------------------------ step-for-step twins --
# name -> (trainer config overrides, float64).
TWINS = {
    'rigl': (dict(training_method='rigl', optimizer='momentum',
                  use_nesterov=True, lr_schedule='mnist',
                  base_learning_rate=0.2, static_update_steps=True,
                  premask_params=True, drop_fraction_anneal='cosine',
                  maskupdate_end_step=7), False),
    'set': (dict(training_method='set', optimizer='adam',
                 base_learning_rate=1e-3), False),
    'static': (dict(training_method='static', use_nesterov=False,
                    lr_schedule='sgdr'), False),
    'momentum': (dict(training_method='momentum'), False),
    'snip': (dict(training_method='snip', sparsity=0.7), False),
    'dnw': (dict(training_method='dnw', optimizer='sgd'), False),
    'prune': (dict(training_method='prune', optimizer='sgd',
                   prune_initial_sparsity=0.2, maskupdate_end_step=6),
              False),
    'scratch': (dict(training_method='scratch', lr_schedule='imagenet',
                     base_learning_rate=0.8), False),
    'none': (dict(training_method='none'), False),
    'lenet5': (dict(model='lenet5', training_method='rigl',
                    weight_decay=5e-4, label_smoothing=0.1), False),
    # At 28 px MobileNetV1's last BatchNorms see 1 x 1 maps: a channel
    # that ReLU zeroed over the batch divides by sqrt(eps), so its loss
    # moves by orders of magnitude more than its parameters.  Even in
    # float64, where the loss alone is float32, the two packages' 1e-7
    # grows about tenfold a step at a peak rate of 1e-2; the warmup's
    # rates up to 2.2e-4 (0.02 * 32 / 256 * step / 64) keep it at 1e-6.
    'mobilenet_warmup': (dict(model='mobilenet_v1', training_method='scratch',
                              model_kwargs={'width': 0.25},
                              lr_schedule='imagenet', base_learning_rate=0.02,
                              log_every=1), True),
}


def _np_state(state):
  return jax.tree.map(
      lambda a: a if jax.dtypes.issubdtype(a.dtype, jax.dtypes.prng_key)
      else np.asarray(a), state)


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


def _run_twin(name):
  kw, f64 = TWINS[name]
  base = _base(**kw)
  if f64:
    with jax.enable_x64(True):
      jbase = dict(base, model_kwargs=dict(base['model_kwargs'],
                                           dtype=jnp.float64))
      jt = jtr.Trainer(jtr.TrainConfig(**jbase))
      jt.init_state()
      as64 = lambda t: jax.tree.map(
          lambda a: a.astype(jnp.float64)
          if jnp.issubdtype(a.dtype, jnp.floating) else a, t)
      jt.state = jt.state.replace(params=as64(jt.state.params),
                                  batch_stats=as64(jt.state.batch_stats),
                                  opt_state=as64(jt.state.opt_state))
      state0 = _np_state(jt.state)
      jresult = jt.train()
      jstate = _np_state(jt.state)
  else:
    jt = jtr.Trainer(jtr.TrainConfig(**base))
    jt.init_state()
    state0 = _np_state(jt.state)
    jresult = jt.train()
    jstate = _np_state(jt.state)
  tbase = dict(base)
  if f64:
    tbase['model_kwargs'] = dict(base['model_kwargs'], dtype=torch.float64)
  tt = Trainer(TrainConfig(**tbase), device='cpu')
  if f64:
    tt.model.double()
  convert.trainer_state_from_jax(tt, state0)
  _seams(jt.sparse_training, tt.sparse_training)
  # The seams draw as JAX's run drew: in float64 under enable_x64.
  with jax.enable_x64(f64):
    tresult = tt.train()
  return dict(jt=jt, tt=tt, jresult=jresult, tresult=tresult, jstate=jstate)


@pytest.fixture(scope='module')
def twins():
  """Each case's JAX and port runs, made once for the module."""
  cache = {}

  def get(name):
    if name not in cache:
      cache[name] = _run_twin(name)
    return cache[name]
  return get


def _close(got, want, msg, atol=ATOL):
  got = got.detach().to(torch.float64).numpy()
  want = np.asarray(want, np.float64)
  tol = TOL * float(np.nanmax(np.abs(want), initial=0.0)) + atol
  np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=msg)


@pytest.mark.parametrize('name', list(TWINS))
def test_twin_losses_and_history(twins, name):
  run = twins(name)
  jh, th = run['jt'].metrics_history, run['tt'].metrics_history
  assert [sorted(m) for m in th] == [sorted(m) for m in jh]
  jl = [m['loss'] for m in jh if 'loss' in m]
  tl = [m['loss'] for m in th if 'loss' in m]
  assert len(tl) == len(jl) > 0
  np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
  for jm, tm in zip(jh, th):
    for k in ('step', 'learning_rate', 'mask_updated', 'drop_fraction',
              'global_sparsity', 'update_hint_ok'):
      if k in jm:
        assert tm[k] == pytest.approx(jm[k], rel=1e-6, abs=1e-9), k


@pytest.mark.parametrize('name', list(TWINS))
def test_twin_masks_equal(twins, name):
  run = twins(name)
  jmasks = run['jstate'].sparse.masks
  tstate = run['tt'].state
  assert set(tstate.sparse.masks) == set(jmasks)
  for p, m in jmasks.items():
    np.testing.assert_array_equal(tstate.sparse.masks[p].numpy(), m, p)
  assert tstate.sparse.step == int(run['jstate'].sparse.step)
  assert tstate.sparse.last_update_step == int(
      run['jstate'].sparse.last_update_step)
  assert tstate.sparse.is_snipped == bool(run['jstate'].sparse.is_snipped)


@pytest.mark.parametrize('name', list(TWINS))
def test_twin_params_and_slots(twins, name):
  run = twins(name)
  arrays = convert._jax_state_arrays(run['jstate'])
  tstate = run['tt'].state
  jparams = convert._paths(arrays['params'])
  jstats = convert._paths(arrays['batch_stats'])
  slots = {}
  if arrays.get('momentum') is not None:
    slots['momentum_buffer'] = convert._paths(arrays['momentum'])
  if arrays.get('mu') is not None:
    slots['exp_avg'] = convert._paths(arrays['mu'])
    slots['exp_avg_sq'] = convert._paths(arrays['nu'])
  adam = 'mu' in arrays
  for p, t in tstate.params.items():
    _close(t, jparams[p], f'{name} {p}', ADAM_ATOL if adam else ATOL)
    state = tstate.optimizer.state[t]
    for key, want in slots.items():
      _close(state[key], want[p], f'{name} {key} {p}')
    if 'exp_avg' in slots:
      assert float(state['step']) == arrays['count']
  for p, t in tstate.batch_stats.items():
    _close(t, jstats[p], f'{name} stats {p}')
  if run['jstate'].sparse.ema_grads is not None:
    for p, e in run['jstate'].sparse.ema_grads.items():
      _close(tstate.sparse.ema_grads[p], e, f'{name} ema {p}')


@pytest.mark.parametrize('name', list(TWINS))
def test_twin_result(twins, name):
  run = twins(name)
  jr, tr = run['jresult'], run['tresult']
  assert set(tr) == set(jr)
  assert tr['batches'] == jr['batches'] and tr['train_steps'] == (
      jr['train_steps'])
  for k in ('final_loss', 'eval_loss'):
    assert tr[k] == pytest.approx(jr[k], rel=LOSS_RTOL)
  for k in ('eval_top_1', 'eval_top_5', 'global_sparsity'):
    if k in jr:
      assert tr[k] == pytest.approx(jr[k], abs=1e-6)


# -------------------------------------------------- the port alone (twins) --
@pytest.mark.parametrize('method', METHODS)
def test_all_methods_train_smoke(method):
  t = _trainer(training_method=method, sparsity=0.5)
  result = t.train(total_steps=4)
  assert np.isfinite(result['eval_loss'])
  if method == 'none':
    assert 'global_sparsity' not in result or result['global_sparsity'] == 0
  elif method != 'prune':
    assert result['global_sparsity'] == pytest.approx(0.5, abs=0.05)


def test_trainer_reaches_exact_step_count():
  t = _trainer(training_method='rigl', train_steps=7, maskupdate_frequency=3)
  result = t.train()
  assert t.state.sparse.step == 7
  assert result['batches'] == simulate_step_sequence(t.algo, 7)


def test_synthetic_task_learns_sparse():
  t = _trainer(training_method='rigl', sparsity=0.9, train_steps=150,
               maskupdate_frequency=25, batch_size=64, n_synthetic=512,
               base_learning_rate=0.2)
  result = t.train()
  assert result['eval_top_1'] > 0.5  # 10 classes, chance = 0.1
  assert result['global_sparsity'] == pytest.approx(0.9, abs=0.02)


def test_mask_sparsity_constant_through_training():
  t = _trainer(training_method='set', sparsity=0.7, train_steps=10,
               maskupdate_frequency=2)
  t.train()
  assert float(masks_lib.calculate_sparsity(t.state.sparse.masks)) == (
      pytest.approx(0.7, abs=0.02))


def test_custom_sparsity_map_mnist_convention():
  from rigl_tpu_torch.models.mlp import MnistMLP
  cmap = MnistMLP(device='meta').custom_sparsity_map(0.98, 0.9)
  t = _trainer(training_method='set', sparsity=0.98, custom_sparsity_map=cmap,
               train_steps=2, mask_init_method='random')
  t.init_state()
  masks = t.state.sparse.masks
  assert float(masks['layer3/kernel'].mean()) == 1.0  # dense
  s2 = 1.0 - float(masks['layer2/kernel'].mean())
  assert s2 == pytest.approx(0.98 * 0.9, abs=0.01)


def test_eval_top5_geq_top1():
  t = _trainer(training_method='set', train_steps=2)
  t.init_state()
  m = t.evaluate()
  assert m['top_5'] >= m['top_1']


def test_snapshot_mask_updates(tmp_path):
  from rigl_tpu_torch.utils.metrics import read_metrics
  t = _trainer(training_method='rigl', train_steps=6, maskupdate_frequency=3,
               maskupdate_begin_step=2, snapshot_mask_updates=True,
               checkpoint_dir=str(tmp_path / 'out'), log_every=0)
  t.train()
  recs = read_metrics(str(tmp_path / 'out'))
  upd = [r for r in recs if 'mask_update_grad_norm_improvement' in r]
  assert len(upd) == 2  # updates at steps 2 and 5
  assert all(np.isfinite(r['mask_update_grad_norm_pre']) for r in upd)
  assert sorted(os.listdir(tmp_path / 'out' / 'pre_update')) == ['2', '6']
  assert sorted(os.listdir(tmp_path / 'out' / 'post_update')) == ['2', '6']


def test_tensor_parallel_sharding_refused():
  """n_model_shards > 1 (JAX's tensor-parallel mesh) waits for the
  parallel modules; the port refuses it, and asking for CUDA without a
  card raises too."""
  with pytest.raises(NotImplementedError, match='Slice 10'):
    _trainer(training_method='rigl', n_model_shards=2)
  if not torch.cuda.is_available():
    with pytest.raises(RuntimeError, match='CUDA'):
      Trainer(_cfg())


def test_auto_resume_continues_training(tmp_path):
  kw = dict(training_method='set', maskupdate_frequency=2,
            checkpoint_dir=str(tmp_path / 'run'), log_every=0)
  t1 = _trainer(train_steps=4, **kw)
  t1.train()
  assert t1.state.sparse.step == 4
  t2 = _trainer(train_steps=10, **kw)
  result = t2.train()
  assert t2.state.sparse.step == 10
  assert result['batches'] == 6  # only the remaining steps


def test_block_flags_through_config():
  from rigl_tpu_torch.ops.block_mask import pool_to_blocks
  t = _trainer(training_method='rigl', block_width=4, block_height=4,
               mask_init_method='random', sparsity=0.5, train_steps=3)
  t.init_state()
  blocks = pool_to_blocks(t.state.sparse.masks['layer1/kernel'], (4, 4),
                          'mean')
  assert set(np.unique(blocks.numpy())) <= {0.0, 1.0}


def test_block_execution_through_config(tmp_path):
  """A small ResNet with block execution of its 1x1s and 3x3s (the plain
  versions of the tap kernels here), RigL with premask and static hints,
  checkpointed and resumed: the counts stay static, the packs follow the
  masks, and the steps are the schedule's."""
  from rigl_tpu_torch.ops import block_mask as bm_lib
  from rigl_tpu_torch.ops.block_sparse_conv import TapPack
  kw = dict(model='resnet', model_kwargs={'depth': 50, 'width': 0.125},
            dataset='cifar10', batch_size=4, n_synthetic=16,
            training_method='rigl', sparsity=0.8, maskupdate_frequency=2,
            block_width=8, block_height=8, block_execution=True,
            block_conv3x3=True, premask_params=True,
            static_update_steps=True, checkpoint_dir=str(tmp_path / 'run'),
            log_every=2, lr_schedule='imagenet')
  t = _trainer(train_steps=3, **kw)
  result = t.train()
  assert result['batches'] == simulate_step_sequence(t.algo, 3)
  st, state = t.sparse_training, t.state
  paths = bm_lib.block_executable_layers(state.sparse.masks, st.block,
                                         conv3x3=True)
  packs = state.sparse.block_packs
  assert len(paths) > 20 and set(paths) <= set(packs)
  assert all(isinstance(packs[p], TapPack) for p in paths)
  for p, want in st.static_block_counts().items():
    m = state.sparse.masks[p]
    pool = (bm_lib.pool_to_tap_blocks if bm_lib.is_tap_layer(
        tuple(m.shape), st.block) else bm_lib.pool_to_blocks)
    assert int((pool(m, st.block, 'max') > 0).sum()) == want, p
  t2 = _trainer(train_steps=5, **kw)
  result2 = t2.train()
  assert t2.state.sparse.step == 5
  assert result2['batches'] == simulate_step_sequence(
      t2.algo, 5, start_step=3, start_last_update=state.sparse.last_update_step)


def test_mask_type_through_config():
  t = _trainer(training_method='scratch', mask_type='per_neuron',
               sparsity=0.5, train_steps=2, mask_init_method='random')
  t.init_state()
  fan_ins = t.state.sparse.masks['layer1/kernel'].sum(0)
  assert len(set(fan_ins.tolist())) == 1


def test_init_masks_from_other_run(tmp_path):
  ta = _trainer(training_method='set', train_steps=4, maskupdate_frequency=2,
                checkpoint_dir=str(tmp_path / 'a'), log_every=0)
  ta.train()
  masks_a = ta.state.sparse.masks['layer1/kernel'].clone()
  tb = _trainer(training_method='static', train_steps=2, seed=5,
                init_masks_from=str(tmp_path / 'a'))
  state = tb.init_state()
  assert torch.equal(state.sparse.masks['layer1/kernel'], masks_a)
  # Params are fresh (another seed, not A's), and the model's own.
  assert not torch.equal(state.params['layer1/kernel'],
                         ta.state.params['layer1/kernel'])
  assert state.params['layer1/kernel'] is dict(
      tb.model.named_parameters())['layer1.kernel']
  # Shuffled-mask control: same sparsity, different layout.
  tc = _trainer(training_method='static', train_steps=2, seed=5,
                init_masks_from=str(tmp_path / 'a'),
                shuffle_loaded_masks=True)
  mc = tc.init_state().sparse.masks['layer1/kernel']
  assert float(mc.sum()) == float(masks_a.sum())
  assert not torch.equal(mc, masks_a)


@pytest.mark.parametrize('method', ['rigl', 'set'])
def test_static_update_steps_matches_default(method):
  t0 = _trainer(training_method=method)
  r0 = t0.train(total_steps=6)
  t1 = _trainer(training_method=method, static_update_steps=True)
  r1 = t1.train(total_steps=6)
  assert t1.state.sparse.step == t0.state.sparse.step
  for p, m in t0.state.sparse.masks.items():
    assert torch.equal(t1.state.sparse.masks[p], m), p
  np.testing.assert_allclose(r1['final_loss'], r0['final_loss'], rtol=1e-4,
                             atol=1e-6)


def _assert_premasked(state):
  for p, m in state.sparse.masks.items():
    assert not bool((state.params[p] * (1 - m)).any()), p


def test_auto_resume_with_premask_and_hints(tmp_path):
  kw = dict(training_method='rigl', maskupdate_frequency=2,
            checkpoint_dir=str(tmp_path / 'run'), log_every=0,
            premask_params=True, static_update_steps=True)
  _trainer(train_steps=3, **kw).train()
  t2 = _trainer(train_steps=8, **kw)
  t2.train()
  assert t2.state.sparse.step == 8
  _assert_premasked(t2.state)


def test_wrong_update_hint_fails_loudly(monkeypatch):
  real = ttr.predict_update_batches

  def wrong(algo, n_batches, **kw):
    return {b + 1 for b in real(algo, n_batches, **kw) if b + 1 < n_batches}

  monkeypatch.setattr(ttr, 'predict_update_batches', wrong)
  t = _trainer(training_method='rigl', static_update_steps=True, log_every=4)
  with pytest.raises(RuntimeError, match='hint mismatch'):
    t.train(total_steps=6)


def test_premask_violation_fails_loudly():
  t = _trainer(training_method='rigl', premask_params=True,
               maskupdate_begin_step=100, log_every=1)
  t.init_state()
  path = next(iter(t.state.sparse.masks))
  m = t.state.sparse.masks[path]
  idx = int(torch.nonzero(m.reshape(-1) == 0)[0])
  with torch.no_grad():
    t.state.params[path].view(-1)[idx] = 0.5
  with pytest.raises(RuntimeError, match='premask invariant'):
    t.train(total_steps=2)


def test_latent_checkpoint_into_premask_run(tmp_path):
  base = dict(training_method='rigl', maskupdate_frequency=2,
              checkpoint_dir=str(tmp_path / 'run'), log_every=0)
  _trainer(train_steps=4, **base).train()   # latent mode
  t2 = _trainer(train_steps=7, premask_params=True, maskupdate_end_step=2,
                **base)
  t2.train()
  _assert_premasked(t2.state)


def test_init_masks_from_with_premask_preserves_init_values(tmp_path):
  _trainer(training_method='set', train_steps=4, maskupdate_frequency=2,
           checkpoint_dir=str(tmp_path / 'a'), log_every=0).train()
  state = _trainer(training_method='static', train_steps=2, seed=5,
                   init_masks_from=str(tmp_path / 'a'),
                   premask_params=True).init_state()
  raw = _trainer(training_method='static', train_steps=2,
                 seed=5).init_state()
  for p, m in state.sparse.masks.items():
    assert not bool((state.params[p] * (1 - m)).any()), p
    assert torch.equal(state.params[p] * m, raw.params[p] * m), p


def test_init_state_twice_starts_from_the_seed():
  t = _trainer(training_method='set', train_steps=4)
  first = {p: v.clone() for p, v in t.init_state().params.items()}
  t.train()
  again = t.init_state()
  for p, v in first.items():
    assert torch.equal(again.params[p], v), p
