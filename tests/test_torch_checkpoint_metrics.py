"""The port's checkpoints, metrics helpers, eval loop and export
(rigl_tpu_torch/train/checkpoint.py, utils/metrics.py, train/eval_loop.py,
train/export.py) on the CPU: twins of tests/test_checkpoint_metrics.py,
the metrics helpers against the JAX package's on the same numpy inputs
(exactly, on inputs whose float32 sums are exact; snr_summaries within
SNR_RTOL, its per-example gradients summed in another order), the export
against JAX's export_model of the same state (its msgpack read back with
flax), and convert.train_state_from_jax / trainer_state_from_jax with
each optimizer's slots.
"""

import json
import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rigl_tpu.train import export as jexport
from rigl_tpu.train import trainer as jtr
from rigl_tpu.utils import metrics as jmetrics
from rigl_tpu_torch import convert
from rigl_tpu_torch.train.checkpoint import (CheckpointManager,
                                             restore_masks_only,
                                             restore_params_only,
                                             shuffle_masks)
from rigl_tpu_torch.train.trainer import TrainConfig, Trainer
from rigl_tpu_torch.utils import metrics
from torch_threads import one_thread  # noqa: F401

SNR_RTOL = 1e-5


def _kw(tmp_path, **kw):
  base = dict(model='mnist_mlp', dataset='mnist', batch_size=16,
              train_steps=4, log_every=2, maskupdate_frequency=2,
              training_method='set', sparsity=0.5, n_synthetic=64,
              checkpoint_dir=str(tmp_path / 'ckpt'), checkpoint_every=2)
  base.update(kw)
  return base


def _small_trainer(tmp_path, **kw):
  return Trainer(TrainConfig(**_kw(tmp_path, **kw)), device='cpu')


def _np_state(state):
  return jax.tree.map(
      lambda a: a if jax.dtypes.issubdtype(a.dtype, jax.dtypes.prng_key)
      else np.asarray(a), state)


# ------------------------------------------------------------ checkpoints --
def test_checkpoint_roundtrip(tmp_path):
  t = _small_trainer(tmp_path)
  t.train()
  state = t.state
  mgr = CheckpointManager(str(tmp_path / 'ckpt'))
  assert mgr.all_steps() == [2, 4]
  assert mgr.latest_step() == 4
  fresh = _small_trainer(tmp_path).init_state()
  restored = mgr.restore(fresh)
  for p, m in state.sparse.masks.items():
    assert torch.equal(restored.sparse.masks[p], m), p
  for p, w in state.params.items():
    assert torch.equal(restored.params[p], w), p
    assert restored.params[p] is not fresh.params[p]
    assert torch.equal(
        restored.optimizer.state[restored.params[p]]['momentum_buffer'],
        state.optimizer.state[w]['momentum_buffer']), p
  assert restored.sparse.step == 4
  assert restored.sparse.last_update_step == state.sparse.last_update_step
  assert restored.sparse.block_packs is None
  assert type(restored.optimizer) is type(state.optimizer)
  assert restored.optimizer.defaults == state.optimizer.defaults
  mgr.close()


def test_checkpoint_files_and_keys(tmp_path):
  """One directory per step holding the flat dict, keyed by the JAX
  TrainState's paths; a saved step is not saved again; the newest
  max_to_keep are kept; no temporary directory is left behind."""
  t = _small_trainer(tmp_path, checkpoint_dir=None, training_method='momentum')
  t.train()
  mgr = CheckpointManager(str(tmp_path / 'c'), max_to_keep=2)
  for step in (1, 2, 3):
    assert mgr.save(step, t.state)
  assert not mgr.save(3, t.state, force=True)
  assert sorted(os.listdir(tmp_path / 'c')) == ['2', '3']
  arrays = torch.load(str(tmp_path / 'c' / '3' / 'state.pt'),
                      weights_only=True)
  params = list(t.state.params)
  want = ({f'params/{p}' for p in params}
          | {f'opt_state/{p}/momentum_buffer' for p in params}
          | {f'sparse/{k}/{p}' for k in ('masks', 'ema_grads')
             for p in t.state.sparse.masks}
          | {'sparse/step', 'sparse/last_update_step', 'sparse/is_snipped'})
  assert set(arrays) == want
  assert arrays['sparse/step'] == 4 and arrays['sparse/is_snipped'] is False


def test_checkpoint_adam_slots_roundtrip(tmp_path):
  t = _small_trainer(tmp_path, checkpoint_dir=None, optimizer='adam')
  t.train()
  mgr = CheckpointManager(str(tmp_path / 'c'))
  mgr.save(4, t.state)
  fresh = _small_trainer(tmp_path, checkpoint_dir=None,
                         optimizer='adam').init_state()
  restored = mgr.restore(fresh)
  for p, w in t.state.params.items():
    got = restored.optimizer.state[restored.params[p]]
    want = t.state.optimizer.state[w]
    assert set(got) == {'step', 'exp_avg', 'exp_avg_sq'}
    for k in got:
      assert torch.equal(got[k], want[k]), (p, k)
    assert got['step'].device.type == 'cpu' and float(got['step']) == 4


def test_mask_and_param_surgery(tmp_path):
  t = _small_trainer(tmp_path, checkpoint_dir=None, checkpoint_every=0)
  t.train()
  trained = t.state
  fresh = _small_trainer(tmp_path, checkpoint_dir=None, checkpoint_every=0,
                         seed=1).init_state()
  masks_only = restore_masks_only(fresh, trained)
  assert torch.equal(masks_only.sparse.masks['layer1/kernel'],
                     trained.sparse.masks['layer1/kernel'])
  assert masks_only.params['layer1/kernel'] is fresh.params['layer1/kernel']
  params_only = restore_params_only(fresh, trained)
  assert torch.equal(params_only.params['layer1/kernel'],
                     trained.params['layer1/kernel'])
  assert torch.equal(params_only.sparse.masks['layer1/kernel'],
                     fresh.sparse.masks['layer1/kernel'])


def test_shuffle_masks_preserves_sparsity():
  masks = {'a': torch.eye(8), 'b': torch.eye(8)}
  shuffled = shuffle_masks(0, masks)
  assert float(shuffled['a'].sum()) == 8.0
  assert not torch.equal(shuffled['a'], torch.eye(8))
  # Layer i draws from (key, i): the layers shuffle apart; the key decides.
  assert not torch.equal(shuffled['a'], shuffled['b'])
  assert torch.equal(shuffle_masks(0, masks)['a'], shuffled['a'])
  assert not torch.equal(shuffle_masks(1, masks)['a'], shuffled['a'])


def test_trainer_writes_metrics_and_ckpt(tmp_path):
  t = _small_trainer(tmp_path)
  t.train()
  recs = metrics.read_metrics(str(tmp_path / 'ckpt'))
  assert any('loss' in r for r in recs)
  assert os.path.isdir(str(tmp_path / 'ckpt'))


# ------------------------------------------------------------------ metrics --
def test_metrics_writer_roundtrip(tmp_path):
  w = metrics.MetricsWriter(str(tmp_path))
  w.write(1, {'loss': torch.tensor(2.5), 'note': 'x'})
  w.write(2, {'loss': 1.5})
  w.close()
  recs = metrics.read_metrics(str(tmp_path))
  assert len(recs) == 2
  assert recs[0]['loss'] == 2.5
  assert recs[0]['note'] == 'x'


def test_summaries_helpers():
  masks = {'a': torch.ones(4, 4), 'b': torch.zeros(4, 4)}
  s = metrics.sparsity_summaries(masks)
  assert s['global_sparsity'] == 0.5
  assert s['sparsity/b'] == 1.0
  n = metrics.norm_summaries({'w': torch.full((2, 2), 3.0)}, 'param')
  assert n['param_norm'] == pytest.approx(6.0)
  d = metrics.distance_to_init({'w': torch.ones(4)}, {'w': torch.zeros(4)})
  assert d['distance_to_init'] == pytest.approx(2.0)


def test_metrics_helpers_equal_jax():
  rs = np.random.RandomState(0)
  masks = {'a/kernel': (rs.rand(6, 5) < 0.3).astype(np.float32),
           'b/kernel': (rs.rand(3, 3, 4, 8) < 0.6).astype(np.float32)}
  tree = {'x': {'w': rs.randint(-4, 5, (3, 4)).astype(np.float32)},
          'b': rs.randint(-4, 5, (5,)).astype(np.float32)}
  init = {'x': {'w': rs.randint(-4, 5, (3, 4)).astype(np.float32)},
          'b': rs.randint(-4, 5, (5,)).astype(np.float32)}
  tt = lambda t: jax.tree.map(torch.tensor, t)
  jt = lambda t: jax.tree.map(jnp.asarray, t)
  assert metrics.sparsity_summaries(tt(masks)) == (
      jmetrics.sparsity_summaries(jt(masks)))
  assert metrics.norm_summaries(tt(tree), 'g') == (
      jmetrics.norm_summaries(jt(tree), 'g'))
  assert metrics.distance_to_init(tt(tree), tt(init)) == (
      jmetrics.distance_to_init(jt(tree), jt(init)))
  got, want = metrics.mask_images(tt(masks)), jmetrics.mask_images(masks)
  assert set(got) == set(want)
  for p in want:
    np.testing.assert_array_equal(got[p], want[p])
  logits = rs.randn(40, 5).astype(np.float32)
  labels = rs.randint(0, 5, 40).astype(np.int32)
  assert metrics.per_class_metrics(torch.tensor(logits),
                                   torch.tensor(labels), 5) == (
      jmetrics.per_class_metrics(jnp.asarray(logits), jnp.asarray(labels), 5))


def test_snr_summaries_equal_jax():
  rs = np.random.RandomState(1)
  params = {'w': rs.randn(4, 3).astype(np.float32),
            'b': rs.randn(3).astype(np.float32)}
  batch = {'x': rs.randn(16, 4).astype(np.float32),
           'y': rs.randint(0, 3, 16).astype(np.int32)}

  def jloss(p, b):
    logits = b['x'] @ p['w'] + p['b']
    return -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(logits),
                                         b['y'][:, None], 1))

  def tloss(p, b):
    logits = b['x'] @ p['w'] + p['b']
    return -torch.log_softmax(logits, -1).gather(
        1, b['y'][:, None].long()).mean()

  want = jmetrics.snr_summaries(jloss, jax.tree.map(jnp.asarray, params),
                                jax.tree.map(jnp.asarray, batch))
  got = metrics.snr_summaries(tloss, {k: torch.tensor(v)
                                      for k, v in params.items()},
                              {k: torch.tensor(v) for k, v in batch.items()})
  assert set(got) == set(want)
  for k in want:
    assert got[k] == pytest.approx(want[k], rel=SNR_RTOL), k


def test_profile_trace_writes_a_chrome_trace(tmp_path):
  with metrics.profile_trace(str(tmp_path / 'prof')):
    torch.ones(8).sum()
  with open(tmp_path / 'prof' / 'trace.json') as f:
    assert 'traceEvents' in json.load(f)
  with metrics.profile_trace(None):
    pass
  timer = metrics.StepTimer(32)
  out = timer.update(4)
  assert out['examples_per_sec'] == pytest.approx(32 * out['steps_per_sec'])


def test_mask_images(tmp_path):
  masks = {'a/kernel': torch.tensor([[1., 0.], [0., 1.]]),
           'b/kernel': torch.ones(2, 3, 4, 8)}
  imgs = metrics.mask_images(masks)
  assert imgs['a/kernel'].shape == (2, 2)
  assert imgs['a/kernel'].dtype == np.uint8
  assert set(np.unique(imgs['a/kernel'])) == {0, 255}
  assert imgs['b/kernel'].shape == (24, 8)
  path = metrics.write_mask_images(str(tmp_path), 7, masks)
  loaded = np.load(path)
  np.testing.assert_array_equal(loaded['a__kernel'], imgs['a/kernel'])


def test_trainer_mask_image_every(tmp_path):
  import glob as glob_mod
  cfg = TrainConfig(model='mnist_mlp', dataset='mnist', batch_size=32,
                    train_steps=4, training_method='set', sparsity=0.5,
                    maskupdate_frequency=2, n_synthetic=128, log_every=0,
                    checkpoint_dir=str(tmp_path / 'run'), mask_image_every=2)
  Trainer(cfg, device='cpu').train()
  files = glob_mod.glob(str(tmp_path / 'run' / 'mask_images' / '*.npz'))
  assert len(files) == 2, files


# ------------------------------------------------------------ the eval loop --
def test_eval_loop_eval_once(tmp_path):
  from rigl_tpu_torch.train.eval_loop import evaluate_checkpoints
  t = _small_trainer(tmp_path)
  t.train()
  t2 = _small_trainer(tmp_path)
  results = evaluate_checkpoints(t2, str(tmp_path / 'ckpt'), eval_once=True)
  assert len(results) == 1
  assert results[0]['step'] == 4
  want = t.evaluate(t.state)
  assert {k: results[0][k] for k in want} == want


def test_eval_loop_missing_dir_raises(tmp_path):
  from rigl_tpu_torch.train.eval_loop import evaluate_checkpoints
  t = _small_trainer(tmp_path, checkpoint_dir=None, checkpoint_every=0)
  with pytest.raises(FileNotFoundError):
    evaluate_checkpoints(t, str(tmp_path / 'nope'), eval_once=True,
                         timeout_seconds=2.0)


def test_eval_loop_polls_and_skips_a_deleted_checkpoint(tmp_path,
                                                        monkeypatch):
  """A checkpoint deleted between the poll and its restore is skipped;
  later steps are evaluated as they appear, up to max_evals."""
  import shutil
  from rigl_tpu_torch.train import eval_loop
  t = _small_trainer(tmp_path, train_steps=6)
  t.train()
  ckpt = str(tmp_path / 'ckpt')
  shown = iter([6, 2, 4, 4, 6])
  real_latest = CheckpointManager.latest_step

  def latest(self):
    step = next(shown, None)
    if step == 2:
      shutil.rmtree(os.path.join(ckpt, '2'))
    return step if step is not None else real_latest(self)
  monkeypatch.setattr(CheckpointManager, 'latest_step', latest)
  results = eval_loop.evaluate_checkpoints(
      _small_trainer(tmp_path, train_steps=6), ckpt, poll_seconds=0.01,
      timeout_seconds=5.0, max_evals=2)
  assert [r['step'] for r in results] == [6, 4]


# ------------------------------------------------------------------ export --
def test_export_and_load_for_inference(tmp_path):
  from rigl_tpu_torch.sparsity import masks as masks_lib
  from rigl_tpu_torch.train.export import export_model, load_for_inference
  t = _small_trainer(tmp_path, checkpoint_dir=None, checkpoint_every=0)
  t.train()
  state = t.state
  d = export_model(str(tmp_path / 'export'), 'mnist_mlp', {},
                   state.params, state.sparse.masks, state.batch_stats)
  apply_fn, manifest = load_for_inference(d, device='cpu')
  assert manifest['global_sparsity'] == pytest.approx(0.5, abs=0.05)
  x = torch.zeros(2, 28, 28, 1)
  logits = apply_fn(x)
  assert logits.shape == (2, 10)
  eff = masks_lib.apply_masks(state.params, state.sparse.masks)
  ref = torch.func.functional_call(
      t.model, {masks_lib.torch_name(p): v for p, v in eff.items()}, (x,),
      {'train': False})
  torch.testing.assert_close(logits, ref, rtol=1e-6, atol=0)
  if not torch.cuda.is_available():
    with pytest.raises(RuntimeError, match='CUDA'):
      load_for_inference(d)


def test_export_equals_jax_export(tmp_path):
  """The same state exported by both packages: the manifests equal, and
  the port's npz holds JAX's msgpack arrays (effective params, batch
  stats, masks) by path."""
  from rigl_tpu_torch.train.export import export_model
  kw = dict(model='lenet5', dataset='mnist', batch_size=16, train_steps=2,
            training_method='set', sparsity=0.6, n_synthetic=64,
            model_kwargs={'use_batch_norm': True}, log_every=0)
  jt = jtr.Trainer(jtr.TrainConfig(**kw))
  jt.init_state()
  jstate = _np_state(jt.state)
  tt = Trainer(TrainConfig(**kw), device='cpu')
  state = convert.trainer_state_from_jax(tt, jstate)
  mkw = {'use_batch_norm': True, 'hidden_sizes': [6, 16, 120, 84],
         'dtype': 'f32', 'shape': (1, 2)}
  jdir = jexport.export_model(str(tmp_path / 'j'), 'lenet5', mkw,
                              jt.state.params, jt.state.sparse.masks,
                              jt.state.batch_stats)
  tdir = export_model(str(tmp_path / 't'), 'lenet5', mkw, state.params,
                      state.sparse.masks, state.batch_stats)
  with open(os.path.join(jdir, 'manifest.json')) as f:
    jman = json.load(f)
  with open(os.path.join(tdir, 'manifest.json')) as f:
    tman = json.load(f)
  assert tman == jman
  with open(os.path.join(jdir, 'model.msgpack'), 'rb') as f:
    payload = flax.serialization.msgpack_restore(f.read())
  with np.load(os.path.join(tdir, 'model.npz')) as z:
    got = {k: z[k] for k in z.files}
  want = {f'params/{p}': v for p, v in convert._paths(payload['params']).items()}
  want.update({f'batch_stats/{p}': v for p, v in
               convert._paths(payload['batch_stats']).items()})
  want.update({f'masks/{p}': np.asarray(v)
               for p, v in payload['masks'].items()})
  assert set(got) == set(want)
  for k, v in want.items():
    np.testing.assert_array_equal(got[k], v, k)


# ------------------------------------------------------ carrying state over --
@pytest.mark.parametrize('optimizer', ['adam', 'sgd'])
def test_train_state_from_jax_slots(optimizer):
  """Adam's mu, nu and count become exp_avg, exp_avg_sq and step; SGD
  without momentum has no slot in either package."""
  import functools
  from rigl_tpu_torch.models.mlp import MnistMLP
  from rigl_tpu_torch.transforms import algorithms
  from rigl_tpu_torch.transforms.sparse_training import SparseTraining
  kw = dict(model='mnist_mlp', dataset='mnist', batch_size=16, train_steps=3,
            training_method='set', sparsity=0.5, n_synthetic=64,
            optimizer=optimizer, log_every=0)
  jt = jtr.Trainer(jtr.TrainConfig(**kw))
  jt.init_state()
  jt.train()
  arrays = convert._jax_state_arrays(_np_state(jt.state))
  model = MnistMLP(device='cpu')
  tx = (functools.partial(torch.optim.Adam, lr=1e-3) if optimizer == 'adam'
        else functools.partial(torch.optim.SGD, lr=0.1))
  st = SparseTraining(tx, algorithms.get_algorithm('set'),
                      default_sparsity=0.5)
  state = convert.train_state_from_jax(model, st, arrays)
  assert state.sparse.step == 3
  if optimizer == 'sgd':
    assert 'momentum' not in arrays and 'mu' not in arrays
    assert all(not state.optimizer.state[t] for t in state.params.values())
    return
  opt = jt.state.opt_state[0]
  mu, nu = convert._paths(opt.mu), convert._paths(opt.nu)
  for p, t in state.params.items():
    slots = state.optimizer.state[t]
    np.testing.assert_array_equal(slots['exp_avg'].numpy(), mu[p])
    np.testing.assert_array_equal(slots['exp_avg_sq'].numpy(), nu[p])
    assert float(slots['step']) == int(opt.count) == 3
    assert slots['step'].device.type == 'cpu'


def test_trainer_state_from_jax_carries_everything():
  """A JAX Trainer's state (SNFS with block masks: EMA grads, momentum,
  counters) into the port's Trainer: every array equal, the params the
  model's own, the block packs rebuilt from the masks."""
  kw = dict(model='mnist_mlp', dataset='mnist', batch_size=16, train_steps=3,
            training_method='momentum', sparsity=0.5, n_synthetic=64,
            block_width=4, block_height=4, maskupdate_frequency=2,
            log_every=0)
  jt = jtr.Trainer(jtr.TrainConfig(**kw))
  jt.init_state()
  jt.train()
  jstate = _np_state(jt.state)
  tt = Trainer(TrainConfig(**kw), device='cpu')
  state = convert.trainer_state_from_jax(tt, jstate)
  assert state.sparse.step == 3 and state.sparse.last_update_step >= 0
  assert state.sparse.initial_weights is None
  assert state is tt.state
  own = dict(tt.model.named_parameters())
  jparams = convert._paths(jstate.params)
  trace = convert._paths(jstate.opt_state[0].trace)
  for p, t in state.params.items():
    assert t is own[p.replace('/', '.')]
    np.testing.assert_array_equal(t.detach().numpy(), jparams[p])
    np.testing.assert_array_equal(
        state.optimizer.state[t]['momentum_buffer'].numpy(), trace[p])
  sp = jstate.sparse
  assert (state.sparse.step, state.sparse.last_update_step,
          state.sparse.is_snipped) == (int(sp.step), int(sp.last_update_step),
                                       bool(sp.is_snipped))
  for name in ('masks', 'ema_grads'):
    for p, v in getattr(sp, name).items():
      np.testing.assert_array_equal(
          getattr(state.sparse, name)[p].numpy(), v, f'{name} {p}')
  packs = state.sparse.block_packs
  want = tt.sparse_training._compute_packs(state.sparse.masks)
  assert set(packs) == set(want) and packs
  for p in want:
    assert torch.equal(packs[p], want[p]), p
  # The initial weights of grow_init='initial_dist', from an initial state.
  kw.update(training_method='set', grow_init='initial_dist')
  jt = jtr.Trainer(jtr.TrainConfig(**kw))
  jstate = _np_state(jt.init_state())
  tt = Trainer(TrainConfig(**kw), device='cpu')
  state = convert.trainer_state_from_jax(tt, jstate)
  assert set(state.sparse.initial_weights) == set(
      jstate.sparse.initial_weights)
  for p, v in jstate.sparse.initial_weights.items():
    np.testing.assert_array_equal(state.sparse.initial_weights[p].numpy(), v)
