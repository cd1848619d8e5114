"""Port parity: conv-net training on packed storage in rigl_tpu_torch
(train/packed_classifier.py, the converter, checkpoints and
drivers/packed_conv.py) against the JAX package's PackedClassifierTrainer,
on a WRN-10-1 whose stride-1 3x3 convs run the tap engine, at 8x8x3
inputs.

A JAX trainer is initialised and converted, then both run side by side on
the same seeded batches.  Counters and occupancies must be equal at every
step, so every mask update agrees.  Losses agree within 1e-5 relative;
parameters, momentum traces and SNFS's EMA grids within 1e-5 of each
tensor's largest JAX value (SGD with nesterov momentum adds the gradients,
which differ by f32 summation order only).  SET's grow scores come from
JAX's keys on both sides (torch cannot give JAX's bits).  JAX's tap
kernels run in interpret mode on the CPU, as its own tests run them; the
port runs its plain versions.  The JAX trainers share their jitted step,
and those of one algorithm their jitted update (same model, optimizer and
shapes), so each compiles once per module."""

import dataclasses
import json

import flax.traverse_util as traverse
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rigl_tpu.data import datasets as jdata
from rigl_tpu.models import packed_convnet as jm
from rigl_tpu.train import packed_classifier as jpc
from rigl_tpu.transforms import packed_training as jpt
from rigl_tpu_torch import convert
from rigl_tpu_torch.data import datasets as tdata
from rigl_tpu_torch.drivers import packed_conv as tdriver
from rigl_tpu_torch.models import packed_convnet as tm
from rigl_tpu_torch.train import packed_classifier as tpc
from rigl_tpu_torch.transforms import packed_training as tpt
from torch_threads import one_thread  # noqa: F401


CFG = dict(sparsity=0.5, block=(16, 16), learning_rate=0.05, momentum=0.9,
           batch_size=8, maskupdate_begin_step=0, maskupdate_end_step=6,
           maskupdate_frequency=3, drop_fraction=0.3, seed=0)
WRN = dict(depth=10, width=1, num_classes=10, sparsity=0.5, engine='tap')
SHAPE = (8, 8, 3)
STEPS = 7
RTOL = 1e-5


def _dotted(tree):
  return {'.'.join(p): np.asarray(v)
          for p, v in traverse.flatten_dict(tree).items()}


def _jax_state(jtr):
  occ = {'.'.join(p): np.asarray(jpt.occupancy_grid(pk))
         for p, pk in traverse.flatten_dict(jtr.packings).items()}
  state = dict(params=_dotted(jtr.params), occupancy=occ,
               momentum=_dotted(jtr.opt_state[0].trace), step=jtr.step,
               last_update_step=jtr.last_update_step,
               batches_seen=jtr.batches_seen)
  if jtr.ema_grids is not None:
    state['ema'] = {'.'.join(p): np.asarray(v)
                    for p, v in jtr.ema_grids.items()}
  return state


def _close(got, want, rtol, what):
  got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
  assert got.shape == want.shape, what
  err = np.abs(got - want).max(initial=0.0)
  assert err <= rtol * max(np.abs(want).max(initial=0.0), 1e-30), (what, err)


def _assert_same_state(jtr, ttr, rtol, what):
  want = _jax_state(jtr)
  assert (ttr.step, ttr.last_update_step, ttr.batches_seen) == (
      want['step'], want['last_update_step'], want['batches_seen']), what
  for name, pk in ttr.packings.items():
    np.testing.assert_array_equal(tpt.occupancy_grid(pk).numpy(),
                                  want['occupancy'][name],
                                  f'{what}: occupancy {name}')
  params, mom = ttr.params, ttr.momentum()
  assert set(params) == set(want['params'])
  for name, p in params.items():
    _close(p.detach().numpy(), want['params'][name], rtol, f'{what}: {name}')
    _close(mom[name].numpy(), want['momentum'][name], rtol,
           f'{what}: momentum {name}')
  if 'ema' in want:
    for name, g in ttr.ema_grids.items():
      _close(g.numpy(), want['ema'][name], rtol, f'{what}: ema {name}')


@pytest.fixture(scope='module')
def variables():
  return jax.jit(jm.PackedWideResNet(**WRN).init)(
      jax.random.key(CFG['seed']), jnp.zeros((1,) + SHAPE, jnp.float32))


@pytest.fixture(scope='module')
def data():
  tx, ty, _, _ = jdata.synthetic_arrays(10, SHAPE, n_train=256, n_test=64,
                                        seed=1)
  return jdata.normalize('cifar10', tx), ty


_JITS = {}


def _share_jits(jtr):
  """Gives `jtr` the jitted step of the first JAX trainer and the jitted
  update of the first of its algorithm (making them if needed), so no
  later trainer compiles again."""
  jtr._jit_step = _JITS.setdefault('step', jtr._make_jit_step())
  jtr._jit_update = _JITS.setdefault(jtr.cfg.algo, jtr._make_jit_update())


def _jax_trainer(variables, **over):
  """A JAX trainer in init_state's state, from the shared variables."""
  cfg = jpc.PackedClassifierConfig(**dict(CFG, **dict(dict(train_steps=STEPS),
                                                      **over)))
  jtr = jpc.PackedClassifierTrainer(
      jm.PackedWideResNet(**WRN),
      jm.DenseWideResNetTwin(**{k: WRN[k] for k in ('depth', 'width',
                                                    'num_classes')}),
      cfg, SHAPE)
  jtr.params, jtr.packings = variables['params'], variables['packing']
  jtr.opt_state = jtr.tx.init(jtr.params)
  if cfg.algo == 'snfs':
    jtr.ema_grids = jpt.init_snfs_ema_grids(jtr.packings)
  _share_jits(jtr)
  return jtr


def _port_models():
  twin_kw = {k: WRN[k] for k in ('depth', 'width', 'num_classes')}
  return (tm.PackedWideResNet(device='cpu', **WRN),
          tm.DenseWideResNetTwin(device='meta', **twin_kw))


def _pair(variables, **over):
  jtr = _jax_trainer(variables, **over)
  model, twin = _port_models()
  state, packs = convert.from_jax_variables(jax.tree.map(np.asarray,
                                                         variables))
  convert.load_converted(model, state, packs)
  ttr = convert.packed_classifier_trainer_from_jax(
      dataclasses.asdict(jtr.cfg), _jax_state(jtr), model, twin, SHAPE)
  assert ttr.device.type == 'cpu'
  return jtr, ttr


def _jax_set_grids(jtr, ttr):
  """The port's SET grow grids replaced by JAX's draws at the port's
  step (fold_in(key(seed), step), one fold per layer in path order)."""
  def grids(packings, generator=None):
    key = jax.random.fold_in(jax.random.key(jtr.cfg.seed), ttr.step)
    drawn = jpt.flax_set_grow_grids(jtr.packings, key)
    out = {'.'.join(p): torch.tensor(np.asarray(v)) for p, v in drawn.items()}
    assert set(out) == set(packings)
    return out
  return grids


@pytest.mark.parametrize('algo', ['rigl', 'set', 'snfs'])
def test_trainer_matches_jax_step_for_step(algo, variables, data,
                                          monkeypatch):
  """7 steps with mask updates at steps 0, 3 and 6 (RigL's replace a
  step) or after steps 3 and 6 (SET's and SNFS's follow one): per-step
  losses, counters, occupancies, parameters, momentum and (SNFS) the EMA
  grids.  Right after each update every kernel keeps its active count,
  and its grown blocks hold zero weights and zero momentum."""
  jtr, ttr = _pair(variables, algo=algo)
  if algo == 'set':
    monkeypatch.setattr(tpt, 'flax_set_grow_grids', _jax_set_grids(jtr, ttr))
  _assert_same_state(jtr, ttr, 0.0, 'converted')
  grown = []
  mask_update = ttr.mask_update

  def checked_update(x, y):
    old = ttr.packings
    occ = mask_update(x, y)
    mom = ttr.momentum()
    n_grown = 0
    for name, pk in ttr.packings.items():
      assert occ[name].sum() == ttr.params[name].shape[0], name
      new = tpt.repack_permutation(old[name], pk) < 0
      n_grown += int(new.sum())
      for t in (ttr.params[name].detach(), mom[name]):
        assert not t[new].any(), name
    grown.append(n_grown)
    return occ

  ttr.mask_update = checked_update
  for k in range(1, STEPS + 1):
    jtr.cfg.train_steps = ttr.cfg.train_steps = k
    jres, tres = jtr.train(data), ttr.train(data)
    assert tres['mask_updates'] == jres['mask_updates'], k
    _close(tres['final_loss'], jres['final_loss'], RTOL, f'step {k} loss')
    _assert_same_state(jtr, ttr, RTOL, f'step {k}')
  assert len(grown) == (3 if algo == 'rigl' else 2) and sum(grown) > 0
  for key in ('n_params_packed', 'n_params_dense_equiv'):
    assert tres[key] == jres[key], key
  if algo == 'rigl':   # one JAX evaluate: each call compiles its forward
    x, y = data
    assert ttr.evaluate(x[:40], y[:40]) == jtr.evaluate(x[:40], y[:40])


def test_rigl_consumes_a_batch_per_update(data):
  """RigL's update replaces the step: batches == steps + updates; SET and
  SNFS update after a step on its batch."""
  for algo, extra in (('rigl', 3), ('set', 0), ('snfs', 0)):
    model, twin = _port_models()
    tr = tpc.PackedClassifierTrainer(
        model, twin, tpc.PackedClassifierConfig(
            **dict(CFG, algo=algo, train_steps=8)), SHAPE)
    res = tr.train(data)
    assert res['train_steps'] == 8
    assert res['mask_updates'] == (3 if algo == 'rigl' else 2)
    assert res['batches'] == 8 + extra, algo
    assert np.isfinite(res['final_loss'])


@pytest.mark.parametrize('direction', ['jax_to_port', 'port_to_jax'])
def test_checkpoint_round_trip(direction, variables, data, tmp_path):
  """packed_classifier_state.npz written by one package after 4 steps
  (SNFS, an update after step 3) restores exactly into the other, which
  then trains on as the writer does (an update after step 6)."""
  jtr, ttr = _pair(variables, train_steps=4, algo='snfs')
  jtr.train(data)
  ttr.train(data)
  _assert_same_state(jtr, ttr, RTOL, 'before the checkpoint')
  if direction == 'jax_to_port':
    jtr.save(str(tmp_path))
    model, twin = _port_models()
    reader = tpc.PackedClassifierTrainer(
        model, twin, tpc.PackedClassifierConfig(
            **dict(CFG, algo='snfs', train_steps=4)), SHAPE)
    assert reader.restore(str(tmp_path))
    _assert_same_state(jtr, reader, 0.0, 'restored')
    ttr = reader
  else:
    ttr.save(str(tmp_path))
    reader = _jax_trainer(variables, algo='snfs')
    assert reader.restore(str(tmp_path))
    _share_jits(reader)
    _assert_same_state(reader, ttr, 0.0, 'restored')
    jtr = reader
  for k in (5, 6, 7):
    jtr.cfg.train_steps = ttr.cfg.train_steps = k
    _close(ttr.train(data)['final_loss'], jtr.train(data)['final_loss'],
           RTOL, f'step {k} loss')
    _assert_same_state(jtr, ttr, RTOL, f'step {k}')
  model, twin = _port_models()
  assert not tpc.PackedClassifierTrainer(
      model, twin, tpc.PackedClassifierConfig(**CFG), SHAPE).restore(
          str(tmp_path / 'no'))


def test_config_checks():
  model, twin = _port_models()
  cfg = tpc.PackedClassifierConfig(**CFG)
  for over, err in ((dict(algo='prune'), ValueError),
                    (dict(n_data=2), NotImplementedError),
                    (dict(n_model=2), NotImplementedError)):
    with pytest.raises(err):
      tpc.PackedClassifierTrainer(model, twin,
                                  dataclasses.replace(cfg, **over), SHAPE)
  with pytest.raises(NotImplementedError):
    tpc.PackedClassifierTrainer(model, twin, cfg, SHAPE, model_sharded=model)
  assert {f.name for f in dataclasses.fields(tpc.PackedClassifierConfig)} == {
      f.name for f in dataclasses.fields(jpc.PackedClassifierConfig)}
  assert dataclasses.asdict(tpc.PackedClassifierConfig()) == (
      dataclasses.asdict(jpc.PackedClassifierConfig()))


def test_cifar10_arrays_match_jax(tmp_path):
  """The binary and pickle parsers, per-image standardization, and the
  datasets drivers/packed_conv.py builds (raw uint8 training images,
  standardized eval images), against JAX's."""
  import pickle
  rs = np.random.RandomState(0)
  bin_dir = tmp_path / 'cifar-10-batches-bin'
  py_dir = tmp_path / 'py' / 'cifar-10-batches-py'
  bin_dir.mkdir()
  py_dir.mkdir(parents=True)
  for name in [f'data_batch_{i}' for i in range(1, 6)] + ['test_batch']:
    labels = rs.randint(0, 10, 7).astype(np.uint8)
    pixels = rs.randint(0, 256, (7, 3072)).astype(np.uint8)
    np.concatenate([labels[:, None], pixels], 1).tofile(bin_dir / f'{name}.bin')
    with open(py_dir / name, 'wb') as f:
      pickle.dump({b'data': pixels, b'labels': labels.tolist()}, f)
  for root in (tmp_path, tmp_path / 'py'):
    got = tdata.load_cifar10_arrays(str(root))
    want = jdata.load_cifar10_arrays(str(root))
    assert got[0].shape == (35, 32, 32, 3) and got[0].dtype == np.uint8
    for g, w in zip(got, want):
      np.testing.assert_array_equal(g, w)
  assert tdata.load_cifar10_arrays(str(tmp_path / 'nothing')) is None
  for data_dir in (str(tmp_path), None):
    got = tdata.create_dataset('cifar10', 4, data_dir=data_dir, seed=3)
    want = jdata.create_dataset('cifar10', 4, data_dir=data_dir, seed=3)
    assert got[2] == want[2]
    np.testing.assert_array_equal(got[0].images, want[0].images)
    assert got[0].images.dtype == np.uint8
    np.testing.assert_allclose(got[1].images, want[1].images, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(got[1].labels, want[1].labels)


@pytest.mark.parametrize('arch,extra', [
    ('wrn', ['--wrn_depth=10', '--wrn_width=1', '--dataset=cifar10']),
    ('mobilenet', ['--stem_width=16', '--conv_stages=32:2,32:1',
                   '--training_method=momentum', '--dataset=mnist'])])
def test_driver_on_cpu(arch, extra, tmp_path, capsys):
  args = ['--device=cpu', f'--arch={arch}', '--train_steps=4',
          '--batch_size=64', '--maskupdate_frequency=2',
          '--maskupdate_end_step=3', '--log_every=2',
          f'--output_dir={tmp_path}'] + extra
  res = tdriver.main(args)
  assert res['train_steps'] == 4 and res['mask_updates'] == 2
  # RigL (wrn) consumes a batch per update; SNFS (mobilenet) does not.
  assert res['batches'] == 4 + (2 if arch == 'wrn' else 0)
  assert res['data_source'] == 'synthetic' and res['device'] == 'cpu'
  assert 0.0 <= res['eval_top_1'] <= 1.0
  assert res['n_params_packed'] < res['n_params_dense_equiv']
  assert (tmp_path / 'packed_classifier_state.npz').exists()
  assert json.loads((tmp_path / 'result.json').read_text())['train_steps'] == 4
  res = tdriver.main(args[:2] + ['--train_steps=6'] + args[3:])
  assert '# resumed at step 4' in capsys.readouterr().out
  assert res['train_steps'] == 6
  for bad in ('--training_method=prune', '--conv_n_data=2', '--arch=vgg'):
    with pytest.raises((ValueError, NotImplementedError)):
      tdriver.main(['--device=cpu', '--train_steps=1', bad])
