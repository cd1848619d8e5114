"""The port's drivers (rigl_tpu_torch/drivers/{common,mnist,cifar,imagenet,
train}.py) on the CPU (--device=cpu, the kernels' plain versions).

* Each driver's parser has the JAX driver's absl flags, names and
  defaults, plus --device; the same command line gives equal TrainConfigs
  in both packages.  absl's registry is global, so a subprocess imports
  the JAX drivers one at a time and reports their flags and configs.
* Twins of tests/test_real_data_drivers.py's real-format runs on files the
  tests write: MNIST idx, CIFAR-10 binary batches, ImageNet TFRecords
  (TensorFlow needed).
* Twins of tests/test_research_presets.py's MLP matrix: the inventory, the
  seven mlp_*.json presets (the lottery one from a donor run) and the
  LeNet lottery load, through drivers.train.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rigl_tpu_torch.drivers import cifar, common, imagenet, mnist
from rigl_tpu_torch.drivers import train as train_driver
from torch_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, 'configs')
MLP_PRESETS = sorted(p for p in os.listdir(CONFIGS)
                     if p.startswith('mlp_') and p.endswith('.json'))
SMOKE = ['train_steps=6', 'batch_size=16', 'n_synthetic=64', 'log_every=0',
         'maskupdate_frequency=2', 'maskupdate_begin_step=2',
         'maskupdate_end_step=4', 'eval_every=0']

DRIVERS = {'mnist': mnist, 'cifar': cifar, 'imagenet': imagenet,
           'train': train_driver}
# Command lines each driver is given in both packages.
ARGVS = {
    'mnist': [[], ['--training_method=set', '--end_sparsity=0.8',
                   '--sparsity_scale=0.5', '--batch_size=16',
                   '--learning_rate=0.05', '--drop_fraction_anneal=constant',
                   '--maskupdate_end_step=-1', '--output_dir=/tmp/x']],
    'cifar': [[], ['--training_method=snip', '--resnet_depth=10',
                   '--resnet_width=1', '--weight_decay=0.0',
                   '--seed=3', '--eval_every=5', '--data_dir=/d']],
    'imagenet': [[], ['--model_architecture=resnet', '--resnet_depth=18',
                      '--width=0.5', '--prune_first_layer',
                      '--noprune_last_layer', '--first_layer_sparsity=0.3',
                      '--label_smoothing=0.0'],
                 ['--model_architecture=mobilenet_v1', '--width=0.25',
                  '--training_steps_multiplier=2.0'],
                 ['--model_architecture=vgg_a', '--end_sparsity=0.9']],
    'train': [[f'--config={CONFIGS}/mlp_rigl.json',
               '--override=train_steps=5', "--override=lr_schedule='sgdr'",
               '--override=model_kwargs={"features": [8, 8]}',
               '--output_dir=/tmp/run']],
}

_JAX_SIDE = r'''
import dataclasses, importlib, json, sys
from absl import flags
import jax.numpy as jnp
import rigl_tpu.drivers.common as common
import rigl_tpu.train.trainer as trainer_lib
FLAGS = flags.FLAGS
base = set(FLAGS)
argvs = json.loads(sys.argv[1])
captured = []

class Stub:
  def __init__(self, cfg):
    captured.append(cfg)
    self.train = lambda **kw: {}

trainer_lib.Trainer = Stub
common.run_and_report = lambda trainer, output_dir=None: {}
out = {}
for name, lines in argvs.items():
  for f in list(FLAGS):
    if f not in base:
      delattr(FLAGS, f)
  mod = importlib.import_module(f'rigl_tpu.drivers.{name}')
  if hasattr(mod, 'Trainer'):
    mod.Trainer = Stub
  defaults = {f: FLAGS[f].default for f in FLAGS if f not in base}
  configs = []
  for argv in lines:
    FLAGS.unparse_flags()
    FLAGS(['prog'] + argv)
    del captured[:]
    mod.main([])
    cfg = dataclasses.asdict(captured[0])
    if 'dtype' in cfg['model_kwargs']:
      cfg['model_kwargs']['dtype'] = jnp.dtype(
          cfg['model_kwargs']['dtype']).name
    configs.append(cfg)
  out[name] = {'defaults': defaults, 'configs': configs}
print(json.dumps(out))
'''


@pytest.fixture(scope='module')
def jax_flags():
  """The JAX drivers' absl flag defaults and the TrainConfig each of
  ARGVS gives, from one subprocess."""
  env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS='cpu')
  proc = subprocess.run([sys.executable, '-c', _JAX_SIDE, json.dumps(ARGVS)],
                        capture_output=True, text=True, env=env, cwd=REPO,
                        timeout=600, check=False)
  assert proc.returncode == 0, proc.stderr[-3000:]
  return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize('name', list(DRIVERS))
def test_driver_flags_equal_jax(jax_flags, name):
  got = vars(DRIVERS[name].build_parser().parse_args([]))
  assert got.pop('device') == 'cuda'
  assert got == jax_flags[name]['defaults']


@pytest.mark.parametrize('name', list(DRIVERS))
def test_config_from_flags_equals_jax(jax_flags, name, monkeypatch):
  from rigl_tpu_torch.train import trainer as trainer_lib
  captured = []

  class Stub:
    def __init__(self, cfg, device='cuda'):
      assert device == 'cpu'
      captured.append(cfg)

  monkeypatch.setattr(trainer_lib, 'Trainer', Stub)
  for argv, want in zip(ARGVS[name], jax_flags[name]['configs']):
    captured.clear()
    DRIVERS[name].build_trainer(argv + ['--device=cpu'])
    cfg = dataclasses.asdict(captured[0])
    dtype = cfg['model_kwargs'].get('dtype')
    if dtype is not None:
      cfg['model_kwargs']['dtype'] = str(dtype).replace('torch.', '')
    assert cfg == json.loads(json.dumps(want)), argv


def test_parsers_take_absl_forms():
  args = imagenet.build_parser().parse_args(
      ['--prune_first_layer=false', '--noprune_last_layer',
       '--n_model_shards=2'])
  assert (args.prune_first_layer, args.prune_last_layer) == (False, False)
  args = mnist.build_parser().parse_args(['--record_masks'])
  assert args.record_masks is True
  with pytest.raises(SystemExit):
    train_driver.build_trainer(['--device=cpu'])   # --config is required
  with pytest.raises(NotImplementedError, match='Slice 10'):
    imagenet.build_trainer(['--device=cpu', '--n_model_shards=2'])
  p = common.make_parser('x')
  common.define_block_flags(p)
  common.define_surgery_flags(p)
  args = p.parse_args(['--block_execution', '--block_width=8',
                       '--shuffle_loaded_masks=1'])
  assert (args.block_execution, args.block_conv3x3, args.block_width,
          args.shuffle_loaded_masks, args.init_masks_from) == (
              True, False, 8, True, None)


def test_mnist_driver_records_masks(tmp_path):
  out = tmp_path / 'out'
  result = mnist.main(['--device=cpu', '--train_steps=4', '--batch_size=16',
                       '--maskupdate_frequency=2', '--log_every=2',
                       '--record_masks', f'--output_dir={out}'])
  assert np.isfinite(result['eval_loss'])
  records = np.load(out / 'mask_records.npy', allow_pickle=True)
  assert len(records) == 3 and 'layer1/kernel' in records[0]  # 3 logs
  cfg = json.loads((out / 'config.json').read_text())
  assert cfg['lr_schedule'] == 'mnist' and cfg['checkpoint_dir'] == str(out)
  assert json.loads((out / 'results.json').read_text())['batches'] == (
      result['batches'])


# ------------------------------------------------------ real-format files --
def _write_idx(path, arr):
  """MNIST idx format (big-endian dims, uint8 payload)."""
  import struct
  arr = np.ascontiguousarray(arr, np.uint8)
  with open(path, 'wb') as f:
    f.write(bytes([0, 0, 8, arr.ndim]))
    f.write(struct.pack('>' + 'I' * arr.ndim, *arr.shape))
    f.write(arr.tobytes())


def _learnable_uint8(num_classes, shape, n_train, n_test):
  from rigl_tpu_torch.data.datasets import synthetic_arrays
  tx, ty, vx, vy = synthetic_arrays(num_classes, shape, n_train=n_train,
                                    n_test=n_test, seed=0)

  def q(x):
    lo, hi = x.min(), x.max()
    return np.clip((x - lo) / max(hi - lo, 1e-6) * 255, 0, 255
                   ).astype(np.uint8)

  return q(tx), ty, q(vx), vy


def test_mnist_driver_on_idx_files(tmp_path):
  tx, ty, vx, vy = _learnable_uint8(10, (28, 28, 1), 512, 128)
  _write_idx(tmp_path / 'train-images-idx3-ubyte', tx[..., 0])
  _write_idx(tmp_path / 'train-labels-idx1-ubyte', ty.astype(np.uint8))
  _write_idx(tmp_path / 't10k-images-idx3-ubyte', vx[..., 0])
  _write_idx(tmp_path / 't10k-labels-idx1-ubyte', vy.astype(np.uint8))
  trainer, args = mnist.build_trainer([
      '--device=cpu', f'--data_dir={tmp_path}', '--batch_size=48',
      '--train_steps=60', '--training_method=rigl', '--end_sparsity=0.9',
      '--sparsity_scale=0.9', '--maskupdate_frequency=20',
      '--drop_fraction=0.3', '--drop_fraction_anneal=constant',
      '--maskupdate_end_step=25000', '--learning_rate=0.2', '--log_every=0'])
  assert trainer.data_info['source'] == 'files'
  assert trainer.data_info['num_train'] == 512
  result = common.run_and_report(trainer, args.output_dir)
  assert result['eval_top_1'] > 0.5, result


def test_cifar_driver_on_binary_batches(tmp_path):
  tx, ty, vx, vy = _learnable_uint8(10, (32, 32, 3), 500, 100)
  bin_dir = tmp_path / 'cifar-10-batches-bin'
  bin_dir.mkdir()
  per = len(tx) // 5
  rows = lambda xs, ys: np.stack([
      np.concatenate([[np.uint8(y)], x.transpose(2, 0, 1).reshape(-1)])
      for x, y in zip(xs, ys)]).astype(np.uint8)
  for i in range(5):
    sl = slice(i * per, (i + 1) * per)
    rows(tx[sl], ty[sl]).tofile(bin_dir / f'data_batch_{i + 1}.bin')
  rows(vx, vy).tofile(bin_dir / 'test_batch.bin')
  trainer, out = cifar.build_trainer([
      '--device=cpu', f'--data_dir={tmp_path}', '--resnet_depth=10',
      '--resnet_width=1', '--batch_size=32', '--train_steps=8',
      '--training_method=set', '--end_sparsity=0.5',
      '--maskupdate_frequency=4', '--log_every=0'])
  assert trainer.data_info['source'] == 'files'
  assert trainer.data_info['num_train'] == 500
  result = common.run_and_report(trainer, out)
  assert np.isfinite(result['eval_loss'])
  assert result['global_sparsity'] == pytest.approx(0.5, abs=0.05)


def test_imagenet_trainer_on_tfrecords(tmp_path):
  tf = pytest.importorskip('tensorflow')
  from rigl_tpu_torch.train.trainer import TrainConfig, Trainer
  rs = np.random.RandomState(0)

  def write_split(split, n):
    path = str(tmp_path / f'{split}-00000-of-00001')
    with tf.io.TFRecordWriter(path) as w:
      for i in range(n):
        img = rs.randint(0, 255, (96, 96, 3)).astype(np.uint8)
        jpeg = tf.io.encode_jpeg(img).numpy()
        ex = tf.train.Example(features=tf.train.Features(feature={
            'image/encoded': tf.train.Feature(
                bytes_list=tf.train.BytesList(value=[jpeg])),
            'image/class/label': tf.train.Feature(
                int64_list=tf.train.Int64List(value=[i % 1000 + 1])),
        }))
        w.write(ex.SerializeToString())

  write_split('train', 16)
  write_split('validation', 8)
  cfg = TrainConfig(
      model='resnet', model_kwargs={'depth': 18, 'width': 0.25},
      dataset='imagenet', data_dir=str(tmp_path),
      batch_size=8, eval_batch_size=8, train_steps=2,
      training_method='rigl', sparsity=0.8,
      mask_init_method='erdos_renyi_kernel',
      maskupdate_frequency=100, label_smoothing=0.1, weight_decay=1e-4,
      log_every=0)
  t = Trainer(cfg, device='cpu')
  assert t.data_info['source'] == 'tfrecords'
  result = t.train()
  assert np.isfinite(result['eval_loss'])
  assert result['global_sparsity'] == pytest.approx(0.8, abs=0.05)


# ---------------------------------------------------------- research presets --
def _run_preset(path, overrides, out=None):
  argv = ['--device=cpu', f'--config={path}'] + [
      f'--override={o}' for o in overrides]
  if out:
    argv.append(f'--output_dir={out}')
  trainer, out_dir = train_driver.build_trainer(argv)
  return trainer, common.run_and_report(trainer, out_dir)


def test_mlp_matrix_inventory():
  assert set(MLP_PRESETS) == {f'mlp_{m}.json' for m in (
      'dense', 'lottery', 'prune', 'rigl', 'set', 'scratch', 'small_dense')}


@pytest.mark.parametrize('name', MLP_PRESETS)
def test_mlp_preset_runs(name, tmp_path):
  path = os.path.join(CONFIGS, name)
  raw = {k: v for k, v in json.load(open(path)).items()
         if not k.startswith('_')}
  overrides = list(SMOKE)
  if 'lottery' in name:
    donor, _ = _run_preset(os.path.join(CONFIGS, 'mlp_set.json'), SMOKE,
                           tmp_path / 'donor')
    overrides += [f'init_masks_from={tmp_path / "donor"}',
                  f'init_params_from={tmp_path / "donor"}']
  preset = tmp_path / 'preset.json'
  preset.write_text(json.dumps(raw))
  trainer, result = _run_preset(str(preset), overrides)
  assert np.isfinite(result['eval_loss'])
  if raw['training_method'] in ('rigl', 'set', 'scratch'):
    assert result['global_sparsity'] == pytest.approx(0.98, abs=0.03)
  if 'lottery' in name:
    for p, m in trainer.state.sparse.masks.items():
      assert torch.equal(m, donor.state.sparse.masks[p]), p


def test_lenet_lottery_preset_loads(tmp_path):
  donor_dir = tmp_path / 'donor'
  donor, _ = _run_preset(os.path.join(CONFIGS, 'lenet_set.json'), SMOKE,
                         donor_dir)
  raw = {k: v for k, v in
         json.load(open(os.path.join(CONFIGS, 'lenet_lottery.json'))).items()
         if not k.startswith('_')}
  preset = tmp_path / 'lottery.json'
  preset.write_text(json.dumps(raw))
  trainer, result = _run_preset(str(preset), SMOKE + [
      f'init_masks_from={donor_dir}', f'init_params_from={donor_dir}'])
  assert np.isfinite(result['eval_loss'])
  for p, m in trainer.state.sparse.masks.items():
    assert torch.equal(m, donor.state.sparse.masks[p]), p
