"""The port's input pipeline (rigl_tpu_torch/data/pipeline.py, datasets.py,
imagenet_tfrecord.py) against the JAX package's, on the CPU.

Both draw epochs and augmentations from np.random.default_rng, so for the
same seed the batches must be bitwise equal: ArrayDataset epochs (shuffled
and not, with the remainder dropped), pad_crop_flip, and create_dataset's
CIFAR-10 train iterator (pad-crop-flip, then per-image standardization);
standardize_per_image within 1e-6.  prefetch_to_device yields the same
batches as tensors on the device it is given, and refuses a CUDA device
where there is none.  The ImageNet reader runs on TFRecords the test
writes (JPEGs of random pixels): the eval split's batches equal JAX's
bitwise (the same tf.data decode, crop and resize), the train split's
shapes, labels and normalization; without TensorFlow, records raise an
ImportError that names it.
"""

import sys

import numpy as np
import pytest
import torch

from rigl_tpu.data import datasets as jdatasets
from rigl_tpu.data import pipeline as jpipeline
from rigl_tpu_torch.data import datasets
from rigl_tpu_torch.data import pipeline


def _batches(it, n):
  return [next(it) for _ in range(n)]


def _equal(got, want):
  assert len(got) == len(want)
  for g, w in zip(got, want):
    assert set(g) == set(w)
    for k in w:
      assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype
      np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]))


@pytest.mark.parametrize('shuffle', [True, False])
def test_array_dataset_epochs_and_augmentation_bitwise_equal_jax(shuffle):
  rs = np.random.RandomState(0)
  images = rs.randint(0, 256, (37, 8, 6, 3)).astype(np.uint8)
  labels = rs.randint(0, 10, 37).astype(np.int32)
  for augment in (None, 'pad_crop_flip'):
    ds = pipeline.ArrayDataset(
        images, labels, 8, shuffle=shuffle, seed=5,
        augment=augment and pipeline.pad_crop_flip(2))
    jds = jpipeline.ArrayDataset(
        images, labels, 8, shuffle=shuffle, seed=5,
        augment=augment and jpipeline.pad_crop_flip(2))
    assert len(ds) == len(jds) == 4
    _equal(_batches(ds.repeat(), 9), _batches(jds.repeat(), 9))
  with pytest.raises(ValueError, match='length mismatch'):
    pipeline.ArrayDataset(images, labels[:3], 8)


def test_pad_crop_flip_and_standardize_equal_jax():
  rs = np.random.RandomState(1)
  batch = {'image': rs.rand(6, 32, 32, 3).astype(np.float32),
           'label': np.arange(6, dtype=np.int32)}
  got = pipeline.pad_crop_flip(4)(batch, np.random.default_rng(3))
  want = jpipeline.pad_crop_flip(4)(batch, np.random.default_rng(3))
  _equal([got], [want])
  x = rs.normal(5.0, 3.0, (2, 8, 8, 3)).astype(np.float32)
  x[1] = 7.0   # a constant image: the std floor
  np.testing.assert_allclose(pipeline.standardize_per_image(x),
                             jpipeline.standardize_per_image(x), rtol=0,
                             atol=1e-6)
  assert datasets.standardize_per_image is pipeline.standardize_per_image


def test_cifar_train_iterator_equals_jax():
  """create_dataset's CIFAR-10 train set: raw uint8 arrays, epochs that
  pad-crop-flip and standardize, bitwise as JAX's."""
  got, _, _ = datasets.create_dataset('cifar10', 16, n_synthetic=64, seed=2)
  want, _, _ = jdatasets.create_dataset('cifar10', 16, n_synthetic=64,
                                        seed=2)
  assert got.images.dtype == np.uint8
  _equal(_batches(got.repeat(), 6), _batches(want.repeat(), 6))


def test_prefetch_to_device():
  ds = pipeline.ArrayDataset(np.arange(32).reshape(16, 2).astype(np.float32),
                             np.zeros(16, np.int32), batch_size=4,
                             shuffle=False)
  got = list(pipeline.prefetch_to_device(ds.epoch(), size=2, device='cpu'))
  assert len(got) == 4
  for g, w in zip(got, ds.epoch()):
    assert isinstance(g['image'], torch.Tensor)
    assert g['image'].device.type == 'cpu'
    np.testing.assert_array_equal(g['image'].numpy(), w['image'])
    np.testing.assert_array_equal(g['label'].numpy(), w['label'])

  def failing():
    yield {'image': np.zeros(2), 'label': np.zeros(2)}
    raise OSError('disk gone')

  it = pipeline.prefetch_to_device(failing(), device='cpu')
  next(it)
  with pytest.raises(OSError, match='disk gone'):
    next(it)
  if not torch.cuda.is_available():
    with pytest.raises(RuntimeError, match='CUDA is not available'):
      pipeline.prefetch_to_device(ds.epoch(), device='cuda')


def test_unknown_dataset_and_missing_files():
  for mod in (datasets, jdatasets):
    with pytest.raises(ValueError, match='Unknown dataset'):
      mod.create_dataset('svhn', 8)
  for name in ('mnist', 'cifar10', 'imagenet'):
    with pytest.raises(FileNotFoundError, match='synthetic fallback'):
      datasets.create_dataset(name, 8, data_dir='/nonexistent',
                              synthetic_ok=False)


def _write_records(tf, tmp_path, split, n, rs):
  path = str(tmp_path / f'{split}-00000-of-00001')
  with tf.io.TFRecordWriter(path) as w:
    for i in range(n):
      img = rs.randint(0, 255, (48 + 8 * i, 64, 3)).astype(np.uint8)
      jpeg = tf.io.encode_jpeg(img).numpy()
      ex = tf.train.Example(features=tf.train.Features(feature={
          'image/encoded': tf.train.Feature(
              bytes_list=tf.train.BytesList(value=[jpeg])),
          'image/class/label': tf.train.Feature(
              int64_list=tf.train.Int64List(value=[i % 10 + 1])),
      }))
      w.write(ex.SerializeToString())


def test_imagenet_tfrecords_match_jax(tmp_path, monkeypatch):
  tf = pytest.importorskip('tensorflow')
  rs = np.random.RandomState(0)
  _write_records(tf, tmp_path, 'train', 8, rs)
  _write_records(tf, tmp_path, 'validation', 4, rs)
  train, test, info = datasets.create_dataset(
      'imagenet', batch_size=4, eval_batch_size=2, data_dir=str(tmp_path))
  jtrain, jtest, jinfo = jdatasets.create_dataset(
      'imagenet', batch_size=4, eval_batch_size=2, data_dir=str(tmp_path))
  assert info == jinfo and info['source'] == 'tfrecords'
  _equal(list(test.epoch()), list(jtest.epoch()))
  batch = next(iter(train.repeat()))
  assert batch['image'].shape == (4, 224, 224, 3)
  assert batch['image'].dtype == np.float32
  assert set(batch['label'].tolist()) <= set(range(10))
  assert abs(float(batch['image'].mean())) < 3.0
  # Without TensorFlow, records are an error, not a synthetic fallback.
  monkeypatch.setitem(sys.modules, 'tensorflow', None)
  with pytest.raises(ImportError, match='TensorFlow'):
    datasets.create_dataset('imagenet', 4, data_dir=str(tmp_path))
  # Where no records exist, the synthetic task of JAX's shapes.
  _, _, info = datasets.create_dataset('imagenet', 4, n_synthetic=8,
                                       data_dir=str(tmp_path / 'none'))
  assert info['source'] == 'synthetic' and info['shape'] == (224, 224, 3)
