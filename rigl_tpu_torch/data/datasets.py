"""Dataset loaders: MNIST and CIFAR-10 from raw files, ImageNet from
TFRecords, with the learnable synthetic fallback of identical shapes.

Counterpart of rigl_tpu/data/datasets.py, in numpy only: the same parsers,
the same synthetic task from the same seeds (so both packages see the
same arrays) and the same normalizations: MNIST x/255 - 0.5, CIFAR per-image
standardization (pipeline.py), ImageNet (x - MEAN_RGB) / STDDEV_RGB.

`create_dataset` returns pipeline.ArrayDatasets, as JAX's does.  For
CIFAR-10 the train split's images stay RAW uint8 and its epoch iterators
apply pad-crop-flip, then the standardization; the packed trainers sample
from the arrays and never run those iterators, so the packed-conv driver
trains on raw pixels, as JAX's does.  ImageNet reads TFRecords when
`data_dir` holds them (data/imagenet_tfrecord.py, which needs TensorFlow)
and is synthetic otherwise.
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
from typing import Optional, Tuple

import numpy as np

from rigl_tpu_torch.data import pipeline
from rigl_tpu_torch.data.pipeline import ArrayDataset, standardize_per_image

MEAN_RGB = np.array([0.485 * 255, 0.456 * 255, 0.406 * 255], np.float32)
STDDEV_RGB = np.array([0.229 * 255, 0.224 * 255, 0.225 * 255], np.float32)


# ---------------------------------------------------------------- parsers --
def _read_idx(path: str) -> np.ndarray:
  """Parses MNIST idx format (optionally gzipped)."""
  opener = gzip.open if path.endswith('.gz') else open
  with opener(path, 'rb') as f:
    data = f.read()
  dtype_code, ndim = data[2], data[3]
  dims = struct.unpack('>' + 'I' * ndim, data[4:4 + 4 * ndim])
  dtype = {8: np.uint8, 9: np.int8, 11: np.int16, 12: np.int32,
           13: np.float32, 14: np.float64}[dtype_code]
  return np.frombuffer(data, dtype, offset=4 + 4 * ndim).reshape(dims)


def _find(data_dir: str, names) -> Optional[str]:
  for name in names:
    for suffix in ('', '.gz'):
      p = os.path.join(data_dir, name + suffix)
      if os.path.exists(p):
        return p
  return None


def load_mnist_arrays(data_dir: str) -> Optional[Tuple]:
  files = {
      'train_x': ('train-images-idx3-ubyte', 'train-images.idx3-ubyte'),
      'train_y': ('train-labels-idx1-ubyte', 'train-labels.idx1-ubyte'),
      'test_x': ('t10k-images-idx3-ubyte', 't10k-images.idx3-ubyte'),
      'test_y': ('t10k-labels-idx1-ubyte', 't10k-labels.idx1-ubyte'),
  }
  paths = {k: _find(data_dir, v) for k, v in files.items()}
  if any(p is None for p in paths.values()):
    return None
  tx = _read_idx(paths['train_x'])[..., None]
  ty = _read_idx(paths['train_y']).astype(np.int32)
  vx = _read_idx(paths['test_x'])[..., None]
  vy = _read_idx(paths['test_y']).astype(np.int32)
  return tx, ty, vx, vy


def load_cifar10_arrays(data_dir: str) -> Optional[Tuple]:
  """Parses the CIFAR-10 binary (or python-pickle) distribution."""
  bin_dir = None
  for cand in (data_dir, os.path.join(data_dir, 'cifar-10-batches-bin'),
               os.path.join(data_dir, 'cifar-10-batches-py')):
    if os.path.isdir(cand) and (
        os.path.exists(os.path.join(cand, 'data_batch_1.bin'))
        or os.path.exists(os.path.join(cand, 'data_batch_1'))):
      bin_dir = cand
      break
  if bin_dir is None:
    return None

  def read_bin(path):
    raw = np.fromfile(path, np.uint8).reshape(-1, 3073)
    labels = raw[:, 0].astype(np.int32)
    images = raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return images, labels

  def read_py(path):
    with open(path, 'rb') as f:
      d = pickle.load(f, encoding='bytes')
    images = d[b'data'].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return images, np.asarray(d[b'labels'], np.int32)

  binary = os.path.exists(os.path.join(bin_dir, 'data_batch_1.bin'))
  reader, suffix = (read_bin, '.bin') if binary else (read_py, '')
  train = [reader(os.path.join(bin_dir, f'data_batch_{i}{suffix}'))
           for i in range(1, 6)]
  tx = np.concatenate([t[0] for t in train])
  ty = np.concatenate([t[1] for t in train])
  vx, vy = reader(os.path.join(bin_dir, f'test_batch{suffix}'))
  return tx, ty, vx, vy


# --------------------------------------------------------------- synthetic --
def synthetic_arrays(num_classes: int, shape: Tuple[int, ...],
                     n_train: int = 4096, n_test: int = 1024,
                     seed: int = 0) -> Tuple:
  """Learnable synthetic task: class prototypes + noise.  Lets trainers and
  tests verify optimization end-to-end without dataset files."""
  rng = np.random.default_rng(seed)
  prototypes = rng.normal(0.5, 0.25, size=(num_classes,) + shape)

  def make(n, s):
    r = np.random.default_rng(s)
    labels = r.integers(0, num_classes, size=n).astype(np.int32)
    images = prototypes[labels] + r.normal(0, 0.35, size=(n,) + shape)
    return np.clip(images * 255, 0, 255).astype(np.uint8), labels

  tx, ty = make(n_train, seed + 1)
  vx, vy = make(n_test, seed + 2)
  return tx, ty, vx, vy


# ---------------------------------------------------------------- factory --
_SHAPES = {
    'mnist': ((28, 28, 1), 10),
    'cifar10': ((32, 32, 3), 10),
    'imagenet': ((224, 224, 3), 1000),
}
_LOADERS = {'mnist': load_mnist_arrays, 'cifar10': load_cifar10_arrays}


def normalize(name: str, images: np.ndarray) -> np.ndarray:
  x = images.astype(np.float32)
  if name == 'mnist':
    return x / 255.0 - 0.5
  if name == 'cifar10':
    return standardize_per_image(x)
  if name == 'imagenet':
    return (x - MEAN_RGB) / STDDEV_RGB
  return x / 255.0


def _imagenet_tfrecords(data_dir, batch_size, eval_batch_size, seed,
                        num_classes, shape):
  """(train, eval, info) over the TFRecords in `data_dir`, or None where it
  holds no train records."""
  from rigl_tpu_torch.data import imagenet_tfrecord as itfr
  if not itfr.has_tfrecords(data_dir, 'train'):
    return None
  itfr.require_tensorflow()
  train = itfr.TFRecordImageNet(data_dir, 'train', batch_size,
                                is_training=True, seed=seed)
  eval_split = ('validation' if itfr.has_tfrecords(data_dir, 'validation')
                else 'train')
  test = itfr.TFRecordImageNet(data_dir, eval_split, eval_batch_size,
                               is_training=False)
  info = {'num_classes': num_classes, 'shape': shape,
          'num_train': itfr.NUM_TRAIN, 'num_test': itfr.NUM_EVAL,
          'source': 'tfrecords'}
  return train, test, info


def create_dataset(name: str, batch_size: int, eval_batch_size: int = 0,
                   data_dir: Optional[str] = None, seed: int = 0,
                   synthetic_ok: bool = True, n_synthetic: int = 4096):
  """Returns (train ArrayDataset, eval ArrayDataset, info dict): the files
  or TFRecords under `data_dir`, else the synthetic task.  The CIFAR-10
  train set augments (pad-crop-flip, then per-image standardization) in
  its epoch iterators; the other sets hold normalized images."""
  if name not in _SHAPES:
    raise ValueError(f'Unknown dataset {name!r}')
  shape, num_classes = _SHAPES[name]
  eval_batch_size = eval_batch_size or batch_size
  arrays = None
  if data_dir:
    if name == 'imagenet':
      records = _imagenet_tfrecords(data_dir, batch_size, eval_batch_size,
                                    seed, num_classes, shape)
      if records is not None:
        return records
    else:
      arrays = _LOADERS[name](data_dir)
  source = 'files' if arrays is not None else 'synthetic'
  if arrays is None:
    if not synthetic_ok:
      raise FileNotFoundError(
          f'No {name} data found under {data_dir!r} and synthetic fallback '
          'disabled')
    arrays = synthetic_arrays(num_classes, shape, n_train=n_synthetic,
                              n_test=max(n_synthetic // 4, eval_batch_size),
                              seed=seed)
  tx, ty, vx, vy = arrays
  if name == 'cifar10':
    raw_augment = pipeline.pad_crop_flip(4)

    def augment(batch, rng):
      batch = raw_augment({'image': batch['image'].astype(np.float32),
                           'label': batch['label']}, rng)
      batch['image'] = standardize_per_image(batch['image'])
      return batch

    train = ArrayDataset(tx, ty, batch_size, seed=seed, augment=augment)
  else:
    train = ArrayDataset(normalize(name, tx), ty, batch_size, seed=seed)
  test = ArrayDataset(normalize(name, vx), vy, eval_batch_size,
                      shuffle=False)
  info = {'num_classes': num_classes, 'shape': shape, 'num_train': len(tx),
          'num_test': len(vx), 'source': source}
  return train, test, info
