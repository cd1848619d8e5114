"""Dataset loaders for the packed drivers: MNIST from raw idx files,
CIFAR-10 from its binary or python-pickle batches, with the learnable
synthetic fallback of identical shapes.

Counterpart of the part of rigl_tpu/data/datasets.py that
drivers/packed_mlp.py and drivers/packed_conv.py use, in numpy only: the
same parsers, the same synthetic task from the same seeds (so both
packages see the same arrays), MNIST's normalization x/255 - 0.5 and
CIFAR's per-image standardization (rigl_tpu/data/pipeline.py).

For CIFAR-10 the train split's images stay RAW uint8, as in JAX: there the
pad-crop-flip augmentation and the standardization run only in the
pipeline's epoch iterators, which the packed trainers never use (they
sample from the arrays), so the JAX packed-conv driver trains on raw
pixels; the eval split is standardized.  The iterators, the augmentation
and ImageNet are not ported yet and raise.
"""

from __future__ import annotations

import dataclasses
import gzip
import os
import pickle
import struct
from typing import Optional, Tuple

import numpy as np


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


def standardize_per_image(images: np.ndarray) -> np.ndarray:
  """tf.image.per_image_standardization: each image to zero mean and unit
  variance, the std floored at 1/sqrt(pixels)."""
  images = images.astype(np.float32)
  axes = tuple(range(1, images.ndim))
  mean = images.mean(axis=axes, keepdims=True)
  std = images.std(axis=axes, keepdims=True)
  n = np.prod(images.shape[1:])
  return (images - mean) / np.maximum(std, 1.0 / np.sqrt(n))


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
_SHAPES = {'mnist': ((28, 28, 1), 10), 'cifar10': ((32, 32, 3), 10)}
_LOADERS = {'mnist': load_mnist_arrays, 'cifar10': load_cifar10_arrays}


def _not_ported(name: str):
  if name not in _SHAPES:
    raise NotImplementedError(f'dataset {name!r} is not ported yet '
                              '(only mnist and cifar10)')


def normalize(name: str, images: np.ndarray) -> np.ndarray:
  _not_ported(name)
  if name == 'cifar10':
    return standardize_per_image(images)
  return images.astype(np.float32) / 255.0 - 0.5


@dataclasses.dataclass
class ArrayDataset:
  """In-memory arrays of one split (the JAX pipeline's ArrayDataset
  without its epoch iterators, which the packed trainer does not use)."""
  images: np.ndarray
  labels: np.ndarray
  batch_size: int


def create_dataset(name: str, batch_size: int, eval_batch_size: int = 0,
                   data_dir: Optional[str] = None, seed: int = 0,
                   synthetic_ok: bool = True, n_synthetic: int = 4096):
  """Returns (train ArrayDataset, eval ArrayDataset, info dict): the
  synthetic task when `data_dir` holds no files of the dataset.  Eval
  images are normalized; train images too, except CIFAR-10's, which stay
  raw uint8 as JAX's train ArrayDataset holds them (module docstring)."""
  _not_ported(name)
  shape, num_classes = _SHAPES[name]
  eval_batch_size = eval_batch_size or batch_size
  arrays = _LOADERS[name](data_dir) if data_dir else None
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
  train = ArrayDataset(tx if name == 'cifar10' else normalize(name, tx), ty,
                       batch_size)
  test = ArrayDataset(normalize(name, vx), vy, eval_batch_size)
  info = {'num_classes': num_classes, 'shape': shape, 'num_train': len(tx),
          'num_test': len(vx), 'source': source}
  return train, test, info
