"""Dataset loaders for the packed-MLP driver: MNIST from raw idx files,
with the learnable synthetic fallback of identical shapes.

Counterpart of the part of rigl_tpu/data/datasets.py that
drivers/packed_mlp.py uses, in numpy only: the same parsers, the same
synthetic task from the same seeds (so both packages see the same
arrays), and MNIST's normalization x/255 - 0.5.  Other datasets, and the
batching pipeline (the packed trainer samples from arrays directly), are
not ported yet and raise.
"""

from __future__ import annotations

import dataclasses
import gzip
import os
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
_SHAPES = {'mnist': ((28, 28, 1), 10)}


def _not_ported(name: str):
  if name not in _SHAPES:
    raise NotImplementedError(f'dataset {name!r} is not ported yet '
                              '(only mnist)')


def normalize(name: str, images: np.ndarray) -> np.ndarray:
  _not_ported(name)
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
  """Returns (train ArrayDataset, eval ArrayDataset, info dict), normalized;
  the synthetic task when `data_dir` holds no MNIST files."""
  _not_ported(name)
  shape, num_classes = _SHAPES[name]
  eval_batch_size = eval_batch_size or batch_size
  arrays = load_mnist_arrays(data_dir) if data_dir else None
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
  train = ArrayDataset(normalize(name, tx), ty, batch_size)
  test = ArrayDataset(normalize(name, vx), vy, eval_batch_size)
  info = {'num_classes': num_classes, 'shape': shape, 'num_train': len(tx),
          'num_test': len(vx), 'source': source}
  return train, test, info
