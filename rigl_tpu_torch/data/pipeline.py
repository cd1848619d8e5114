"""Host-side input pipeline: numpy batching, augmentation and background
device prefetch, in PyTorch.

Counterpart of rigl_tpu/data/pipeline.py.  Batches are {'image', 'label'}
numpy dicts, so any source (synthetic, raw files, TFRecords) plugs in.
The epoch order and the augmentation draw from np.random.default_rng, as
JAX's pipeline does, so both packages give bit-identical batches for the
same seed.  `prefetch_to_device` overlaps host batch preparation and the
host-to-device copy with the device's work: a background thread pins each
batch and copies it with non_blocking=True.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

Batch = Dict[str, np.ndarray]


class ArrayDataset:
  """In-memory dataset with the reference's epoch semantics: shuffle each
  epoch, drop the remainder."""

  def __init__(self, images: np.ndarray, labels: np.ndarray, batch_size: int,
               shuffle: bool = True, seed: int = 0,
               augment: Optional[Callable[[Batch, np.random.Generator],
                                          Batch]] = None):
    if len(images) != len(labels):
      raise ValueError('images/labels length mismatch')
    self.images = images
    self.labels = labels
    self.batch_size = batch_size
    self.shuffle = shuffle
    self.augment = augment
    self._rng = np.random.default_rng(seed)

  def __len__(self):
    return len(self.images) // self.batch_size

  def epoch(self) -> Iterator[Batch]:
    n = len(self.images)
    order = self._rng.permutation(n) if self.shuffle else np.arange(n)
    for i in range(len(self)):
      idx = order[i * self.batch_size:(i + 1) * self.batch_size]
      batch = {'image': self.images[idx], 'label': self.labels[idx]}
      if self.augment is not None:
        batch = self.augment(batch, self._rng)
      yield batch

  def repeat(self) -> Iterator[Batch]:
    while True:
      yield from self.epoch()


def _to_device(batch: Batch, device: torch.device) -> Dict[str, torch.Tensor]:
  out = {}
  for k, v in batch.items():
    t = torch.from_numpy(np.ascontiguousarray(v))
    if device.type == 'cuda':
      t = t.pin_memory().to(device, non_blocking=True)
    else:
      t = t.to(device)
    out[k] = t
  return out


def prefetch_to_device(it: Iterator[Batch], size: int = 2,
                       device='cuda') -> Iterator[Dict[str, torch.Tensor]]:
  """Yields `it`'s batches as tensors on `device`, prepared up to `size`
  batches ahead by a background thread (pinned host memory, non-blocking
  copies on the thread's current stream, the default one).  A CUDA device
  with no CUDA available raises here, before any batch."""
  device = torch.device(device)
  if device.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError(f'prefetch_to_device: {device} requested but CUDA is '
                       'not available')
  if device.type == 'cuda' and device.index is None:
    # 'cuda' names the caller's current card, which the producer thread
    # must select by index.
    device = torch.device('cuda', torch.cuda.current_device())
  q: queue.Queue = queue.Queue(maxsize=size)
  sentinel = object()

  def producer():
    try:
      if device.type == 'cuda':
        torch.cuda.set_device(device)
      for batch in it:
        q.put(_to_device(batch, device))
      q.put(sentinel)
    except BaseException as e:  # re-raised in the consumer
      q.put(e)

  def consumer():
    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
      item = q.get()
      if item is sentinel:
        return
      if isinstance(item, BaseException):
        raise item
      yield item

  return consumer()


# ---------------------------------------------------------------- augment --
def pad_crop_flip(pad: int = 4):
  """CIFAR augmentation: mirror-pad by `pad` (the border pixel included,
  np.pad 'symmetric'), random crop back to the original size, random
  horizontal flip; the draws in JAX's order (rows, columns, flips)."""

  def fn(batch: Batch, rng: np.random.Generator) -> Batch:
    imgs = batch['image']
    n, h, w, _ = imgs.shape
    padded = np.pad(imgs, ((0, 0), (pad, pad), (pad, pad), (0, 0)),
                    mode='symmetric')
    out = np.empty_like(imgs)
    ys = rng.integers(0, 2 * pad + 1, size=n)
    xs = rng.integers(0, 2 * pad + 1, size=n)
    flips = rng.random(n) < 0.5
    for i in range(n):
      crop = padded[i, ys[i]:ys[i] + h, xs[i]:xs[i] + w, :]
      out[i] = crop[:, ::-1, :] if flips[i] else crop
    return {'image': out, 'label': batch['label']}

  return fn


def standardize_per_image(images: np.ndarray) -> np.ndarray:
  """tf.image.per_image_standardization: each image to zero mean and unit
  variance, the std floored at 1/sqrt(pixels)."""
  images = images.astype(np.float32)
  axes = tuple(range(1, images.ndim))
  mean = images.mean(axis=axes, keepdims=True)
  std = images.std(axis=axes, keepdims=True)
  n = np.prod(images.shape[1:])
  return (images - mean) / np.maximum(std, 1.0 / np.sqrt(n))
