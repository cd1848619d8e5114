"""Metrics writing, summaries and profiling hooks.

Counterpart of rigl_tpu/utils/metrics.py: a JSONL metrics writer (one line
per log step), the standard summary builders (mask sparsities and mask
images, parameter and gradient norms, distance to init, gradient SNR,
per-class precision / recall) and a trace capture, here torch.profiler's,
written as a Chrome trace.  Inputs are {name: tensor} dicts, nested
mappings or sequences of tensors or numpy arrays.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Iterator, Mapping, Optional

import numpy as np
import torch

from rigl_tpu_torch.sparsity import masks as masks_lib


class MetricsWriter:
  """Appends one JSON object per call to <dir>/metrics.jsonl."""

  def __init__(self, directory: str, filename: str = 'metrics.jsonl'):
    os.makedirs(directory, exist_ok=True)
    self.path = os.path.join(directory, filename)
    self._f = open(self.path, 'a')

  def write(self, step: int, metrics: Mapping[str, Any]):
    rec = {'step': int(step), 'time': time.time()}
    for k, v in metrics.items():
      try:
        rec[k] = float(v)
      except (TypeError, ValueError):
        rec[k] = v
    self._f.write(json.dumps(rec) + '\n')
    self._f.flush()

  def close(self):
    self._f.close()


def read_metrics(directory: str, filename: str = 'metrics.jsonl'):
  path = os.path.join(directory, filename)
  with open(path) as f:
    return [json.loads(line) for line in f if line.strip()]


def _tensor(x) -> torch.Tensor:
  return x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))


def _leaves(tree):
  """The tensors of a nested mapping / sequence, in JAX's leaf order
  (mapping keys sorted)."""
  if isinstance(tree, Mapping):
    for k in sorted(tree):
      yield from _leaves(tree[k])
  elif isinstance(tree, (list, tuple)):
    for v in tree:
      yield from _leaves(v)
  else:
    yield _tensor(tree)


def sparsity_summaries(masks: Mapping[str, Any]) -> Dict[str, Any]:
  """Global + per-layer mask sparsity scalars (utils.py:83-90 parity)."""
  if not masks:
    return {}
  masks = {p: _tensor(m) for p, m in masks.items()}
  out: Dict[str, Any] = {
      'global_sparsity': float(masks_lib.calculate_sparsity(masks))
  }
  for p, s in masks_lib.per_layer_sparsity(masks).items():
    out[f'sparsity/{p}'] = float(s)
  return out


def mask_images(masks: Mapping[str, Any]) -> Dict[str, np.ndarray]:
  """Per-layer mask *images* (imagenet_resnet/utils.py:83-90 with_img=True):
  each mask reshaped to 2D (rows = all-but-last dims), as uint8 0/255
  arrays ready for PNG/GIF encoding or npy dumps."""
  out = {}
  for p, m in masks.items():
    a = _tensor(m).detach().cpu().numpy()
    img = a.reshape(-1, a.shape[-1]) if a.ndim > 1 else a.reshape(1, -1)
    out[p] = (img > 0).astype(np.uint8) * 255
  return out


def write_mask_images(directory: str, step: int,
                      masks: Mapping[str, Any]) -> str:
  """Dumps mask images to <dir>/mask_images/step_<n>.npz (the host_call
  image-summary equivalent)."""
  img_dir = os.path.join(directory, 'mask_images')
  os.makedirs(img_dir, exist_ok=True)
  path = os.path.join(img_dir, f'step_{step:08d}.npz')
  np.savez_compressed(path,
                      **{p.replace('/', '__'): v
                         for p, v in mask_images(masks).items()})
  return path


def norm_summaries(tree, prefix: str) -> Dict[str, float]:
  """Global L2 norm of a tree of tensors (grad / param norm scalars)."""
  sq = sum(float(x.to(torch.float32).square().sum()) for x in _leaves(tree))
  return {f'{prefix}_norm': sq ** 0.5}


def distance_to_init(params, init_params) -> Dict[str, float]:
  """L2 distance and cosine similarity to the initial params
  (rigl_tf2/train.py:347-390, experimental/jax utils :119-148)."""
  a = torch.cat([x.reshape(-1).to(torch.float32).cpu()
                 for x in _leaves(params)])
  b = torch.cat([x.reshape(-1).to(torch.float32).cpu()
                 for x in _leaves(init_params)])
  dist = float(torch.linalg.norm(a - b))
  cos = float(torch.dot(a, b)
              / (torch.linalg.norm(a) * torch.linalg.norm(b) + 1e-12))
  return {'distance_to_init': dist, 'cosine_to_init': cos}


def snr_summaries(loss_fn, params: Mapping[str, torch.Tensor],
                  batch) -> Dict[str, float]:
  """Gradient signal-to-noise ratio over a batch.

  Parity with rl/tfagents/tf_sparse_utils.py:186-206 (log_snr):
  per-example gradients (torch.func.vmap of torch.func.grad of
  `loss_fn(params, {'x': x[None], 'y': y[None]})`), SNR = |mean / (std +
  1e-10)| per parameter (std over the batch, population), summarized by
  mean and std.  Expensive: call sparingly."""
  from torch.func import grad, vmap

  def one_example(p, x, y):
    return loss_fn(p, {'x': x[None], 'y': y[None]})

  per_sample = vmap(grad(one_example), in_dims=(None, 0, 0))(
      dict(params), _tensor(batch['x']), _tensor(batch['y']))
  snrs = []
  for g in _leaves(per_sample):
    g = g.to(torch.float32)
    mean = g.mean(0)
    std = g.std(0, correction=0)
    snrs.append((mean / (std + 1e-10)).abs().reshape(-1))
  flat = torch.cat(snrs)
  return {'snr_mean': float(flat.mean()),
          'snr_std': float(flat.std(correction=0))}


def per_class_metrics(logits, labels, num_classes: int) -> Dict[str, float]:
  """Per-class precision/recall (cifar_resnet/resnet_train_eval.py:141-168)."""
  preds = _tensor(logits).argmax(-1)
  labels = _tensor(labels)
  out: Dict[str, float] = {}
  for c in range(num_classes):
    tp = ((preds == c) & (labels == c)).sum().to(torch.float32)
    fp = ((preds == c) & (labels != c)).sum().to(torch.float32)
    fn = ((preds != c) & (labels == c)).sum().to(torch.float32)
    out[f'precision/class_{c}'] = float(tp / torch.clamp(tp + fp, min=1.0))
    out[f'recall/class_{c}'] = float(tp / torch.clamp(tp + fn, min=1.0))
  return out


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]) -> Iterator[None]:
  """torch.profiler capture around a training region (CPU, and CUDA where
  a card is present), written to <log_dir>/trace.json as a Chrome trace.
  No-op when log_dir is None."""
  if not log_dir:
    yield
    return
  os.makedirs(log_dir, exist_ok=True)
  activities = [torch.profiler.ProfilerActivity.CPU]
  if torch.cuda.is_available():
    activities.append(torch.profiler.ProfilerActivity.CUDA)
  prof = torch.profiler.profile(activities=activities)
  prof.start()
  try:
    yield
  finally:
    if torch.cuda.is_available():
      torch.cuda.synchronize()
    prof.stop()
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))


class StepTimer:
  """Steps/sec and examples/sec over a rolling window."""

  def __init__(self, batch_size: int):
    self.batch_size = batch_size
    self._last_t = time.time()
    self._last_step = 0

  def update(self, step: int) -> Dict[str, float]:
    now = time.time()
    dsteps = step - self._last_step
    dt = max(now - self._last_t, 1e-9)
    out = {
        'steps_per_sec': dsteps / dt,
        'examples_per_sec': dsteps * self.batch_size / dt,
    }
    self._last_t, self._last_step = now, step
    return out
