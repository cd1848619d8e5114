"""Model export for serving.

Counterpart of rigl_tpu/train/export.py, capability parity with the
reference's periodic SavedModel export (ExportModelHook,
imagenet_train_eval.py:668-700): the trained sparse model in one
self-contained artifact that an inference service loads without the
training state.

The export bakes the masks into the weights (w * m: inference needs no
mask multiply) and writes <dir>/model.npz (the effective params, the
batch_stats and the masks, keyed 'params/<path>', 'batch_stats/<path>',
'masks/<path>') and manifest.json (model name, JSON-able kwargs, global
and per-layer sparsity: the JAX package's keys and values).  The npz is
the port's own format, where JAX writes a flax msgpack;
`load_for_inference` reads it back.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from rigl_tpu_torch.models import registry
from rigl_tpu_torch.sparsity import masks as masks_lib


def _numpy(t) -> np.ndarray:
  t = torch.as_tensor(t).detach().cpu()
  if t.dtype == torch.bfloat16:
    t = t.to(torch.float32)
  return t.numpy()


def export_model(directory: str, model_name: str, model_kwargs: Dict[str, Any],
                 params, masks, batch_stats=None,
                 extra_manifest: Optional[Dict[str, Any]] = None) -> str:
  """Writes <dir>/model.npz + manifest.json; returns the directory.
  `params`, `masks` and `batch_stats` are {path: tensor} dicts."""
  os.makedirs(directory, exist_ok=True)
  eff = masks_lib.apply_masks(params, masks)
  payload = {f'params/{p}': _numpy(t) for p, t in eff.items()}
  payload.update({f'batch_stats/{p}': _numpy(t)
                  for p, t in (batch_stats or {}).items()})
  # Masks ship alongside for sparse-aware runtimes / re-training.
  payload.update({f'masks/{p}': _numpy(t) for p, t in masks.items()})
  np.savez(os.path.join(directory, 'model.npz'), **payload)
  manifest = {
      'model': model_name,
      'model_kwargs': {k: v for k, v in model_kwargs.items()
                       if isinstance(v, (int, float, str, bool, list))},
      'global_sparsity': float(masks_lib.calculate_sparsity(masks))
      if masks else 0.0,
      'per_layer_sparsity': {
          k: float(v)
          for k, v in masks_lib.per_layer_sparsity(masks).items()},
      **(extra_manifest or {}),
  }
  with open(os.path.join(directory, 'manifest.json'), 'w') as f:
    json.dump(manifest, f, indent=2)
  return directory


def load_for_inference(directory: str, device='cuda'
                       ) -> Tuple[Any, Dict[str, Any]]:
  """Returns (apply_fn(x) -> logits, manifest).  The model is built on
  `device` at apply_fn's first call, from the manifest's model and kwargs
  and x's (H, W, C) (flax infers the input shape the same way), and holds
  the exported arrays; apply_fn runs it in eval mode without gradients."""
  device = torch.device(device)
  if device.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError(f'load_for_inference: {device} requested but CUDA '
                       'is not available')
  with open(os.path.join(directory, 'manifest.json')) as f:
    manifest = json.load(f)
  with np.load(os.path.join(directory, 'model.npz')) as z:
    arrays = {k: z[k] for k in z.files}
  held = {}

  def build(shape):
    model = registry.create_model(
        manifest['model'], data_shape=shape, seed=0, device=device,
        **manifest.get('model_kwargs', {}))
    params = masks_lib.param_dict(model)
    missing = [p for p in params if f'params/{p}' not in arrays]
    if missing:
      raise KeyError(f'the export lacks params {missing[:6]}')
    with torch.no_grad():
      for p, t in params.items():
        t.copy_(torch.from_numpy(arrays[f'params/{p}']))
      for n, b in model.named_buffers():
        key = f'batch_stats/{masks_lib.path_str(n)}'
        if key in arrays:
          b.copy_(torch.from_numpy(arrays[key]))
    return model

  def apply_fn(x):
    x = torch.as_tensor(x).to(device)
    if 'model' not in held:
      held['model'] = build(tuple(x.shape[1:]))
    with torch.no_grad():
      return held['model'](x, train=False)

  return apply_fn, manifest
