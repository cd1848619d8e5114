"""Loss-landscape interpolation between two parameter sets, in PyTorch.

Counterpart of rigl_tpu/analysis/interpolate.py (capability parity with
rigl_tf2/interpolate.py:80-96): evaluate the loss (and any metric fn)
along the linear path (1-t)*A + t*B, e.g. between the pre-mask-update and
post-mask-update checkpoints the trainer snapshots.  Parameter sets are
{name: tensor} dicts.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np
import torch


def interpolate_params(params_a, params_b, t: float):
  return {k: (1.0 - t) * a + t * params_b[k] for k, a in params_a.items()}


def interpolate_losses(loss_fn: Callable, params_a, params_b,
                       ts: Sequence[float] = tuple(np.linspace(0, 1, 11)),
                       ) -> List[Dict[str, float]]:
  """Evaluates `loss_fn(params)` along the interpolation path."""
  out = []
  with torch.no_grad():
    for t in ts:
      val = loss_fn(interpolate_params(params_a, params_b, float(t)))
      if isinstance(val, dict):
        out.append({'t': float(t), **{k: float(v) for k, v in val.items()}})
      else:
        out.append({'t': float(t), 'loss': float(val)})
  return out
