"""Mask permutation-symmetry statistics.

Counterpart of rigl_tpu/utils/symmetry.py (capability parity with
rigl/experimental/jax/pruning/symmetry.py:30-177): output neurons
(columns of the 2D-viewed mask) that share identical input masks are
interchangeable, so the network has prod(count_i!) weight-space
permutation symmetries; fully-ablated neurons are counted separately.
numpy, as in JAX; masks may be torch tensors on any device.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping

import numpy as np


def count_permutations_mask_layer(mask) -> Dict[str, Any]:
  """Symmetry stats of one layer mask.

  Returns: unique_neurons, permutations (prod of factorials of duplicate
  column counts), zeroed_neurons, total_neurons.
  """
  if hasattr(mask, 'detach'):
    mask = mask.detach().cpu().numpy()
  m = np.asarray(mask)
  m2d = m.reshape(-1, m.shape[-1])
  cols = [tuple(m2d[:, j].tolist()) for j in range(m2d.shape[1])]
  counts: Dict[tuple, int] = {}
  for c in cols:
    counts[c] = counts.get(c, 0) + 1
  zero_col = tuple([0.0] * m2d.shape[0])
  zeroed = counts.get(zero_col, 0)
  permutations = 1
  for c in counts.values():
    permutations *= math.factorial(c)
  return {
      'unique_neurons': len(counts),
      'permutations': permutations,
      'zeroed_neurons': zeroed,
      'total_neurons': m2d.shape[1],
  }


def get_mask_stats(masks: Mapping[str, Any]) -> Dict[str, Any]:
  """Aggregates per-layer symmetry stats over a MaskDict."""
  per_layer = {p: count_permutations_mask_layer(m) for p, m in masks.items()}
  total_perm = 1
  for s in per_layer.values():
    total_perm *= s['permutations']
  return {
      'per_layer': per_layer,
      'total_permutations': total_perm,
      'total_zeroed_neurons': sum(
          s['zeroed_neurons'] for s in per_layer.values()),
      'total_neurons': sum(s['total_neurons'] for s in per_layer.values()),
  }
