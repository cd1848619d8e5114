"""Network compaction analysis for sparse MLPs.

Counterpart of rigl_tpu/utils/compression.py (capability parity with
rigl/mnist/mnist_train_eval.py:165-189, get_compressed_fc, and the
input-mask compaction at :202-207): given a sparse MLP's masks, compute
the effectively-dense compressed architecture -- drop dead input pixels
and hidden units with no incoming *or* no outgoing edges -- and report
the compressed per-layer sparsities and sizes.  numpy, as in JAX; masks
may be torch tensors on any device.
"""

from __future__ import annotations

from typing import List, Mapping, Sequence, Tuple

import numpy as np


def _np(mask) -> np.ndarray:
  if hasattr(mask, 'detach'):
    mask = mask.detach().cpu().numpy()
  return np.asarray(mask)


def live_input_indices(first_mask) -> np.ndarray:
  """Input units with at least one outgoing connection (the reference's
  input-mask compaction: pixels the network never reads can be dropped from
  the data pipeline)."""
  m = _np(first_mask)
  return np.flatnonzero(m.reshape(m.shape[0], -1).sum(axis=1) != 0)


def get_compressed_fc(masks: Sequence[np.ndarray]
                      ) -> Tuple[List[float], List[int]]:
  """Compressed architecture of a chain of dense-layer masks.

  Args:
    masks: ordered per-layer 2D masks (in x out), first layer first.

  Returns:
    (sparsities, sizes): per-layer sparsity of the compacted masks, and unit
    counts [inputs, hidden..., outputs] after removing dead units.
  """
  masks = [_np(m) for m in masks]
  # Drop dead input pixels.
  masks[0] = masks[0][live_input_indices(masks[0])]
  compressed = []
  for i, w in enumerate(masks):
    keep_out = w.sum(axis=0) != 0            # has incoming edges
    if i < len(masks) - 1:
      keep_out &= masks[i + 1].sum(axis=1) != 0   # has outgoing edges
      masks[i + 1] = masks[i + 1][keep_out]
    compressed.append(w[:, keep_out])
  sparsities = [float((m == 0).sum()) / m.size for m in compressed]
  sizes = [compressed[0].shape[0]] + [m.shape[1] for m in compressed]
  return sparsities, sizes


def compressed_fc_from_mask_dict(masks: Mapping[str, np.ndarray]
                                 ) -> Tuple[List[float], List[int]]:
  """MaskDict convenience wrapper (insertion order = layer order)."""
  return get_compressed_fc(list(masks.values()))
