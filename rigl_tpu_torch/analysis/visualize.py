"""Mask-record visualization.

Counterpart of rigl_tpu/analysis/visualize.py (capability parity with
rigl/mnist/visualize_mask_records.py:16-60): animate the per-input-pixel
count of outgoing connections of the first layer over training, from the
mask snapshots the MNIST driver records.  numpy, as in JAX; masks may be
torch tensors on any device.  The GIF needs matplotlib, imported only
when one is written.
"""

from __future__ import annotations

from typing import List, Mapping, Optional

import numpy as np


def connection_counts(mask, side: Optional[int] = None) -> np.ndarray:
  """Outgoing-connection count per input unit, reshaped to an image."""
  if hasattr(mask, 'detach'):
    mask = mask.detach().cpu().numpy()
  m = np.asarray(mask)
  counts = m.reshape(m.shape[0], -1).sum(axis=1)
  if side is None:
    side = int(np.sqrt(counts.size))
  return counts[:side * side].reshape(side, side)


def animate_mask_records(records: List[Mapping[str, np.ndarray]],
                         layer: str, out_path: str, fps: int = 5,
                         side: Optional[int] = None):
  """Writes a GIF of per-pixel connection counts over training."""
  import matplotlib
  matplotlib.use('Agg')
  import matplotlib.pyplot as plt
  from matplotlib import animation

  frames = [connection_counts(r[layer], side) for r in records]
  vmax = max(f.max() for f in frames)
  fig, ax = plt.subplots(figsize=(4, 4))
  im = ax.imshow(frames[0], vmin=0, vmax=vmax, cmap='viridis')
  fig.colorbar(im, ax=ax)
  ax.set_title(f'outgoing connections: {layer}')

  def update(i):
    im.set_data(frames[i])
    ax.set_xlabel(f'snapshot {i}')
    return [im]

  anim = animation.FuncAnimation(fig, update, frames=len(frames))
  anim.save(out_path, writer=animation.PillowWriter(fps=fps))
  plt.close(fig)
  return out_path
