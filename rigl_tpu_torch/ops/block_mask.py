"""Block-granular masks: pooling scores onto the block grid and broadcasting
a block mask back, in PyTorch.

Counterpart of rigl_tpu/ops/block_mask.py's `pool_to_blocks` and
`expand_from_blocks`.  A kernel's 2D matmul view is (rows = inputs, cols =
outputs); a conv kernel (kh, kw, cin, cout) flattens to (cin*kh*kw, cout),
the im2col row order.  The tap layout and the collection helpers of the
JAX module are not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _to_2d(x: torch.Tensor) -> torch.Tensor:
  """The canonical 2D matmul view."""
  if x.dim() == 4:
    kh, kw, cin, cout = x.shape
    return x.permute(2, 0, 1, 3).reshape(cin * kh * kw, cout)
  return x.reshape(-1, x.shape[-1])


def _from_2d(v: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
  """Inverse of _to_2d."""
  if len(shape) == 4:
    kh, kw, cin, cout = shape
    return v.reshape(cin, kh, kw, cout).permute(1, 2, 0, 3)
  return v.reshape(shape)


def pool_to_blocks(x: torch.Tensor, block: Tuple[int, int],
                   reduce: str = 'sum') -> torch.Tensor:
  """Sum/max/mean-pools a 2D-viewed tensor into block cells.

  Requires block dims to divide the 2D view (pad upstream if not).
  """
  v2 = _to_2d(x)
  rows, cols = v2.shape
  br, bc = block
  if rows % br or cols % bc:
    raise ValueError(f'block {block} does not divide 2D view ({rows},{cols})')
  v = v2.reshape(rows // br, br, cols // bc, bc)
  if reduce == 'sum':
    return v.sum(dim=(1, 3))
  if reduce == 'max':
    return v.amax(dim=(1, 3))
  if reduce == 'mean':
    return v.mean(dim=(1, 3))
  raise ValueError(reduce)


def expand_from_blocks(block_mask: torch.Tensor, shape: Tuple[int, ...],
                       block: Tuple[int, int]) -> torch.Tensor:
  """Broadcasts a block mask back to the element-granular kernel shape."""
  br, bc = block
  m = block_mask.repeat_interleave(br, dim=0).repeat_interleave(bc, dim=1)
  return _from_2d(m, tuple(shape))
