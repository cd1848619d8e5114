"""Dense layer executing through the block-sparse kernels, in PyTorch.

Counterpart of rigl_tpu/layers/block_sparse_dense.py: y = x @ (mask *
kernel) + b, where the forward and backward products skip the inactive
blocks of a block-granular mask (block_sparse_v3, the occupancy form)
instead of multiplying by it.  The element mask is the buffer 'mask'
(JAX's 'masks' collection entry 'kernel'), so the drop/grow machinery
updates it as any mask; the kernels read its block-pooled occupancy.  The
weight gradient follows block_sparse_matmul_v3's 'auto' rule.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from rigl_tpu_torch.ops import block_mask as bm_lib
from rigl_tpu_torch.ops.block_sparse_v3 import block_sparse_matmul_v3


class BlockSparseDense(nn.Module):
  """y = x @ (mask * kernel) + b with block-skipping execution.  The
  kernel dims must divide `block`; rows need no padding (the kernels
  mask ragged m; `bm` is kept for the JAX signature)."""

  def __init__(self, in_features: int, features: int,
               block: Tuple[int, int] = (512, 512), bm: int = 512,
               use_bias: bool = True, dtype: torch.dtype = torch.float32,
               generator: Optional[torch.Generator] = None, device='cuda'):
    super().__init__()
    bk, bn = block
    if in_features % bk or features % bn:
      raise ValueError(f'kernel ({in_features}, {features}) must divide '
                       f'block {tuple(block)}')
    self.block, self.bm, self.dtype = tuple(block), bm, dtype
    gdev = generator.device if generator is not None else None
    self.kernel = nn.Parameter(
        (torch.randn(in_features, features, generator=generator, device=gdev)
         / math.sqrt(in_features)).to(device))
    self.bias = (nn.Parameter(torch.zeros(features, device=device))
                 if use_bias else None)
    self.register_buffer('mask', torch.ones(in_features, features,
                                            device=device))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    block_mask = (bm_lib.pool_to_blocks(self.mask, self.block, 'max')
                  > 0).to(torch.int32)
    lead = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1]).to(self.dtype).contiguous()
    w = (self.kernel * self.mask).to(self.dtype)
    y = block_sparse_matmul_v3(x2d, w, block_mask, self.block, self.bm)
    y = y.reshape(lead + (w.shape[1],))
    if self.bias is not None:
      y = y + self.bias.to(self.dtype)
    return y
