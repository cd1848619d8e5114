"""PackedDense: a dense layer whose kernel IS packed block-sparse storage.

Counterpart of rigl_tpu/layers/packed_dense.py.  The parameter is the
`(n_active, bk, bn)` packed array; the Packing (the entry lists) is a
plain attribute of the layer.  The JAX layer keeps an f32 parameter and
casts it to `dtype` on every call; this one stores it in `dtype`, which
gives the same numbers for one cast instead of many.

Gradients flow through packed_matmul's autograd Function: on the card
its dx and packed-dw kernels, on the CPU their plain versions.  The
kernels mask ragged rows themselves, so the JAX layer's `_pad_rows` has no
counterpart.  Tensor parallelism (`tp_shards > 1`, `_tp_kernel_matmul`)
is not ported yet and raises NotImplementedError.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from rigl_tpu_torch.ops.block_sparse_packed import (Packing, make_packing,
                                                    packed_matmul)
from rigl_tpu_torch.sparsity.distributions import get_n_zeros
from rigl_tpu_torch.sparsity.layer_sparsity import resolve_sparsity


def random_occupancy(generator: Optional[torch.Generator], nk: int, nn_: int,
                     n_active: int) -> torch.Tensor:
  """Exact-count random (nk, nn) int32 occupancy grid, on the CPU."""
  scores = torch.rand(nk * nn_, generator=generator,
                      device=generator.device if generator else None)
  order = torch.argsort(-scores).cpu()
  grid = torch.zeros(nk * nn_, dtype=torch.int32)
  grid[order[:n_active]] = 1
  return grid.reshape(nk, nn_)


def packed_kernel_matmul(x2d: torch.Tensor, kernel: torch.Tensor,
                         packing: Packing, block: Tuple[int, int],
                         bm: int = 512) -> torch.Tensor:
  """x2d @ W for the packed `kernel`: the engine behind PackedDense."""
  return packed_matmul(x2d, kernel, packing, block, bm)


class PackedDense(nn.Module):
  """y = x @ W (+ b) with W stored packed at `sparsity`.

  in_features % block[0] == 0 and features % block[1] == 0.  The active
  count is n_blocks - floor(sparsity * n_blocks).  `sparsity` is a float
  or a SparsityMap resolved by `path` (this layer's module path, e.g.
  ('block0', 'attn', 'qkv')).  Active weights start at the scale of a
  dense lecun-normal kernel: normal / sqrt(in_features).  The parameters
  live on `device`, the card unless the caller names another; without a
  card, torch raises.
  """

  def __init__(self, in_features: int, features: int, *, sparsity=0.8,
               block: Tuple[int, int] = (512, 512), bm: int = 512,
               use_bias: bool = True, dtype: torch.dtype = torch.float32,
               tp_shards: int = 1, path: Sequence[str] = (),
               generator: Optional[torch.Generator] = None,
               device='cuda'):
    super().__init__()
    if tp_shards > 1:
      raise NotImplementedError('tensor-parallel packed storage '
                                '(tp_shards > 1) is not ported yet')
    bk, bn = block
    if in_features % bk or features % bn:
      raise ValueError(f'({in_features}, {features}) must divide '
                       f'block {block}')
    self.in_features, self.features = in_features, features
    self.block, self.bm, self.dtype = tuple(block), bm, dtype
    nk, nn_ = in_features // bk, features // bn
    n_total = nk * nn_
    s = resolve_sparsity(sparsity, tuple(path))
    n_active = n_total - get_n_zeros(n_total, s)
    self.packing = make_packing(
        random_occupancy(generator, nk, nn_, n_active), n_active)
    gdev = generator.device if generator else None
    kernel = torch.randn((n_active, bk, bn), generator=generator, device=gdev)
    self.kernel = nn.Parameter(
        (kernel / math.sqrt(in_features)).to(device=device, dtype=dtype))
    self.bias = (nn.Parameter(torch.zeros(features, dtype=dtype,
                                          device=device))
                 if use_bias else None)

  def set_packing(self, packing: Packing):
    """Swap in another occupancy with the same grid and active count."""
    nk, nn_ = self.in_features // self.block[0], self.features // self.block[1]
    if packing.shape != (nk, nn_) or packing.n_active != self.kernel.shape[0]:
      raise ValueError(f'packing {packing.shape} with {packing.n_active} '
                       f'actives does not fit {(nk, nn_)} with '
                       f'{self.kernel.shape[0]}')
    self.packing = packing

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    lead = x.shape[:-1]
    x2d = x.reshape(-1, self.in_features).to(self.dtype).contiguous()
    y = packed_kernel_matmul(x2d, self.kernel, self.packing, self.block,
                             self.bm)
    y = y.reshape(*lead, self.features)
    if self.bias is not None:
      y = y + self.bias
    return y
