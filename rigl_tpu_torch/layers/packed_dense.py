"""PackedDense: a dense layer whose kernel IS packed block-sparse storage.

Counterpart of rigl_tpu/layers/packed_dense.py.  The parameter is the
`(n_active, bk, bn)` packed array; the Packing (the entry lists) is a
plain attribute of the layer.  As in JAX, the parameter is float32 (the
master weights an optimizer updates) and is cast to `dtype` on every call;
the gradient reaches it through the cast.  A caller that holds the weights
fixed for many calls (serving) may cache the cast with `cached_casts`.

Gradients flow through packed_matmul's autograd Function: on the card
its dx and packed-dw kernels, on the CPU their plain versions.  The
kernels mask ragged rows themselves, so the JAX layer's `_pad_rows` has no
counterpart.  Tensor parallelism (`tp_shards > 1`, `_tp_kernel_matmul`)
is not ported yet and raises NotImplementedError.
"""

from __future__ import annotations

import contextlib
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


class MasterWeight:
  """A module whose float32 parameter (named by `weight_name`) is cast to
  its compute `dtype` on every call, as flax modules with
  param_dtype=float32 and a compute dtype do.  `cast_cache`, when set by
  `cached_casts`, stands in for that cast."""

  weight_name = 'kernel'
  cast_cache: Optional[torch.Tensor] = None

  def compute_weight(self) -> torch.Tensor:
    if self.cast_cache is not None:
      return self.cast_cache
    return getattr(self, self.weight_name).to(self.dtype)


@contextlib.contextmanager
def cached_casts(model: nn.Module):
  """Within the block, every MasterWeight module of `model` whose
  parameter is not already in its compute dtype reads one cached cast
  instead of casting on each call.  The numbers are the same; the
  parameters must not change inside the block (serving, under
  inference_mode)."""
  mods = [m for m in model.modules() if isinstance(m, MasterWeight)]
  try:
    for m in mods:
      w = getattr(m, m.weight_name)
      if w.dtype != m.dtype:
        m.cast_cache = w.detach().to(m.dtype)
    yield model
  finally:
    for m in mods:
      m.cast_cache = None


def packed_kernel_matmul(x2d: torch.Tensor, kernel: torch.Tensor,
                         packing: Packing, block: Tuple[int, int],
                         bm: int = 512) -> torch.Tensor:
  """x2d @ W for the packed `kernel`: the engine behind PackedDense."""
  return packed_matmul(x2d, kernel, packing, block, bm)


class PackedDense(MasterWeight, nn.Module):
  """y = x @ W (+ b) with W stored packed at `sparsity`.

  in_features % block[0] == 0 and features % block[1] == 0.  The active
  count is n_blocks - floor(sparsity * n_blocks).  `sparsity` is a float
  or a SparsityMap resolved by `path` (this layer's module path, e.g.
  ('block0', 'attn', 'qkv')).  Active weights start at the scale of a
  dense lecun-normal kernel: normal / sqrt(in_features).  The kernel and
  bias are float32 whatever `dtype` (the compute dtype) is.  They live on
  `device`, the card unless the caller names another; without a
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
        (kernel / math.sqrt(in_features)).to(device=device,
                                             dtype=torch.float32))
    self.bias = (nn.Parameter(torch.zeros(features, device=device))
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
    y = packed_kernel_matmul(x2d, self.compute_weight(), self.packing,
                             self.block, self.bm)
    y = y.reshape(*lead, self.features)
    if self.bias is not None:
      y = y + self.bias.to(self.dtype)
    return y
