"""Gather-form block-sparse matmul over DENSE weight storage, in PyTorch.

Counterpart of rigl_tpu/ops/pallas/block_sparse_v2.py.  The block mask
is reduced on the device to, per output block-column j, the count of its
active k-blocks and a front-packed index list (`pack_block_indices`,
which block_sparse_v3.py imports from here, as JAX's v3 does).

`block_sparse_matmul_gather(x, w, block_mask)` is y = x @ (mask * w),
forward only, as JAX's (its entry has no VJP: a backward through it
raises NotImplementedError).  The TPU kernel `_gather_kernel` walks
count[j] active k-blocks per output tile with double-buffered manual DMA;
here the same sums run on the mm kernels of csrc/packed_mm.cu in their
dense storage mode over those lists (block_sparse_v3.occupancy_lists),
which load only the active blocks' x and W tiles, so inactive blocks
cost no traffic either.  CPU tensors take the plain
version (block_sparse_v3.dense_mm_reference); CUDA tensors launch the
kernel or raise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# Launches of the mm kernels' dense forward through this module's entry
# (B11).  Its wrapper adds one per launch; nothing else touches it but
# callers resetting it.
gather_launches = 0


def pack_block_indices(block_mask: torch.Tensor):
  """(K/bk, N/bn) mask -> (counts (N/bn,), idx (N/bn, K/bk)), int32, with
  each column's active k-blocks first, ascending (a stable sort)."""
  m = torch.as_tensor(block_mask).to(torch.int32)
  counts = m.sum(0).to(torch.int32)
  order = torch.argsort(-m, dim=0, stable=True)
  return counts, order.T.to(torch.int32).contiguous()


def gather_matmul_cuda(x, w, lists, block, mode='fwd'):
  """block_sparse_v3.dense_mm_cuda counted in gather_launches."""
  global gather_launches
  from rigl_tpu_torch.ops import block_sparse_v3 as v3  # v3 imports this
  y = v3.dense_mm_cuda(x, w, lists, block, mode)
  gather_launches += bool(x.shape[0])
  return y


def block_sparse_matmul_gather(x: torch.Tensor, w: torch.Tensor,
                               block_mask: torch.Tensor,
                               block: Tuple[int, int] = (512, 512),
                               bm: int = 512,
                               interpret: Optional[bool] = None):
  """y = x @ (expanded(block_mask) * w) in x's dtype, forward only.

  x (m, K), w (K, N) dense storage, block_mask (K/bk, N/bn), nonzero =
  active.  m, K and N must divide bm, bk and bn, as JAX requires
  (ValueError otherwise), though the kernel would mask a ragged m.
  `interpret` is kept for the JAX signature."""
  from rigl_tpu_torch.ops import block_sparse_v3 as v3  # v3 imports this
  del interpret
  bk, bn = block
  v3._check_shapes(x, w, (bk, bn))
  m, kdim = x.shape
  n = w.shape[1]
  if m % bm or kdim % bk or n % bn:
    raise ValueError(f'shapes ({m},{kdim},{n}) must divide tiles '
                     f'bm={bm}, block={tuple(block)}')
  occ = (torch.as_tensor(block_mask).to(x.device).to(torch.int32) != 0).to(
      torch.int32)
  lists = v3.occupancy_lists(occ, (bk, bn), n)
  return v3.forward_only('block_sparse_matmul_gather', v3.matmul_lists,
                         x.contiguous(), w.contiguous(), lists, (bk, bn),
                         'fwd', gather_matmul_cuda)
