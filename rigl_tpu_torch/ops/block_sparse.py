"""Block-skipping matmul over DENSE weight storage (v1), in PyTorch.

Counterpart of rigl_tpu/ops/pallas/block_sparse.py: a training step of
y = x @ (expanded(block_mask) * w) as one torch.autograd.Function,

  forward  y  = x @ w at the active blocks    (TPU kernel `_fwd_kernel`)
  dx       dx = gy @ (mask * w)ᵀ              (the same kernel on Wᵀ)
  dw       xᵀ @ gy at the active blocks,      (TPU kernel `_dw_kernel`)
           zeros elsewhere, in w's dtype

The TPU kernels walk a dense (M/bm, N/bn, K/bk) grid and skip the dot at
inactive blocks.  Here forward and dx run on the mm kernels of
csrc/packed_mm.cu in their dense storage mode over the occupancy's entry
lists (block_sparse_v3.occupancy_lists), which visit only the active
blocks; dx reads W transposed in place where JAX builds w.T.  dw runs on
the dw kernels (`packed_dw_wgmma_kernel` in bf16, `packed_dw_3xtf32_kernel`
in f32, their m-sum split as block_sparse_packed.dw_plan says) in their
dense mode over every block of the grid with its occupancy as the flag
(block_sparse_v3.occupancy_dw_entries), into a zeroed (K, N).  JAX pads
the rows to `bm`; the kernels mask ragged rows, so nothing is padded and
the real rows' outputs are the same.  CPU tensors take the plain
versions (block_sparse_v3.dense_mm_reference and dense_dw_reference);
CUDA tensors launch the kernels or raise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from rigl_tpu_torch.ops import block_sparse_v3 as v3
from rigl_tpu_torch.ops.block_mask import expand_from_blocks

# Launches of each kernel mode through this module's entry (B12).  Each
# wrapper adds one per launch; nothing else touches them but callers
# resetting them.
v1_fwd_launches = 0   # the mm kernels, dense forward
v1_dx_launches = 0    # the mm kernels, dense dx
v1_dw_launches = 0    # the dw kernels, dense mode


def v1_matmul_cuda(x, w, lists, block, mode='fwd'):
  """block_sparse_v3.dense_mm_cuda counted in v1_fwd_launches /
  v1_dx_launches."""
  global v1_fwd_launches, v1_dx_launches
  y = v3.dense_mm_cuda(x, w, lists, block, mode)
  if x.shape[0]:
    if mode == 'dx':
      v1_dx_launches += 1
    else:
      v1_fwd_launches += 1
  return y


def v1_dw_cuda(x, gy, w, entries, block):
  """block_sparse_v3.dense_dw_launch counted in v1_dw_launches."""
  global v1_dw_launches
  dw, launched = v3.dense_dw_launch(x, gy, w, entries, block)
  v1_dw_launches += launched
  return dw


class _BlockSparseMatmul(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, w, occ, block):
    ctx.save_for_backward(x, w, occ)
    ctx.block = block
    lists = v3.occupancy_lists(occ, block, w.shape[1])
    return v3.matmul_lists(x, w, lists, block, 'fwd', v1_matmul_cuda)

  @staticmethod
  def backward(ctx, gy):
    x, w, occ = ctx.saved_tensors
    block = ctx.block
    gy = gy.contiguous()
    dx = dw = None
    if ctx.needs_input_grad[0]:
      lists = v3.occupancy_lists(occ, block, w.shape[1], 'dx')
      dx = v3.matmul_lists(gy, w, lists, block, 'dx', v1_matmul_cuda)
    if ctx.needs_input_grad[1]:
      dw = v3.gather_dw(x, gy, w, v3.occupancy_dw_entries(occ), block,
                        v1_dw_cuda)
    return dx, dw, None, None


def block_sparse_matmul(x: torch.Tensor, w: torch.Tensor,
                        block_mask: torch.Tensor,
                        block: Tuple[int, int] = (128, 128), bm: int = 128,
                        interpret: Optional[bool] = None):
  """y = x @ (expanded(block_mask) * w) in x's dtype, differentiable in x
  and w (dw zero at inactive blocks, in w's dtype).

  x (M, K) activations, any M; w (K, N) dense storage, which block
  (bk, bn) must divide (ValueError otherwise, as JAX); block_mask
  (K/bk, N/bn), truncated to int32 as JAX does, nonzero = active.  `bm`
  (JAX's row tile and padding) and `interpret` are kept for the JAX
  signature."""
  del bm, interpret
  block = tuple(block)
  kdim, n = w.shape
  if kdim % block[0] or n % block[1]:
    raise ValueError(
        f'w shape ({kdim},{n}) must divide block {block}; pad upstream')
  v3._check_shapes(x, w, block)
  occ = (torch.as_tensor(block_mask).to(x.device).to(torch.int32) != 0).to(
      torch.int32)
  x, w = x.contiguous(), w.contiguous()
  if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
    return _BlockSparseMatmul.apply(x, w, occ, block)
  lists = v3.occupancy_lists(occ, block, n)
  return v3.matmul_lists(x, w, lists, block, 'fwd', v1_matmul_cuda)


def dense_reference(x: torch.Tensor, w: torch.Tensor,
                    block_mask: torch.Tensor, block: Tuple[int, int]):
  """Dense-times-expanded-mask reference: x @ (mask * w)."""
  mask = expand_from_blocks(torch.as_tensor(block_mask).to(w.device, w.dtype),
                            tuple(w.shape), tuple(block))
  return x @ (mask * w)
