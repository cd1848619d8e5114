"""Conv routing onto the dense-storage block-sparse matmuls, in PyTorch.

Counterpart of rigl_tpu/ops/conv.py.  A 1x1 convolution is a matmul over
the channel dims, so `block_sparse_conv1x1` runs it on the block-skipping
kernels of block_sparse_v3 / block_sparse_v4: an occupancy entry takes the
per-column index lists (v3), a {'cols', 'rows'} flat packing the v4 lists.
Its backward is its own, as in JAX: dx runs the kernel's transposed mode
(the W blocks read transposed in place), and dw is the product
x2dᵀ @ gy2d, summed in f32, times the expanded occupancy, in the kernel's
dtype (JAX emits it as an XLA conv-backward-filter outside any Pallas
kernel; here it is one torch.matmul, block_sparse_v3.masked_dense_dw).  `block_sparse_conv2d` is the general conv through
im2col (torch's unfold orders patch features (Cin, kh, kw), as
lax.conv_general_dilated_patches does) and the differentiable matmuls.

Activations are NHWC and kernels HWIO, as in JAX.  Rows are not padded to
`bm`: the kernels mask ragged m.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from rigl_tpu_torch.ops import block_sparse_v3 as v3
from rigl_tpu_torch.ops import block_sparse_v4 as v4


def _is_flat(block_mask) -> bool:
  return isinstance(block_mask, dict)


def _dispatch_matmul(x2d, kernel2d, block_mask, block, bm, interpret):
  """Occupancy -> v3; {'cols', 'rows'} flat packing -> v4 (both
  differentiable)."""
  if _is_flat(block_mask):
    return v4.block_sparse_matmul_v4(x2d, kernel2d, block_mask['cols'],
                                     block_mask['rows'], block, bm, interpret)
  return v3.block_sparse_matmul_v3(x2d, kernel2d, block_mask, block, bm,
                                   interpret)


def _kept(block_mask, key, make):
  """make(), kept on a FlatPacking entry (derived once per mask update)."""
  if isinstance(block_mask, v4.FlatPacking):
    return block_mask.derived(key, make)
  return make()


def _occupancy_of(block_mask, nk: int, nn_: int, device):
  if _is_flat(block_mask):
    return _kept(block_mask, ('occupancy', nk, nn_, str(device)),
                 lambda: v4._occupancy(block_mask['cols'].to(device),
                                       block_mask['rows'].to(device), nk,
                                       nn_))
  return torch.as_tensor(block_mask).to(device, torch.int32)


def _lists(block_mask, block, w_shape, mode, device):
  if _is_flat(block_mask):
    return _kept(block_mask, (mode, block, w_shape, str(device)),
                 lambda: v4.flat_lists(
                     block_mask['cols'].to(device, torch.int32),
                     block_mask['rows'].to(device, torch.int32), block,
                     w_shape, mode))
  return v3.occupancy_lists(torch.as_tensor(block_mask).to(device),
                            block, w_shape[1], mode)


def _matmul_2d(x2d, kernel2d, block_mask, block, mode):
  """One product of the 1x1 conv without autograd: the forward or dx,
  counted as v4 or v3 by the entry's form."""
  lists = _lists(block_mask, block, tuple(kernel2d.shape), mode, x2d.device)
  kernel = v4.v4_matmul_cuda if _is_flat(block_mask) else v3.v3_matmul_cuda
  return v3.matmul_lists(x2d, kernel2d, lists, block, mode, kernel)


class _Conv1x1(torch.autograd.Function):
  """(N, H, W, Cin) -> (N, H, W, Cout) through the block matmul; backward:
  dx through the transposed mode, dw = x2dᵀ @ gy2d times the expanded
  occupancy."""

  @staticmethod
  def forward(ctx, x, kernel2d, block_mask, block):
    n, h, w_dim, cin = x.shape
    x2d = x.reshape(-1, cin)
    y = _matmul_2d(x2d, kernel2d, block_mask, block, 'fwd')
    ctx.save_for_backward(x2d, kernel2d)
    ctx.block_mask, ctx.block = block_mask, block
    return y.reshape(n, h, w_dim, kernel2d.shape[1])

  @staticmethod
  def backward(ctx, gy):
    x2d, kernel2d = ctx.saved_tensors
    block_mask, block = ctx.block_mask, ctx.block
    cin, cout = kernel2d.shape
    gy2d = gy.reshape(-1, cout).contiguous()
    dx = dw = None
    if ctx.needs_input_grad[0]:
      dx = _matmul_2d(gy2d, kernel2d, block_mask, block, 'dx').reshape(
          gy.shape[:3] + (cin,))
    if ctx.needs_input_grad[1]:
      occ = _occupancy_of(block_mask, cin // block[0], cout // block[1],
                          x2d.device)
      dw = v3.masked_dense_dw(x2d, gy2d, occ, block, kernel2d.dtype)
    return dx, dw, None, None


def block_sparse_conv1x1(x: torch.Tensor, kernel: torch.Tensor, block_mask,
                         stride: int = 1,
                         block: Tuple[int, int] = (512, 512),
                         bm: int = 512,
                         interpret: Optional[bool] = None) -> torch.Tensor:
  """NHWC 1x1 conv via the block-skipping matmul.

  x: (N, H, W, Cin); kernel: (1, 1, Cin, Cout) or (Cin, Cout); block_mask:
  (Cin/bk, Cout/bn) occupancy or {'cols', 'rows'} v4 packing; stride: exact
  for 1x1 kernels (subsample, then the matmul).  `bm` and `interpret` are
  kept for the JAX signature."""
  del bm, interpret
  if kernel.dim() == 4:
    if tuple(kernel.shape[:2]) != (1, 1):
      raise ValueError(f'not a 1x1 kernel: {tuple(kernel.shape)}')
    kernel = kernel[0, 0]
  if stride > 1:
    x = x[:, ::stride, ::stride, :]
  x = x.contiguous()
  block = tuple(block)
  v3._check_shapes(x.view(-1, x.shape[-1]), kernel, block)
  return _Conv1x1.apply(x, kernel.contiguous(), block_mask, block)


def block_sparse_conv2d(x: torch.Tensor, kernel: torch.Tensor, block_mask,
                        stride: int = 1, padding: str = 'SAME',
                        block: Tuple[int, int] = (512, 512), bm: int = 512,
                        interpret: Optional[bool] = None) -> torch.Tensor:
  """General NHWC conv via patch extraction + block-sparse matmul.

  The kernel's 2D matmul view is (cin*kh*kw, cout) in im2col row order,
  the view ops/block_mask.py pools over, so a blockwise-trained conv mask
  plugs in directly.  block_mask: (kh*kw*Cin/bk, Cout/bn) over (Cin, kh,
  kw)-ordered rows, or its flat packing."""
  from rigl_tpu_torch.layers.packed_conv import same_pads
  kh, kw, cin, cout = kernel.shape
  if kh == 1 and kw == 1:
    return block_sparse_conv1x1(x, kernel, block_mask, stride, block, bm,
                                interpret)
  n, h, w_dim, _ = x.shape
  xc = x.permute(0, 3, 1, 2)
  if padding == 'SAME':
    (pt, pb), (pl, pr) = same_pads(h, kh, stride), same_pads(w_dim, kw,
                                                             stride)
    xc = F.pad(xc, (pl, pr, pt, pb))
  elif padding != 'VALID':
    raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
  oh = (xc.shape[2] - kh) // stride + 1
  ow = (xc.shape[3] - kw) // stride + 1
  patches = F.unfold(xc, (kh, kw), stride=stride)   # (N, Cin*kh*kw, L)
  x2d = patches.transpose(1, 2).reshape(-1, cin * kh * kw).contiguous()
  k2d = kernel.permute(2, 0, 1, 3).reshape(cin * kh * kw, cout).contiguous()
  y = _dispatch_matmul(x2d, k2d, block_mask, tuple(block), bm, interpret)
  return y.reshape(n, oh, ow, cout)
