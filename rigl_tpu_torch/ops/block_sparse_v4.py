"""Block-sparse matmul over DENSE weight storage from the flat packing of
its active blocks, in PyTorch.

Counterpart of rigl_tpu/ops/pallas/block_sparse_v4.py.  Drop/grow keeps a
block-granular layer's active count, so it is static
(SparseTraining.static_block_counts) and `pack_flat_active` lists the
n_active active blocks column-major, (cols, rows), each with one sentinel
entry.  `block_sparse_matmul_v4(x, w, cols, rows)` is y = x @ (mask * w)
as a torch.autograd.Function: dx = gy @ (mask * w)ᵀ reads the same W
blocks transposed, and dw is 'dense' (the product, summed in f32, times
the expanded occupancy) or 'gather' (the active blocks only), as in v3.

Forward and dx run on the mm kernels of csrc/packed_mm.cu (the branch by
block_sparse_packed.mm_branch) in their dense storage mode (replacing the TPU kernel `_v4_kernel`: the same sums as v3's
`_v3_kernel`, from the flat index form); the gathered dw on the dw
kernels (`packed_dw_wgmma_kernel` in bf16, `packed_dw_3xtf32_kernel` in
f32) in their dense mode over the n_active packed blocks.  The
per-column entry lists are a CSR built on the device from the packing
(flat_lists), with no wait for the device: the forward groups the actives
by column, as packed, dx by block-row (a stable sort, JAX's
pack_flat_active of the transposed occupancy).  JAX zeroes the columns the
kernel never visits with a select; here a column without actives is
written as exact zeros by the kernel and by the plain version alike.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from rigl_tpu_torch.ops import block_sparse_v3 as v3
from rigl_tpu_torch.ops.block_sparse_v3 import DenseLists, DwEntries

# Launches of each kernel mode through this module's wrappers.
v4_fwd_launches = 0   # the mm kernels, dense forward, flat-packing form
v4_dx_launches = 0    # the mm kernels, dense dx, flat-packing form


def pack_flat_active(block_mask: torch.Tensor, n_active: int):
  """(K/bk, N/bn) occupancy -> int32 (cols, rows) of the n_active active
  blocks, column-major, each followed by one sentinel entry (-1 / 0).

  `n_active` must equal the true active count; a stable sort puts the
  active blocks first in column-major order, as JAX's stable argsort."""
  occ = torch.as_tensor(block_mask)
  nk = occ.shape[0]
  flat_cm = occ.to(torch.int32).T.reshape(-1)
  order = torch.argsort(-flat_cm, stable=True)[:n_active].to(torch.int32)
  cols = torch.cat([order // nk,
                    torch.full((1,), -1, dtype=torch.int32,
                               device=occ.device)])
  rows = torch.cat([order % nk,
                    torch.zeros(1, dtype=torch.int32, device=occ.device)])
  return cols, rows


class Packing(dict):
  """A packing in JAX's dict form that also keeps what the kernels derive
  from it on each call (entry lists, an occupancy): a packing is replaced,
  never changed in place, when the mask changes, so they are derived once
  per mask update instead of once per call."""

  def __init__(self, **entries):
    super().__init__(**entries)
    self._derived = {}

  def derived(self, key, make):
    """make() the first time `key` is asked for; the kept value after."""
    if key not in self._derived:
      self._derived[key] = make()
    return self._derived[key]


class FlatPacking(Packing):
  """A pack_flat_active packing as the {'cols', 'rows'} entry of a layer
  (JAX's form), which the 1x1 conv's lists and occupancy are kept on."""

  def __init__(self, cols: torch.Tensor, rows: torch.Tensor):
    super().__init__(cols=cols, rows=rows)


def _occupancy(cols: torch.Tensor, rows: torch.Tensor, nk: int, nn_: int):
  """The (K/bk, N/bn) int32 occupancy of a flat packing.  A scatter, not
  an indexed assignment, which would wait for the device."""
  flat = torch.zeros(nk * nn_, dtype=torch.int32, device=cols.device)
  idx = rows[:-1].long() * nn_ + cols[:-1].long()
  return flat.scatter_(0, idx, 1).view(nk, nn_)


def _csr(group: torch.Tensor, n_groups: int):
  """(beg, end) int64 of entries sorted by `group`, on its device."""
  counts = torch.zeros(n_groups, dtype=torch.int64, device=group.device)
  counts.index_add_(0, group, torch.ones_like(group))
  end = torch.cumsum(counts, 0)
  return end - counts, end


def flat_lists(cols: torch.Tensor, rows: torch.Tensor,
               block: Tuple[int, int], w_shape: Tuple[int, int],
               mode: str = 'fwd') -> DenseLists:
  """The entries of a flat packing over a dense (K, N) weight: for the
  forward by output column in packed order, for dx by block-row (stable,
  so each row's columns ascend)."""
  bk, bn = block
  kdim, n = w_shape
  c = cols[:-1].long()
  r = rows[:-1].long()
  woffs = r * bk * n + c * bn
  if mode == 'dx':
    order = torch.argsort(r, stable=True)
    beg, end = _csr(r[order], kdim // bk)
    seg, woffs = c[order], woffs[order]
  else:
    beg, end = _csr(c, n // bn)
    seg = r
  i32 = v3._i32
  return DenseLists(i32(beg), i32(end), i32(seg), i32(woffs))


def flat_dw_entries(cols: torch.Tensor, rows: torch.Tensor) -> DwEntries:
  """The n_active packed blocks, all written (no flags)."""
  return DwEntries(v3._i32(rows[:-1]), v3._i32(cols[:-1]), None)


def v4_matmul_cuda(x: torch.Tensor, w: torch.Tensor, lists: DenseLists,
                   block: Tuple[int, int], mode: str = 'fwd'):
  """dense_mm_cuda counted in v4_fwd_launches / v4_dx_launches."""
  global v4_fwd_launches, v4_dx_launches
  y = v3.dense_mm_cuda(x, w, lists, block, mode)
  if x.shape[0]:
    if mode == 'dx':
      v4_dx_launches += 1
    else:
      v4_fwd_launches += 1
  return y


def _v4_impl(x, w, cols, rows, block):
  """The forward without autograd."""
  lists = flat_lists(cols, rows, block, tuple(w.shape))
  return v3.matmul_lists(x, w, lists, block, 'fwd', v4_matmul_cuda)


def v4_dx(gy, w, cols, rows, block):
  """dx = gy @ (mask * w)ᵀ of a flat packing, W read transposed."""
  lists = flat_lists(cols, rows, block, tuple(w.shape), 'dx')
  return v3.matmul_lists(gy, w, lists, block, 'dx', v4_matmul_cuda)


def v4_dw(x, gy, w, cols, rows, block, dw_mode):
  """dw of a flat packing by `dw_mode` ('auto' resolved by
  v3.dw_mode_for)."""
  if v3.dw_mode_for(tuple(w.shape), block, dw_mode) == 'dense':
    nk, nn_ = w.shape[0] // block[0], w.shape[1] // block[1]
    return v3.masked_dense_dw(x, gy, _occupancy(cols, rows, nk, nn_), block,
                              w.dtype)
  return v3.gather_dw(x, gy, w, flat_dw_entries(cols, rows), block)


class _V4Matmul(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, w, cols, rows, block, dw_mode):
    ctx.save_for_backward(x, w, cols, rows)
    ctx.block, ctx.dw_mode = block, dw_mode
    return _v4_impl(x, w, cols, rows, block)

  @staticmethod
  def backward(ctx, gy):
    x, w, cols, rows = ctx.saved_tensors
    gy = gy.contiguous()
    dx = dw = None
    if ctx.needs_input_grad[0]:
      dx = v4_dx(gy, w, cols, rows, ctx.block)
    if ctx.needs_input_grad[1]:
      dw = v4_dw(x, gy, w, cols, rows, ctx.block, ctx.dw_mode)
    return dx, dw, None, None, None, None


def block_sparse_matmul_v4(x: torch.Tensor, w: torch.Tensor,
                           cols: torch.Tensor, rows: torch.Tensor,
                           block: Tuple[int, int] = (128, 128),
                           bm: int = 512,
                           interpret: Optional[bool] = None,
                           dw_mode: str = 'auto'):
  """y = x @ (mask * w) where mask's active blocks are (rows[s], cols[s]),
  differentiable in x and w.

  cols / rows: int32 (n_active + 1,) from pack_flat_active.  `bm` and
  `interpret` are kept for the JAX signature: the kernels mask ragged m,
  and CPU tensors take the plain version."""
  del bm, interpret
  block = tuple(block)
  v3._check_shapes(x, w, block)
  v3.dw_mode_for(tuple(w.shape), block, dw_mode)
  cols = torch.as_tensor(cols).to(x.device, torch.int32)
  rows = torch.as_tensor(rows).to(x.device, torch.int32)
  if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
    return _V4Matmul.apply(x, w, cols, rows, block, dw_mode)
  return _v4_impl(x, w, cols, rows, block)
