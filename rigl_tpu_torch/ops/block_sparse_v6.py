"""Block-sparse matmul v6 over DENSE weight storage, from the entry packing
with one dummy per output column, in PyTorch.

Counterpart of rigl_tpu/ops/pallas/block_sparse_v6.py.  `pack_columns`
lists a (K/bk, N/bn) occupancy's n_active active blocks column-major,
each output column's run ended by one dummy entry (valid = 0, row 0), so
the entry count n_active + N/bn stays static through drop/grow;
`make_packing` gives both orientations, {'fwd': occupancy, 'bwd': its
transpose}.  `block_sparse_matmul_v6(x, w, packing)` is y = x @ (mask *
w) as a torch.autograd.Function:

  forward  runs on the mm kernels of csrc/packed_mm.cu in their dense
           storage mode (replacing the TPU kernel `_v6_kernel`), over a
           CSR of packing['fwd']'s valid entries;
  dx       the same kernel's dense dx mode over packing['bwd'] (cols are
           k-blocks, rows n-blocks): W's blocks read transposed in place,
           as JAX contracts the stored tiles on their N axis;
  dw       no kernel, as in JAX's `_v6_bwd`: xᵀ @ gy times the occupancy
           that the valid entries give (block_sparse_v3.masked_dense_dw).

In the TPU kernel a column's dummy entry zero-fills an output tile with no
active block.  Here the dummies are never visited: a column's entries are
[beg, end) of its run without the dummy, and an empty run writes exact
zeros, in the kernel and in the plain version alike.  The CSR is built on
the device from the packing alone (a scatter and a cumsum, no wait for
the host) and kept on the packing (block_sparse_v4.Packing) when
make_packing built it.  There is no bias or activation epilogue: JAX's
kernel has none either.  The kernels mask ragged m, so `bm` is unused.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from rigl_tpu_torch.ops import block_sparse_v3 as v3
from rigl_tpu_torch.ops.block_sparse_v3 import DenseLists
from rigl_tpu_torch.ops.block_sparse_v4 import Packing

# Launches of each kernel mode through this module's entry (B10).  Each
# wrapper adds one per launch; nothing else touches them but callers
# resetting them.
v6_fwd_launches = 0   # the mm kernels, dense forward
v6_dx_launches = 0    # the mm kernels, dense dx


def pack_columns(block_mask: torch.Tensor, n_active: int):
  """(nk, nn) occupancy -> int32 (cols, rows, valid), each (n_active + nn,),
  on the mask's device: the actives column-major, each column's run ended
  by one dummy (valid 0, row 0).  n_active must equal the true active
  count.  JAX's keys and stable sort, so the lists are equal element for
  element; no wait for the device."""
  occ = torch.as_tensor(block_mask)
  nk, nn_ = occ.shape
  dev = occ.device
  n_entries = n_active + nn_
  col = torch.arange(nn_, dtype=torch.int64, device=dev)
  row = torch.arange(nk, dtype=torch.int64, device=dev)
  key_real = col[None, :] * (nk + 1) + row[:, None]
  key_real = torch.where(occ.to(torch.int32) > 0, key_real,
                         (nn_ + 1) * (nk + 1)).T.reshape(-1)
  keys = torch.cat([key_real, col * (nk + 1) + nk])
  keys = torch.sort(keys, stable=True).values[:n_entries]
  cols = keys // (nk + 1)
  rem = keys % (nk + 1)
  rows = torch.where(rem == nk, 0, rem)
  valid = rem != nk
  i32 = torch.int32
  return cols.to(i32), rows.to(i32), valid.to(i32)


def make_packing(block_mask: torch.Tensor, n_active: int) -> Packing:
  """Both orientations of pack_columns for block_sparse_matmul_v6."""
  occ = torch.as_tensor(block_mask)
  return Packing(fwd=pack_columns(occ, n_active),
                 bwd=pack_columns(occ.T, n_active))


def entry_lists(cols: torch.Tensor, rows: torch.Tensor, valid: torch.Tensor,
                block: Tuple[int, int], n: int, n_groups: int,
                mode: str = 'fwd') -> DenseLists:
  """The kernel's entries of one pack_columns orientation over a dense
  (K, N = n) weight: group g's run [beg[g], end[g]) is its valid entries,
  each reading input block rows[e] and the W block (rows[e], cols[e]) of
  the forward ((cols[e], rows[e]) for dx, over the transposed packing)."""
  bk, bn = block
  c, r = cols.long(), rows.long()
  # n_groups + 2 bins: past the last run, a packing holds no entry whose
  # col exceeds n_groups + 1 (JAX's key of an inactive block).
  counts = torch.zeros(n_groups + 2, dtype=torch.int64, device=c.device)
  counts.index_add_(0, c, valid.long())
  counts = counts[:n_groups]
  run_end = torch.cumsum(counts + 1, 0)   # each run holds one dummy
  beg = run_end - counts - 1
  woffs = c * bk * n + r * bn if mode == 'dx' else r * bk * n + c * bn
  i32 = v3._i32
  return DenseLists(i32(beg), i32(beg + counts), i32(r), i32(woffs))


def _lists(packing, block, w_shape, mode):
  """The entry lists of packing['fwd'] (mode 'fwd') or ['bwd'] ('dx'),
  kept on a make_packing packing."""
  kdim, n = w_shape
  key = 'bwd' if mode == 'dx' else 'fwd'
  groups = kdim // block[0] if mode == 'dx' else n // block[1]

  def make():
    return entry_lists(*packing[key], block, n, groups, mode)
  if isinstance(packing, Packing):
    return packing.derived(('v6', key, tuple(block), n), make)
  return make()


def _occupancy(packing, block, w_shape):
  """(K/bk, N/bn) int32: 1 where a valid forward entry lies (JAX's
  .at[rows, cols].max(valid))."""
  kdim, n = w_shape
  nk, nn_ = kdim // block[0], n // block[1]

  def make():
    cols, rows, valid = (t.long() for t in packing['fwd'])
    flat = torch.zeros(nk * nn_, dtype=torch.int64, device=cols.device)
    idx = (rows * nn_ + cols).clamp(max=nk * nn_ - 1)
    flat.scatter_reduce_(0, idx, valid * (cols < nn_), 'amax')
    return flat.view(nk, nn_).to(torch.int32)
  if isinstance(packing, Packing):
    return packing.derived(('v6 occupancy', tuple(block), kdim, n), make)
  return make()


def v6_matmul_cuda(x, w, lists, block, mode='fwd'):
  """block_sparse_v3.dense_mm_cuda counted in v6_fwd_launches /
  v6_dx_launches."""
  global v6_fwd_launches, v6_dx_launches
  y = v3.dense_mm_cuda(x, w, lists, block, mode)
  if x.shape[0]:
    if mode == 'dx':
      v6_dx_launches += 1
    else:
      v6_fwd_launches += 1
  return y


def _v6_impl(x, w, packing, block):
  lists = _lists(packing, block, tuple(w.shape), 'fwd')
  return v3.matmul_lists(x, w, lists, block, 'fwd', v6_matmul_cuda)


class _V6Matmul(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x, w, packing, block):
    ctx.save_for_backward(x, w)
    ctx.packing, ctx.block = packing, block
    return _v6_impl(x, w, packing, block)

  @staticmethod
  def backward(ctx, gy):
    x, w = ctx.saved_tensors
    packing, block = ctx.packing, ctx.block
    gy = gy.contiguous()
    dx = dw = None
    if ctx.needs_input_grad[0]:
      lists = _lists(packing, block, tuple(w.shape), 'dx')
      dx = v3.matmul_lists(gy, w, lists, block, 'dx', v6_matmul_cuda)
    if ctx.needs_input_grad[1]:
      occ = _occupancy(packing, block, tuple(w.shape))
      dw = v3.masked_dense_dw(x, gy, occ, block, w.dtype)
    return dx, dw, None, None


def block_sparse_matmul_v6(x: torch.Tensor, w: torch.Tensor, packing,
                           block: Tuple[int, int] = (512, 512),
                           bm: int = 512,
                           interpret: Optional[bool] = None,
                           dw_mode: str = 'dense'):
  """y = x @ (expand(block_mask) * w) in x's dtype, differentiable in x
  and w.

  packing: {'fwd', 'bwd'} = (cols, rows, valid) of pack_columns(occ) and
  pack_columns(occ.T) (make_packing: build once per mask update, not per
  step).  dw is xᵀ @ gy at the active blocks, zeros elsewhere, in w's
  dtype.  `bm`, `interpret` and `dw_mode` are kept for the JAX signature;
  JAX's backward ignores dw_mode too."""
  del bm, interpret, dw_mode
  block = tuple(block)
  v3._check_shapes(x, w, block)
  if not isinstance(packing, Packing):
    packing = {k: tuple(torch.as_tensor(t).to(x.device) for t in v)
               for k, v in packing.items()}
  x, w = x.contiguous(), w.contiguous()
  if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
    return _V6Matmul.apply(x, w, packing, block)
  return _v6_impl(x, w, packing, block)
