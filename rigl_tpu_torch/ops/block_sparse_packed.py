"""Packed block-sparse tensors and their matmul, in PyTorch.

Counterpart of rigl_tpu/ops/pallas/block_sparse_packed.py.  A weight
matrix lives as its active blocks `(n_active, bk, bn)` plus a static
Packing: fwd and bwd entry lists `(cols, rows, slots, valid)`, each of
n_active + nn entries, ACTIVES FIRST in column-major order, then the nn
dummies (pack_columns_slots).  The index maths is the JAX package's, so a
Packing here holds the same lists element by element.

`packed_matmul` is the forward product y = x @ W.  On a CPU tensor it runs
its plain PyTorch version (`packed_matmul_reference`); on a CUDA tensor it
launches the hand-written Hopper kernel in csrc/packed_mm.cu (which
replaces the TPU kernel `_mm_kernel`) or raises.  The kernel reads a
per-column CSR of the actives (`col_ptr`, `rows`) that is built once
per Packing and device and cached on the Packing.

Not ported yet: `repack_permutation`, the transposed (dx) mode and the
packed dw (`_dw_call`), which come with training; a CUDA call that needs a
gradient raises NotImplementedError.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from rigl_tpu_torch.ops import _build

# Launches of the forward kernel in this process.  The wrapper adds one
# per launch; nothing else touches it but callers resetting it.
packed_mm_launches = 0


# ----------------------------------------------------------- packing ------
class Packing:
  """fwd/bwd entry lists + the static occupancy-grid shape (nk, nn).

  Entry lists are int32 tensors on the CPU; copies on other devices and
  the kernel's column index are derived once and cached on the object, so
  a Packing is treated as immutable."""

  def __init__(self, fwd, bwd, shape):
    self.fwd = tuple(fwd)
    self.bwd = tuple(bwd)
    self.shape = tuple(int(s) for s in shape)
    self._cache = {}

  def __getitem__(self, key):          # dict-style access, as in JAX
    return {'fwd': self.fwd, 'bwd': self.bwd, 'shape': self.shape}[key]

  @property
  def n_active(self) -> int:
    return int(self.fwd[0].shape[0]) - self.shape[1]

  def to(self, device) -> 'Packing':
    """This packing with its lists on `device` (cached)."""
    device = torch.device(device)
    if self.fwd[0].device == device:
      return self
    key = ('to', str(device))
    if key not in self._cache:
      self._cache[key] = Packing(
          tuple(t.to(device) for t in self.fwd),
          tuple(t.to(device) for t in self.bwd), self.shape)
    return self._cache[key]

  def column_index(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(col_ptr (nn + 1,), rows (n_active,)): int32 on `device`; column
    j's actives are packed slots col_ptr[j] .. col_ptr[j + 1] - 1, block-row
    rows[a] each.
    Raises if the fwd lists are not in the actives-first, column-major,
    slot == position order that pack_columns_slots makes."""
    device = torch.device(device)
    key = ('csr', str(device))
    if key not in self._cache:
      nn_ = self.shape[1]
      n_act = self.n_active
      cols, rows, slots, valid = (t[:n_act].to('cpu', torch.int64)
                                  for t in self.fwd)
      if not (torch.equal(slots, torch.arange(n_act))
              and bool((valid == 1).all())
              and bool((cols[1:] >= cols[:-1]).all())):
        raise ValueError('fwd packing is not in pack_columns_slots order '
                         '(actives first, column-major, slots == arange)')
      counts = torch.bincount(cols, minlength=nn_)
      col_ptr = torch.cat([torch.zeros(1, dtype=torch.int64),
                           torch.cumsum(counts, 0)])
      self._cache[key] = (col_ptr.to(device, torch.int32).contiguous(),
                          rows.to(device, torch.int32).contiguous())
    return self._cache[key]


def pack_columns_slots(block_mask: torch.Tensor, n_active: int):
  """(nk, nn) occupancy -> (cols, rows, slots, valid), each (n_active+nn,).

  Entry order: all actives first (column-major), then the nn dummies:
  one "attached" dummy per non-empty column, forward-filling the final
  active entry's col/row, then "empty-column" dummies carrying their own
  col.  `slots` is the packed-axis index of each entry's block, so for the
  fwd packing slots == arange over the actives.  Same maths as the JAX
  package: a stable argsort over banded keys, a cummax forward fill.
  """
  nk, nn_ = block_mask.shape
  i64 = torch.int64
  occ = block_mask.to(i64)
  n_entries = n_active + nn_
  col_idx = torch.arange(nn_, dtype=i64).expand(nk, nn_)
  row_idx = torch.arange(nk, dtype=i64)[:, None].expand(nk, nn_)
  # Sort-key bands: actives (column-major) < attached dummies <
  # empty-column dummies (by column) < inactive blocks (truncated away).
  big = nn_ * (nk + 1)
  key_real = torch.where(occ > 0, col_idx * (nk + 1) + row_idx,
                         big + nn_ + 2).T.reshape(-1)
  col_count = occ.sum(0)
  j = torch.arange(nn_, dtype=i64)
  key_dummy = torch.where(col_count == 0, big + 1 + j, big)
  keys = torch.cat([key_real, key_dummy])
  cols_all = torch.cat([col_idx.T.reshape(-1), j])
  rows_all = torch.cat([row_idx.T.reshape(-1), torch.zeros(nn_, dtype=i64)])
  valid_all = torch.cat([occ.T.reshape(-1), torch.zeros(nn_, dtype=i64)])
  order = torch.argsort(keys, stable=True)[:n_entries]
  keys = keys[order]
  cols = cols_all[order]
  rows = rows_all[order]
  valid = valid_all[order]
  pos = torch.arange(n_entries, dtype=i64)
  last_valid = torch.cummax(torch.where(valid == 1, pos, -1), 0).values
  fill = last_valid.clamp(min=0)
  rows = torch.where(valid == 1, rows,
                     torch.where(last_valid >= 0, rows[fill], 0))
  cols = torch.where((valid == 0) & (keys == big) & (last_valid >= 0),
                     cols[fill], cols)
  slots = (torch.cumsum(valid, 0) - 1).clamp(min=0)
  i32 = torch.int32
  return cols.to(i32), rows.to(i32), slots.to(i32), valid.to(i32)


def make_packing(block_mask: torch.Tensor, n_active: int) -> Packing:
  """fwd + bwd packings sharing ONE packed layout (fwd column-major): a
  bwd entry for block (k, j) gets the slot that block holds in fwd."""
  block_mask = torch.as_tensor(block_mask).cpu()
  nk, nn_ = block_mask.shape
  fc, fr, fs, fv = pack_columns_slots(block_mask, n_active)
  bc, br, _, bv = pack_columns_slots(block_mask.T, n_active)
  grid = torch.zeros(nk * nn_, dtype=torch.int32).scatter_reduce(
      0, (fr.long() * nn_ + fc.long()), torch.where(fv == 1, fs, 0),
      'amax', include_self=True).reshape(nk, nn_)
  bslots = torch.where(bv == 1, grid[bc.long(), br.long()], 0)
  return Packing((fc, fr, fs, fv), (bc, br, bslots.to(torch.int32), bv),
                 (nk, nn_))


def pack_dense(w: torch.Tensor, packing: Packing, block: Tuple[int, int]):
  """Dense (K, N) -> packed (n_active, bk, bn) in the fwd layout."""
  bk, bn = block
  nk, nn_ = packing.shape
  n_act = packing.n_active
  out = torch.zeros((n_act, bk, bn), dtype=w.dtype, device=w.device)
  if n_act == 0:
    return out
  cols, rows, slots, valid = (t.long() for t in packing.to(w.device).fwd)
  blocks = w.reshape(nk, bk, nn_, bn).permute(0, 2, 1, 3)   # (nk, nn, bk, bn)
  picked = blocks[rows, cols]                               # (n_entries, ...)
  keep = (valid == 1)[:, None, None]
  return out.index_add_(0, slots, torch.where(keep, picked, 0))


def unpack_dense(packed: torch.Tensor, packing: Packing,
                 block: Tuple[int, int], dtype=None):
  """Packed (n_active, bk, bn) -> dense (K, N) with zeros at inactive."""
  bk, bn = block
  nk, nn_ = packing.shape
  dtype = dtype or packed.dtype
  blocks = torch.zeros((nk * nn_, bk, bn), dtype=dtype, device=packed.device)
  if packing.n_active:
    cols, rows, slots, valid = (t.long() for t in packing.to(packed.device).fwd)
    vals = torch.where((valid == 1)[:, None, None], packed[slots], 0)
    blocks.index_put_((rows * nn_ + cols,), vals.to(dtype), accumulate=True)
  return (blocks.reshape(nk, nn_, bk, bn).permute(0, 2, 1, 3)
          .reshape(nk * bk, nn_ * bn))


# ------------------------------------------------------------- matmul -----
def packed_matmul_reference(x: torch.Tensor, w_packed: torch.Tensor,
                            packing: Packing, block: Tuple[int, int]):
  """Plain version: x @ unpack_dense(w), summed in f32, cast once to
  x.dtype (empty columns are zero by construction)."""
  w = unpack_dense(w_packed, packing, block)
  return (x.float() @ w.float()).to(x.dtype)


@functools.cache
def _kernel():
  fn = _build.load('packed_mm').packed_mm_fwd
  fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
  fn.restype = ctypes.c_int
  return fn


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def packed_matmul_cuda(x: torch.Tensor, w_packed: torch.Tensor,
                       packing: Packing, block: Tuple[int, int]):
  """Launches csrc/packed_mm.cu on the current stream; checks what the
  kernel takes and raises on anything else."""
  global packed_mm_launches
  bk, bn = block
  nk, nn_ = packing.shape
  n_act = packing.n_active
  if not (x.is_cuda and w_packed.device == x.device):
    raise ValueError(f'x ({x.device}) and w ({w_packed.device}) must be on '
                     'one CUDA device')
  if x.dtype not in _DTYPE_CODE or w_packed.dtype != x.dtype:
    raise TypeError(f'packed_mm takes float32 or bfloat16 x and w of one '
                    f'dtype, got {x.dtype} and {w_packed.dtype}')
  if x.dim() != 2 or x.shape[1] != nk * bk:
    raise ValueError(f'x must be (m, {nk * bk}), got {tuple(x.shape)}')
  if tuple(w_packed.shape) != (n_act, bk, bn):
    raise ValueError(f'w must be {(n_act, bk, bn)}, got '
                     f'{tuple(w_packed.shape)}')
  if not (x.is_contiguous() and w_packed.is_contiguous()):
    raise ValueError('x and w must be contiguous')
  vec = 16 // x.element_size()       # elements per 16-byte copy
  if bk % vec or bn % vec:
    raise ValueError(f'block {block} must be a multiple of {vec} for '
                     f'{x.dtype}')
  if x.data_ptr() % 16 or (n_act and w_packed.data_ptr() % 16):
    raise ValueError('x and w must start on a 16-byte boundary')
  if torch.is_grad_enabled() and (x.requires_grad or w_packed.requires_grad):
    raise NotImplementedError('packed_matmul has no CUDA backward yet; '
                              'serve under torch.inference_mode()')
  m = x.shape[0]
  col_ptr, rows = packing.column_index(x.device)
  y = torch.empty((m, nn_ * bn), dtype=x.dtype, device=x.device)
  if m == 0:
    return y
  stream = torch.cuda.current_stream(x.device).cuda_stream
  err = _kernel()(x.data_ptr(), w_packed.data_ptr(), col_ptr.data_ptr(),
                  rows.data_ptr(), y.data_ptr(), m, nk * bk, nn_, bk, bn,
                  _DTYPE_CODE[x.dtype], stream)
  if err:
    raise RuntimeError(f'packed_mm_fwd launch failed: CUDA error {err}')
  packed_mm_launches += 1
  return y


def packed_matmul(x: torch.Tensor, w_packed: torch.Tensor, packing: Packing,
                  block: Tuple[int, int] = (512, 512), bm: int = 512,
                  n_out: Optional[int] = None):
  """y = x @ W where W is the packed block-sparse tensor.

  CPU tensors take the plain version; CUDA tensors the Hopper kernel.
  `bm` is kept for parity with the JAX signature: the kernel picks its
  own row tile and masks ragged m, so rows need no padding.
  """
  del bm
  nn_ = packing.shape[1]
  if n_out is not None and n_out != nn_ * block[1]:
    raise ValueError(f'forward n_out must be nn * bn = {nn_ * block[1]}')
  if x.device.type == 'cpu':
    return packed_matmul_reference(x, w_packed, packing, block)
  if x.device.type == 'cuda':
    return packed_matmul_cuda(x, w_packed, packing, block)
  raise ValueError(f'packed_matmul runs on cpu or cuda, not {x.device}')
