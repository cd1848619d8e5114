"""Packed block-sparse tensors, their matmul and its gradients, in PyTorch.

Counterpart of rigl_tpu/ops/pallas/block_sparse_packed.py.  A weight
matrix lives as its active blocks `(n_active, bk, bn)` plus a static
Packing: fwd and bwd entry lists `(cols, rows, slots, valid)`, each of
n_active + nn entries, ACTIVES FIRST in column-major order, then the nn
dummies (pack_columns_slots).  The index maths is the JAX package's, so a
Packing here holds the same lists element by element.

`packed_matmul` is y = x @ W as a torch.autograd.Function: its backward
gives dx = gy @ Wᵀ through the bwd packing and dw PACKED, in w's layout.
Each of the three products has a plain PyTorch version, which CPU tensors
take (`packed_matmul_reference`, `packed_matmul_dx_reference`,
`packed_dw_reference`), and a hand-written Hopper kernel in
csrc/packed_mm.cu, which CUDA tensors launch or raise: the forward and dx
modes of the mm kernels (replacing the TPU kernel `_mm_kernel`; the branch
by `mm_branch`: `packed_mm_decode_kernel` at decode in either dtype, its
contraction split over a cluster by ops/mm_split.py `decode_plan`,
`packed_mm_wgmma_kernel` in bf16, `packed_mm_ffma_kernel` in f32,
`packed_mm_kernel` for a bf16 contraction that 64 does not divide) and the
dw kernels (replacing `_dw_kernel` / `_dw_panel_kernel`:
`packed_dw_wgmma_kernel` in bf16, `packed_dw_3xtf32_kernel` in f32 at the
tile `dw_tile` names, each with its m-sum split over thread blocks by
`dw_plan` and the partials added in slice order by
`packed_dw_reduce_kernel`).  The kernels read CSR
indices of the actives (`Packing.column_index`, `row_index`, `dw_index`),
built once per Packing and device and cached on the Packing, as is the
longest column the decode plan reads (`Packing.longest`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from rigl_tpu_torch.ops import _build, dw_split, mm_split

# Launches of each kernel in this process.  Each wrapper adds one per
# launch of its kernel; nothing else touches them but callers resetting them.
packed_mm_launches = 0        # the mm kernels, forward mode
packed_mm_dx_launches = 0     # the mm kernels, transposed (dx) mode
packed_dw_launches = 0        # the dw kernels (one per call of the entry)
# The mm kernels' decode branch (packed_mm_decode_kernel), in either mode
# and storage, through any wrapper: also counted in the wrapper's own count.
mm_decode_launches = 0


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

  def row_index(self, device) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """(row_ptr (nk + 1,), cols (n_active,), slots (n_active,)): the CSR of
    the bwd lists, int32 on `device`.  Block-row k's actives are entries
    row_ptr[k] .. row_ptr[k + 1] - 1, block-column cols[e] and fwd packed
    slot slots[e] each.
    Raises if the bwd lists are not in the actives-first, row-major order
    that make_packing gives them, or their slots are not a permutation."""
    device = torch.device(device)
    key = ('rows', str(device))
    if key not in self._cache:
      nk = self.shape[0]
      n_act = self.n_active
      krows, cols, slots, valid = (t[:n_act].to('cpu', torch.int64)
                                   for t in self.bwd)
      if not (bool((valid == 1).all())
              and bool((krows[1:] >= krows[:-1]).all())
              and torch.equal(torch.sort(slots).values, torch.arange(n_act))):
        raise ValueError('bwd packing is not in make_packing order '
                         '(actives first, row-major, slots a permutation)')
      counts = torch.bincount(krows, minlength=nk)
      row_ptr = torch.cat([torch.zeros(1, dtype=torch.int64),
                           torch.cumsum(counts, 0)])
      self._cache[key] = tuple(t.to(device, torch.int32).contiguous()
                               for t in (row_ptr, cols, slots))
    return self._cache[key]

  def longest(self, mode: str = 'fwd') -> int:
    """The most actives of any output block-column: of a block-column of
    W for the forward ('fwd'), of a block-row for dx ('dx'); 0 with none.
    From the CPU index, once per Packing."""
    key = ('longest', mode)
    if key not in self._cache:
      ptr = (self.column_index('cpu')[0] if mode == 'fwd'
             else self.row_index('cpu')[0])
      self._cache[key] = int(ptr.diff().max()) if ptr.numel() > 1 else 0
    return self._cache[key]

  def dw_index(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows (n_active,), cols (n_active,)): packed slot s holds block
    (rows[s], cols[s]); int32 on `device`, checked as column_index checks."""
    device = torch.device(device)
    key = ('dw', str(device))
    if key not in self._cache:
      rows = self.column_index(device)[1]
      cols = self.fwd[0][:self.n_active].to(device, torch.int32).contiguous()
      self._cache[key] = (rows, cols)
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


def repack_permutation(old_packing: Packing, new_packing: Packing):
  """int32 (n_active,) gather indices g with new_data = old_data[g] for
  surviving blocks; blocks new in the mask get -1 (the caller fills their
  grow-init values).  On the CPU."""
  nk, nn_ = old_packing.shape
  if new_packing.n_active == 0:
    return torch.zeros(0, dtype=torch.int32)
  oc, orow, oslot, ov = (t.long() for t in old_packing.to('cpu').fwd)
  grid = torch.full((nk * nn_,), -1, dtype=torch.int64).scatter_reduce(
      0, orow * nn_ + oc, torch.where(ov == 1, oslot, -1), 'amax',
      include_self=True)
  ncols, nrows, nslots, nv = (t.long() for t in new_packing.to('cpu').fwd)
  src = torch.where(nv == 1, grid[nrows * nn_ + ncols], -1)
  perm = torch.full((new_packing.n_active,), -1, dtype=torch.int64)
  perm = perm.scatter_reduce(0, nslots, src, 'amax', include_self=True)
  return perm.to(torch.int32)


# ------------------------------------------------------------- matmul -----
def packed_matmul_reference(x: torch.Tensor, w_packed: torch.Tensor,
                            packing: Packing, block: Tuple[int, int]):
  """Plain version: x @ unpack_dense(w), summed in f32, cast once to
  x.dtype (empty columns are zero by construction)."""
  w = unpack_dense(w_packed, packing, block)
  return (x.float() @ w.float()).to(x.dtype)


def packed_matmul_dx_reference(gy: torch.Tensor, w_packed: torch.Tensor,
                               packing: Packing, block: Tuple[int, int]):
  """Plain version of dx: gy @ unpack_dense(w)ᵀ, summed in f32, cast once
  to gy.dtype (block-rows with no active block give zero columns)."""
  w = unpack_dense(w_packed, packing, block)
  return (gy.float() @ w.float().T).to(gy.dtype)


def packed_dw_reference(x: torch.Tensor, gy: torch.Tensor, packing: Packing,
                        block: Tuple[int, int], out_dtype=None):
  """Plain version of the packed dw: pack_dense(xᵀ @ gy), summed over m in
  f32, cast once to `out_dtype` (w's dtype; x's when None)."""
  dw = pack_dense(x.float().T @ gy.float(), packing, block)
  return dw.to(out_dtype or x.dtype)


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# The mm kernels' branches (csrc/packed_mm.cu dispatch_mm, by their codes:
# the position here), chosen by `mm_branch`.
MM_BRANCHES = ('decode', 'tiled', 'wgmma', 'ffma')
# The rows up to which the decode branch runs (one m-tile of 32), and the
# contraction chunk of the wgmma branch's TMA boxes.
MM_DECODE_ROWS, MM_WGMMA_CHUNK = 32, 64


def mm_branch(m: int, seg: int, dtype) -> str:
  """The branch of the forward / dx kernels for m rows and a contraction
  of `seg` per active (bk forward, bn dx) in `dtype`:
  'decode' at m <= 32 (packed_mm_decode_kernel, weight-bandwidth-bound:
  each tile's contraction split over a cluster by `decode_slices`); above
  it 'ffma' for float32 (packed_mm_ffma_kernel); for bfloat16 'wgmma'
  (packed_mm_wgmma_kernel) where 64 divides seg, else 'tiled'
  (packed_mm_kernel, 64 x 64 x 32): a 64-deep box of x would read x's
  neighbouring segment, whose products with the zeros past the W block
  vanish only while that segment is finite."""
  if m <= MM_DECODE_ROWS:
    return 'decode'
  if dtype == torch.float32:
    return 'ffma'
  return 'wgmma' if seg % MM_WGMMA_CHUNK == 0 else 'tiled'

# The dw kernels' tiles (csrc/packed_mm.cu DwTile, by their codes: the
# position here), named by `dw_tile`: (tile rows, tile columns, m rows a
# ring stage, thread blocks an SM).  bf16: packed_dw_wgmma_kernel at 128 x
# 128 (132 KB of shared memory a block, one block an SM).  f32:
# packed_dw_3xtf32_kernel (DwTf32Plan, kPerSm the blocks an SM) at 128 x
# 128 (384 threads, 193 KB: one block an SM) and at 64 x 16 (256 threads,
# 65 KB: three).
DW_TILES = ((128, 128, 64, 1), (128, 128, 32, 1), (64, 16, 32, 3))


def dw_tile(block: Tuple[int, int], dtype) -> int:
  """The code of the dw tile for blocks of `block` in `dtype` (its
  position in DW_TILES): bf16 128 x 128 (code 0); f32 64 x 16 (code 2)
  for blocks at most 16 columns wide, on which a 128 x 128 tile would
  compute 64 times the outputs it keeps, else 128 x 128 (code 1)."""
  if dtype == torch.bfloat16:
    return 0
  return 2 if block[1] <= DW_TILES[2][1] else 1


class DwPlan(NamedTuple):
  """How one dw call splits its m-sum (ops/dw_split.py): `slices` slices
  of `slice_rows` rows, the first kernel's grid (entries, tiles per entry,
  slices), the bytes of its f32 workspace (0 with one slice: no workspace
  and no reduction kernel) and, for the block dw kernels, its tile's code
  (DW_TILES; None for the tap dw)."""
  slices: int
  slice_rows: int
  grid: Tuple[int, int, int]
  workspace_bytes: int
  tile: Optional[int] = None


def dw_plan(m: int, n_entries: int, block: Tuple[int, int], dtype,
            sm_count: int) -> DwPlan:
  """The plan of the packed and dense dw kernels for m rows, n_entries
  blocks of `block` in `dtype`, on a card of sm_count SMs, at the tile
  dw_tile names."""
  tile = dw_tile(block, dtype)
  tm, tn, chunk, per_sm = DW_TILES[tile]
  tiles = -(-block[0] // tm) * -(-block[1] // tn)
  # A partial tile's bytes over a chunk's: tm tn f32 over chunk (tm + tn).
  partial = tm * tn * 4 / (chunk * (tm + tn) * dtype.itemsize)
  slices = dw_split.split_plan(n_entries * tiles, m, chunk, per_sm * sm_count,
                               partial)
  return DwPlan(slices, dw_split.slice_rows(m, chunk, slices),
                (n_entries, tiles, slices),
                0 if slices == 1 else slices * n_entries * tiles * tm * tn * 4,
                tile)


def dw_workspace(plan: DwPlan, device) -> Tuple[Optional[torch.Tensor], int]:
  """(the f32 workspace of a plan, its address): (None, 0) when the plan
  needs none.  Kernels run on the current stream, so the caching
  allocator reuses the memory only for work queued after them."""
  if not plan.workspace_bytes:
    return None, 0
  ws = torch.empty(plan.workspace_bytes // 4, dtype=torch.float32,
                   device=device)
  return ws, ws.data_ptr()


def decode_slices(branch: str, m: int, out_w: int, ngroups: int, seg: int,
                  longest: int, dtype, device) -> int:
  """The cluster size S that a forward / dx call of `branch` passes to
  dispatch_mm: mm_split.decode_plan's for the decode branch, 1 for the
  others (arguments as decode_plan's, the SM count read from `device`)."""
  if branch != 'decode':
    return 1
  return mm_split.decode_plan(m, out_w, ngroups, seg, longest, dtype,
                              dw_split.sm_count(device)).slices


@functools.cache
def _kernel(name: str):
  """The C entry point `name` of csrc/packed_mm.cu: pointers, then ints,
  then the stream; returns the CUDA error code of the launch."""
  n_ptrs, n_ints = {'packed_mm_fwd': (5, 9), 'packed_mm_dx': (6, 9),
                    'packed_dw': (6, 10), 'dense_dw': (7, 10)}[name]
  fn = getattr(_build.load('packed_mm'), name)
  fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                 + [ctypes.c_void_p])
  fn.restype = ctypes.c_int
  return fn


def _check_cuda(op: str, acts, w_packed: torch.Tensor, packing: Packing,
                block: Tuple[int, int]):
  """What every kernel takes: activations `acts` ((name, tensor, columns)
  triples) and w on one CUDA device, float32 or bfloat16 of one dtype, 2-D
  activations of the given widths, w of (n_active, bk, bn), contiguous,
  16-byte aligned, and a block of whole 16-byte copies.  Raises otherwise."""
  bk, bn = block
  n_act = packing.n_active
  x = acts[0][1]
  for name, a, _ in acts:
    if not (a.is_cuda and w_packed.device == a.device == x.device):
      raise ValueError(f'{name} ({a.device}) and w ({w_packed.device}) must '
                       'be on one CUDA device')
    if a.dtype not in _DTYPE_CODE or w_packed.dtype != a.dtype:
      raise TypeError(f'{op} takes float32 or bfloat16 {name} and w of one '
                      f'dtype, got {a.dtype} and {w_packed.dtype}')
  for name, a, cols in acts:
    if a.dim() != 2 or a.shape[1] != cols or a.shape[0] != x.shape[0]:
      raise ValueError(f'{name} must be (m, {cols}), got {tuple(a.shape)}')
  if tuple(w_packed.shape) != (n_act, bk, bn):
    raise ValueError(f'w must be {(n_act, bk, bn)}, got '
                     f'{tuple(w_packed.shape)}')
  if not (all(a.is_contiguous() for _, a, _ in acts)
          and w_packed.is_contiguous()):
    raise ValueError(f'{op}: operands must be contiguous')
  vec = 16 // x.element_size()       # elements per 16-byte copy
  if bk % vec or bn % vec:
    raise ValueError(f'block {block} must be a multiple of {vec} for '
                     f'{x.dtype}')
  if (any(a.data_ptr() % 16 for _, a, _ in acts)
      or (n_act and w_packed.data_ptr() % 16)):
    raise ValueError(f'{op}: operands must start on a 16-byte boundary')


def _launch(name: str, *args):
  err = _kernel(name)(*args)
  if err:
    raise RuntimeError(f'{name} launch failed: CUDA error {err}')


def packed_matmul_cuda(x: torch.Tensor, w_packed: torch.Tensor,
                       packing: Packing, block: Tuple[int, int]):
  """y = x @ W: launches the mm kernel of mm_branch (forward mode) on the
  current stream; checks what the kernel takes and raises on anything
  else."""
  global packed_mm_launches, mm_decode_launches
  bk, bn = block
  nk, nn_ = packing.shape
  _check_cuda('packed_mm', [('x', x, nk * bk)], w_packed, packing, block)
  m = x.shape[0]
  col_ptr, rows = packing.column_index(x.device)
  y = torch.empty((m, nn_ * bn), dtype=x.dtype, device=x.device)
  if m == 0:
    return y
  branch = mm_branch(m, bk, x.dtype)
  slices = decode_slices(branch, m, bn, nn_, bk, packing.longest('fwd'),
                         x.dtype, x.device)
  _launch('packed_mm_fwd', x.data_ptr(), w_packed.data_ptr(),
          col_ptr.data_ptr(), rows.data_ptr(), y.data_ptr(), m, nk * bk, nn_,
          bk, bn, packing.n_active, MM_BRANCHES.index(branch), slices,
          _DTYPE_CODE[x.dtype],
          torch.cuda.current_stream(x.device).cuda_stream)
  packed_mm_launches += 1
  mm_decode_launches += branch == 'decode'
  return y


def packed_matmul_dx_cuda(gy: torch.Tensor, w_packed: torch.Tensor,
                          packing: Packing, block: Tuple[int, int]):
  """dx = gy @ Wᵀ: launches the mm kernel of mm_branch (dx mode) through
  the bwd packing's CSR; checks and raises as packed_matmul_cuda does."""
  global packed_mm_dx_launches, mm_decode_launches
  bk, bn = block
  nk, nn_ = packing.shape
  _check_cuda('packed_mm_dx', [('gy', gy, nn_ * bn)], w_packed, packing,
              block)
  m = gy.shape[0]
  row_ptr, cols, slots = packing.row_index(gy.device)
  dx = torch.empty((m, nk * bk), dtype=gy.dtype, device=gy.device)
  if m == 0:
    return dx
  branch = mm_branch(m, bn, gy.dtype)
  slices = decode_slices(branch, m, bk, nk, bn, packing.longest('dx'),
                         gy.dtype, gy.device)
  _launch('packed_mm_dx', gy.data_ptr(), w_packed.data_ptr(),
          row_ptr.data_ptr(), cols.data_ptr(), slots.data_ptr(), dx.data_ptr(),
          m, nn_ * bn, nk, bk, bn, packing.n_active,
          MM_BRANCHES.index(branch), slices, _DTYPE_CODE[gy.dtype],
          torch.cuda.current_stream(gy.device).cuda_stream)
  packed_mm_dx_launches += 1
  mm_decode_launches += branch == 'decode'
  return dx


def dw_launch(x: torch.Tensor, gy: torch.Tensor, rows: torch.Tensor,
              cols: torch.Tensor, flags: Optional[torch.Tensor],
              dw: torch.Tensor, block: Tuple[int, int], dense: bool):
  """Launches the dw kernels into `dw` on the current stream, at the tile
  and split dw_plan names: entry s is block (rows[s], cols[s]) of xᵀ @ gy,
  x (m, K) and gy (m, N); packed storage (dense False) writes dw[s] of
  (n_entries, bk, bn), dense storage block (rows[s], cols[s]) of a (K, N)
  dw, skipping the entries with flags[s] == 0 where flags is given.  The
  caller has checked the operands (one CUDA device and dtype, contiguous,
  16-byte aligned, int32 indices there) and counts the call."""
  m, kdim = x.shape
  bk, bn = block
  n_ent = int(rows.shape[0])
  plan = dw_plan(m, n_ent, block, x.dtype, dw_split.sm_count(x.device))
  buf, ws = dw_workspace(plan, x.device)   # buf lives through the launch
  ptrs = [x.data_ptr(), gy.data_ptr(), rows.data_ptr(), cols.data_ptr()]
  if dense:
    ptrs.append(0 if flags is None else flags.data_ptr())
  _launch('dense_dw' if dense else 'packed_dw', *ptrs, dw.data_ptr(), ws, m,
          kdim, gy.shape[1], n_ent, bk, bn, plan.slices, plan.slice_rows,
          plan.tile, _DTYPE_CODE[x.dtype],
          torch.cuda.current_stream(x.device).cuda_stream)


def packed_dw_cuda(x: torch.Tensor, gy: torch.Tensor, w_packed: torch.Tensor,
                   packing: Packing, block: Tuple[int, int]):
  """Packed dw (n_active, bk, bn) in w's layout and dtype: launches the dw
  kernel of the dtype, split as dw_plan says, and the reduction kernel
  where it splits; checks and raises as packed_matmul_cuda does (x, gy
  and w of one dtype)."""
  global packed_dw_launches
  bk, bn = block
  nk, nn_ = packing.shape
  n_act = packing.n_active
  _check_cuda('packed_dw', [('x', x, nk * bk), ('gy', gy, nn_ * bn)],
              w_packed, packing, block)
  m = x.shape[0]
  rows, cols = packing.dw_index(x.device)
  if m == 0 or n_act == 0:
    return torch.zeros_like(w_packed)
  dw = torch.empty_like(w_packed)
  dw_launch(x, gy, rows, cols, None, dw, block, False)
  packed_dw_launches += 1
  return dw


def _on_device(op: str, t: torch.Tensor, plain, kernel):
  """CPU tensors take the plain version, CUDA tensors the kernel."""
  if t.device.type == 'cpu':
    return plain
  if t.device.type == 'cuda':
    return kernel
  raise ValueError(f'{op} runs on cpu or cuda, not {t.device}')


class _PackedMatmul(torch.autograd.Function):
  """y = x @ W; backward: dx through the bwd packing (only if x needs it),
  dw packed (only if w needs it), each by the plain version on the CPU and
  the kernel on CUDA."""

  @staticmethod
  def forward(ctx, x, w_packed, packing, block):
    ctx.save_for_backward(x, w_packed)
    ctx.packing, ctx.block = packing, block
    fn = _on_device('packed_matmul', x, packed_matmul_reference,
                    packed_matmul_cuda)
    return fn(x, w_packed, packing, block)

  @staticmethod
  def backward(ctx, gy):
    x, w_packed = ctx.saved_tensors
    packing, block = ctx.packing, ctx.block
    gy = gy.contiguous()
    dx = dw = None
    if ctx.needs_input_grad[0]:
      fn = _on_device('packed_matmul dx', gy, packed_matmul_dx_reference,
                      packed_matmul_dx_cuda)
      dx = fn(gy, w_packed, packing, block)
    if ctx.needs_input_grad[1]:
      def plain(x, gy, w, packing, block):
        return packed_dw_reference(x, gy, packing, block, w.dtype)
      fn = _on_device('packed_matmul dw', gy, plain, packed_dw_cuda)
      dw = fn(x, gy, w_packed, packing, block)
    return dx, dw, None, None


def packed_matmul(x: torch.Tensor, w_packed: torch.Tensor, packing: Packing,
                  block: Tuple[int, int] = (512, 512), bm: int = 512,
                  n_out: Optional[int] = None):
  """y = x @ W where W is the packed block-sparse tensor, differentiable in
  x and w: dx through the bwd packing, dw PACKED (same layout as w_packed,
  ready for the optimizer).

  CPU tensors take the plain versions; CUDA tensors the Hopper kernels.
  A call that needs no gradient (grad mode off, as in serving, or neither
  input requiring one) skips the autograd Function and its host cost.
  `bm` is kept for parity with the JAX signature: the kernels pick their
  own row tile and mask ragged m, so rows need no padding.
  """
  del bm
  nn_ = packing.shape[1]
  if n_out is not None and n_out != nn_ * block[1]:
    raise ValueError(f'forward n_out must be nn * bn = {nn_ * block[1]}')
  if torch.is_grad_enabled() and (x.requires_grad or w_packed.requires_grad):
    return _PackedMatmul.apply(x, w_packed, packing, tuple(block))
  fn = _on_device('packed_matmul', x, packed_matmul_reference,
                  packed_matmul_cuda)
  return fn(x, w_packed, packing, tuple(block))
