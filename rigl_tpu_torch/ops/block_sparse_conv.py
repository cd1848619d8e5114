"""Block-sparse stride-1 SAME convolution over active tap blocks, in PyTorch.

Counterpart of rigl_tpu/ops/pallas/block_sparse_conv.py.  A KxK conv
kernel (kh, kw, Cin, Cout) with odd kh, kw is a set of T = kh*kw taps, each
a (Cin, Cout) matrix cut into (bk, bn) blocks; the conv of NHWC
activations is the sum, over the active (tap, cin-block, cout-block)
entries, of the input shifted by the tap times the block.  Reads that
leave the image are zeros, which is SAME padding.

`pack_tap_active` builds JAX's entry lists from a (T, Cin/bk, Cout/bn)
occupancy, element for element: column-major actives, one leading dummy
entry (tap -1) per output column and one closing sentinel; a `TapPack`
holds them under JAX's keys and caches the TapIndex built from them, so
the dense-masked train step builds one per mask update, not per call.
`block_sparse_conv_tap(x, w4d, packing, block)` is the JAX entry point as
a torch.autograd.Function: forward y, dx (the same conv of gy with flipped
taps and per-tap transposed blocks) and dw on the active blocks only,
summed in f32 and cast to w's dtype, scattered into a (kh, kw, Cin, Cout)
tensor of zeros.  `packed_conv_tap(x, kernel, packing, kernel_size, block)`
is the same conv reading a PackedConv's packed storage `(n_active, bk, bn)`
directly, with its dw written straight into the packed slots; the tap
entries come from the layer's 2D Packing (block-row r of the
(kh*kw*Cin, Cout) view is tap r // (Cin/bk), cin-block r % (Cin/bk)), built
once per Packing and cached on it.

Both take a TapIndex: every entry's tap, input block and weight offset,
grouped by output column for the forward and for dx, listed for dw, and
for the dw kernel grouped by (input block, output block), at most
`tap_dw_taps` taps a group (`TapDwGroups`).
Each of the three products has a plain PyTorch version that walks the same
index (one shifted (pixels x bk) @ (bk x bn) product per entry, summed in
f32; `tap_conv_reference`, `tap_dw_reference`), which CPU tensors take, and
hand-written Hopper kernels, which CUDA tensors launch or raise.  The
forward and dx (replacing the TPU kernels `_conv_kernel` and
`_conv_kernel_v5`) run the branch `tap_branch` names: a 1x1 kernel has no
tap shifts, so 'mm' runs the forward / dx kernels of csrc/packed_mm.cu on
a dense-w index's lists (the products of block_sparse_v4's B7; a packed
1x1 is refused, PackedConv1x1 serves those); a KxK kernel
runs csrc/tap_conv.cu, 'wgmma' (`tap_conv_wgmma_kernel`) in bf16 with
blocks of 16s, 'tf32' (`tap_conv_tf32_kernel`: tf32 wgmma over one x tile
a (pixel tile, input block) that every tap of the block reads, on
`TapPanelLists`) in f32 (3xTF32) and in bf16 with blocks of 8s (one
product a k-step, exact for bf16).  dw runs `tap_dw_kernel` (replacing
`_dw_kernel`), whose pixel sum `tap_dw_plan` splits over thread blocks,
the partials added in slice order by `tap_dw_reduce_kernel`; a 1x1
kernel's dw is the block dw of csrc/packed_mm.cu
(`block_sparse_packed.dw_launch`).

Where JAX chooses among TPU grids with environment switches (RIGL_TAP_ENGINE
for the v5 grid, RIGL_TAP_DW for a dense dw times the mask, RIGL_TAP_BM for
the row tile), every choice gives the same numbers, so the port has one
path and no switch.  The kernels take any batch size (JAX's tap kernel
needs N % 16 == 0 off the CPU, a Mosaic alignment rule).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from rigl_tpu_torch.ops import _build, block_sparse_v4, dw_split
from rigl_tpu_torch.ops.block_sparse_packed import (DwPlan, Packing,
                                                    _on_device, dw_launch,
                                                    dw_workspace)
from rigl_tpu_torch.ops.block_sparse_v3 import DenseLists, dense_mm_cuda

# Launches of each kernel in this process.  Each wrapper adds one per
# launch of its kernel; nothing else touches them but callers resetting them.
# The forward / dx counters count calls of their entry, whatever branch
# serves the call (tap_branch).
tap_conv_fwd_launches = 0     # the forward kernels
tap_conv_dx_launches = 0      # the dx kernels
tap_dw_launches = 0           # tap_dw_kernel (one per call of the entry)
# Of the counts above, the 1x1 calls that csrc/packed_mm.cu's kernels serve
# (the 'mm' branch; its dw on the block dw).
tap_mm_fwd_launches = tap_mm_dx_launches = tap_mm_dw_launches = 0

# tap_dw_kernel's tiling (csrc/tap_conv.cu): DT x DT output tiles, chunks
# of DP pixels, at most TAP_GROUP_TAPS[dtype] taps a group (kDenseTaps)
# at 2 thread blocks an SM, or TAP_SPARSE_TAPS (kSparseTaps) at 4 for an
# index whose active (input block, output block) pairs hold at most
# TAP_SPARSE_MEAN taps on average, where groups share little.
TAP_DW_TILE, TAP_DW_CHUNK = 16, 256
TAP_GROUP_TAPS = {torch.bfloat16: 9, torch.float32: 4}
TAP_SPARSE_TAPS, TAP_SPARSE_MEAN = 2, 2.5

# The forward / dx branches, in the order of csrc/tap_conv.cu's TapBranch;
# the output tiles of tap_conv_wgmma_kernel (channels: the cases of
# launch_wgmma there) and its pixels a thread block (kWgRows).
TAP_BRANCHES = ('mm', 'wgmma', 'tf32')
TAP_WGMMA_TILES = (16, 32, 48, 64, 128)
TAP_WGMMA_TILE, TAP_WGMMA_ROWS = TAP_WGMMA_TILES[-1], 128
# tap_wgmma_gcols: the largest share of the entries a group's unions may
# hold for the wide groups to be taken.
TAP_GROUP_CUT = 0.75
# tap_conv_tf32_kernel (the 'tf32' branch): its output tiles (the cases of
# launch_tf32: 16 and 64 one column, 32 a group; in bf16 16 also a group
# of two 8-wide columns, 32 of four), pixels a thread block
# (kTfRows), input channels an x tile (kTfChunk) and entries a stage
# (kTfEntries, 2 k-steps of 8 each); and the most pixel rows of an x tile
# (kTfMaxXRows, which every tile's shared memory fits) before a panel's
# taps are split by tap row.
TAP_TF32_TILES = (16, 32, 64)
TAP_TF32_ROWS, TAP_TF32_CHUNK, TAP_TF32_ENTRIES = 128, 16, 2
TAP_TF32_XROWS = 512
# ... the pixel rows of an x tile's TMA box (kTfBoxRows) and the ints of
# a stage's row (kTfRow).
TAP_TF32_BOX, TAP_TF32_ROW = 64, 32
# tap_tf32_tile: the block-columns of a group at output blocks of 16, and
# in bf16 those of a group at output blocks of 8, widest first.
TAP_TF32_GROUP = 2
TAP_TF32_GROUPS_8 = (4, 2)


def tap_branch(kh: int, kw: int, bk: int, bn: int, dtype) -> str:
  """The branch of the forward / dx kernels for a (kh, kw) kernel at block
  (bk, bn) in `dtype`: 'mm' for every 1x1 (no shifts: csrc/packed_mm.cu's
  forward / dx kernels, the branch block_sparse_packed.mm_branch names);
  KxK in bfloat16 'wgmma' (tap_conv_wgmma_kernel) where 16 divides bk and
  bn; every other KxK 'tf32' (tap_conv_tf32_kernel: 3xTF32 in float32,
  one exact tf32 product a k-step in bfloat16 at blocks of 8s).  Raises
  for another dtype and for a block that is not whole 16-byte copies of
  the dtype."""
  if dtype not in _DTYPE_CODE:
    raise ValueError(f'the tap kernels take float32 or bfloat16, not {dtype}')
  vec = 16 // dtype.itemsize
  if bk % vec or bn % vec:
    raise ValueError(f'block {(bk, bn)} must be a multiple of {vec} for '
                     f'{dtype}')
  if (kh, kw) == (1, 1):
    return 'mm'
  if dtype == torch.bfloat16 and bk % 16 == 0 and bn % 16 == 0:
    return 'wgmma'
  return 'tf32'


# ----------------------------------------------------------- packing ------
def pack_tap_active(occ3: torch.Tensor, n_active: int):
  """(T, K/bk, N/bn) occupancy -> int32 (cols, rows, taps), each of length
  n_active + nn + 1: the actives column-major by cout-block, one leading
  dummy (tap -1, row 0) per column, then a sentinel (-1, 0, -1).  JAX's
  lists, element for element."""
  t_dim, nk, nn_ = occ3.shape
  i64 = torch.int64
  flat_cm = torch.as_tensor(occ3).to(i64).permute(2, 0, 1).reshape(-1)
  order = torch.argsort(-flat_cm, stable=True)[:n_active]
  cols = order // (t_dim * nk)
  rem = order % (t_dim * nk)
  taps, rows = rem // nk, rem % nk
  cols = torch.cat([torch.arange(nn_, dtype=i64), cols])
  rows = torch.cat([torch.zeros(nn_, dtype=i64), rows])
  taps = torch.cat([torch.full((nn_,), -1, dtype=i64), taps])
  order2 = torch.argsort(cols, stable=True)
  end = torch.tensor([-1])
  cols = torch.cat([cols[order2], end])
  rows = torch.cat([rows[order2], torch.zeros(1, dtype=i64)])
  taps = torch.cat([taps[order2], end])
  return tuple(t.to(torch.int32) for t in (cols, rows, taps))


class TapPack(block_sparse_v4.Packing):
  """A pack_tap_active packing in JAX's form, {'cols', 'rows', 'taps'},
  on which `tap_index` keeps the TapIndex of each (w_shape, block): a pack
  is made once per mask update (SparseTraining._compute_packs), so the
  step's convs build their index and copy its lists to the card once per
  update, not on every call."""

  def __init__(self, cols, rows, taps):
    super().__init__(cols=cols, rows=rows, taps=taps)


def _occupancy3(cols, rows, taps, t_dim: int, nk: int, nn_: int):
  """The (T, K/bk, N/bn) int32 occupancy of a pack_tap_active packing
  (dummy and sentinel entries, tap -1, are ignored)."""
  occ = torch.zeros((t_dim, nk, nn_), dtype=torch.int32)
  taps = torch.as_tensor(taps).long()
  keep = taps >= 0
  occ[taps[keep], torch.as_tensor(rows).long()[keep],
      torch.as_tensor(cols).long()[keep]] = 1
  return occ


def tap_batch_ok(n: int) -> bool:
  """Whether a batch of n images can run the tap kernels: always, since
  they take any batch (JAX's TPU kernel needs n % 16 == 0)."""
  del n
  return True


def default_tap_bm() -> int:
  """The JAX tap kernel's default row tile (2048).  Kept for signatures:
  the Hopper kernels pick their own tiles, and no tile changes a result."""
  return 2048


# ------------------------------------------------------------- index ------
class TapLists(NamedTuple):
  """One conv mode's entries grouped by output block-column (a CSR):
  column g sums entries ptr[g] .. ptr[g+1]-1, each reading input block
  kblks[e] at the shift of tap taps[e] and the weight block at element
  offset woffs[e] of w (rows w_ld apart).  int32."""
  ptr: torch.Tensor
  taps: torch.Tensor
  kblks: torch.Tensor
  woffs: torch.Tensor


class TapGroupLists(NamedTuple):
  """The lists tap_conv_wgmma_kernel reads for one conv mode: the output
  block-columns in groups of `gcols` (the last group may hold fewer);
  group G walks entries ptr[G] .. ptr[G+1]-1, the union of its columns'
  (tap, input block) pairs in ascending (tap, input block) order, entry u
  reading input block kblks[u] at the shift of tap taps[u] and, for
  column c of the group, the weight block at element offset
  woffs[u * gcols + c] (-1 where that column has no such entry: the
  kernel skips that column's product).  `order`: the groups, those with the most
  entries first.  int32.  With gcols = 1 the groups are the columns and
  the lists are TapLists'."""
  ptr: torch.Tensor
  taps: torch.Tensor
  kblks: torch.Tensor
  woffs: torch.Tensor
  order: torch.Tensor
  gcols: int


def tap_wgmma_tile(gcols: int, out_w: int) -> int:
  """The output tile (channels) of a 'wgmma' call whose groups hold gcols
  block-columns, each out_w wide: the narrowest of TAP_WGMMA_TILES that
  holds the group, else the widest (a column wider than it takes several
  tiles)."""
  width = gcols * out_w
  return next((t for t in TAP_WGMMA_TILES if t >= width), TAP_WGMMA_TILE)


def tap_group_cols(out_w: int, ncols: int) -> int:
  """The most output block-columns, each out_w channels wide, that one
  thread block of tap_conv_wgmma_kernel can cover: as many as fit in its
  128 channels (at most ncols) where out_w <= 64, else 1."""
  return max(1, min(ncols, TAP_WGMMA_TILE // out_w)) if out_w <= 64 else 1


def tap_wgmma_gcols(index: 'TapIndex', mode: str, pixels: int,
                    sm_count: int) -> int:
  """The group width a 'wgmma' call of `mode` over `pixels` = N*H*W pixels
  takes on a card of sm_count SMs: the widest (tap_group_cols) where its
  groups' unions cut the x tiles each pixel tile copies by at least
  TAP_GROUP_CUT of the entries and still give every SM a thread block
  (groups x pixel tiles >= SMs); else one column a group.  A group copies
  each shifted x tile once for its columns, but runs its products 16
  columns at a time and leaves fewer, longer thread blocks: at WRN-22-2's
  and RN50's block-16 shapes on an H100 the wide groups won where the
  unions held 0.53-0.73 of the entries with 256 or more thread blocks,
  and lost at 0.79-0.83, or with 64 thread blocks (measured where a group
  multiplied its whole width for every entry)."""
  fwd = mode == 'fwd'
  out_w = index.bn if fwd else index.bk
  ptr = index.fwd.ptr if fwd else index.dx.ptr
  ncols = ptr.numel() - 1
  wide = tap_group_cols(out_w, ncols)
  if wide == 1 or index.n_entries == 0:
    return 1
  union = int(index.group_lists(mode, 'cpu', wide).ptr[-1])
  blocks = -(-ncols // wide) * -(-pixels // TAP_WGMMA_ROWS)
  if union <= TAP_GROUP_CUT * index.n_entries and blocks >= sm_count:
    return wide
  return 1


class TapPanelLists(NamedTuple):
  """What tap_conv_tf32_kernel reads for one conv mode at one image
  width.  The output block-columns come in groups of `gcols` (as
  TapGroupLists); a group walks the union of its columns' (tap, input
  block) entries in (input block, tap) order, in panels of one input
  block and TAP_TF32_CHUNK of its channels (a block wider than that takes
  a panel a chunk; where an x tile would pass TAP_TF32_XROWS rows, one tap
  row too) whose x tile -- TAP_TF32_ROWS pixel rows plus the span of the
  panel's shifts (dy W + dx), from its smallest, lo -- every entry of the
  panel reads.  The kernel walks each group's entries in stages of
  TAP_TF32_ENTRIES (a panel starts a stage): group G's are rows sptr[G] ..
  sptr[G+1]-1 of `stab`, TAP_TF32_ROW ints each: the panel's x channel,
  lo, its x tile's TMA boxes of TAP_TF32_BOX rows (at its first stage,
  else 0), 0 and the chunk's offset k0 in the block; from int 8, per
  entry slot, the byte offset of its shifted row 0 in the panel's x tile,
  dy << 16 | dx & 0xFFFF, its column mask (bit c: column c of the group
  holds the entry) and its chunk's channel quads (a slot past the panel's
  entries: dy -2^14, mask and quads 0); from int 8 + 4 TAP_TF32_ENTRIES,
  per slot and column, the row of the column's block in the kernel's W
  copy (its dw entry times the output block width; the zero block, entry
  n_entries, where the column lacks it).  `order`: the groups, most
  stages first; `xrows`: the largest x tile's rows.  int32."""
  sptr: torch.Tensor
  order: torch.Tensor
  stab: torch.Tensor
  gcols: int
  xrows: int


def tap_tf32_tile(index: 'TapIndex', mode: str, pixels: int,
                  sm_count: int, dtype=torch.float32) -> Tuple[int, int]:
  """(gcols, tile) of a 'tf32' call of `mode` over `pixels` = N*H*W pixels
  in `dtype` on a card of sm_count SMs: at output blocks of 16, groups of
  TAP_TF32_GROUP block-columns (tile 32); in bfloat16 at output blocks of
  8, groups of the widest of TAP_TF32_GROUPS_8 (tile 32 or 16); each where
  the layer has as many columns and the groups' thread blocks still give
  every SM one (groups x pixel tiles >= SMs); else one column a thread
  block, in tile 16 where it is at most 16 wide, else in tiles of 64
  (several across a wider one).  A group copies each x tile once for its
  columns and runs each column's products only where it holds the entry:
  on an H100 at WRN-22-2's and RN50's block-16 shapes (f32) groups of 2
  were faster than one column at every point, and groups of 4 (tile 64:
  one thread block an SM, its registers) slower than both; in bf16 at
  WRN-22-2's block-8 shapes groups of 4 8-wide columns were 1.1-1.6x
  faster than groups of 2, and those 1.4-1.6x faster than one column."""
  fwd = mode == 'fwd'
  out_w = index.bn if fwd else index.bk
  ncols = (index.cout if fwd else index.cin) // out_w
  m_tiles = -(-pixels // TAP_TF32_ROWS)
  widths = ((TAP_TF32_GROUP,) if out_w == 16 else
            TAP_TF32_GROUPS_8 if out_w == 8 and dtype == torch.bfloat16
            else ())
  for gcols in widths:
    if ncols >= gcols and -(-ncols // gcols) * m_tiles >= sm_count:
      return gcols, gcols * out_w
  return 1, TAP_TF32_TILES[0] if out_w <= 16 else TAP_TF32_TILES[-1]


class TapDwEntries(NamedTuple):
  """The active entries for dw: tap, cin-block, cout-block and the element
  offset of the entry's block in w (and in dw, which has w's layout)."""
  taps: torch.Tensor
  rblks: torch.Tensor
  cblks: torch.Tensor
  woffs: torch.Tensor


class TapDwGroups(NamedTuple):
  """The dw entries grouped by (input block, output block): group g holds
  entries ptr[g] .. ptr[g+1]-1, at most some max_taps, all of cin-block
  rblks[g] and cout-block cblks[g]; entry e is tap taps[e] with its block
  at element offset woffs[e] of dw.  Groups run by (rblk, cblk), taps
  ascending within a pair; a pair with more taps than a group holds takes
  consecutive groups.  int32."""
  ptr: torch.Tensor
  rblks: torch.Tensor
  cblks: torch.Tensor
  taps: torch.Tensor
  woffs: torch.Tensor


def tap_dw_groups(taps, rblks, cblks, woffs, t_dim: int, nnc: int,
                  max_taps: int) -> TapDwGroups:
  """TapDwGroups of the active entries (tap, cin-block, cout-block, dw
  offset), given T = t_dim taps and nnc cout-blocks, at most max_taps
  taps a group."""
  t, r, j, off = (torch.as_tensor(a, dtype=torch.int64)
                  for a in (taps, rblks, cblks, woffs))
  order = torch.argsort((r * nnc + j) * t_dim + t, stable=True)
  t, r, j, off = t[order], r[order], j[order], off[order]
  pos = torch.arange(t.numel())
  pair = r * nnc + j
  new_pair = torch.ones(t.numel(), dtype=torch.bool)
  new_pair[1:] = pair[1:] != pair[:-1]
  run_start = torch.cummax(torch.where(new_pair, pos, 0), 0).values
  starts = new_pair | ((pos - run_start) % max_taps == 0)
  ptr = torch.cat([pos[starts], torch.tensor([t.numel()])])
  i32 = lambda a: a.to(torch.int32).contiguous()   # noqa: E731
  return TapDwGroups(i32(ptr), i32(r[starts]), i32(j[starts]), i32(t),
                     i32(off))


class TapIndex:
  """Everything the three tap kernels read for one occupancy and one weight
  layout: `fwd` (columns = cout-blocks), `dx` (columns = cin-blocks, taps
  flipped, blocks read transposed) and `dw`; the conv's geometry; and w's
  shape and row stride.  `dense_w`: w is (kh, kw, Cin, Cout), so dw starts
  as zeros; otherwise w is packed (n_active, bk, bn) and every element of
  dw is some entry's.  Lists live on the CPU; `to(device)` copies and the
  dw kernel's tap groups (`dw_groups`) are built on first use and cached,
  so an index is treated as immutable."""

  def __init__(self, taps, rblks, cblks, woffs, *, kernel_size, cin, cout,
               block, w_shape, w_ld, dense_w):
    self.kh, self.kw = kernel_size
    self.cin, self.cout = cin, cout
    self.bk, self.bn = block
    self.w_shape, self.w_ld, self.dense_w = tuple(w_shape), w_ld, dense_w
    t_dim, nkc, nnc = self.kh * self.kw, cin // self.bk, cout // self.bn
    t, r, j, off = (torch.as_tensor(a, dtype=torch.int64)
                    for a in (taps, rblks, cblks, woffs))
    i32 = lambda a: a.to(torch.int32).contiguous()   # noqa: E731

    def grouped(mode, col, key, tap, kblk, n_cols):
      order = torch.argsort(col * (t_dim * max(nkc, nnc)) + key, stable=True)
      self._ids[mode] = order   # the list's entries as dw entries
      ptr = torch.zeros(n_cols + 1, dtype=torch.int64)
      ptr[1:] = torch.cumsum(torch.bincount(col, minlength=n_cols), 0)
      return TapLists(i32(ptr), i32(tap[order]), i32(kblk[order]),
                      i32(off[order]))

    # Forward: by cout-block, then (tap, cin-block), JAX's column-major
    # order.  dx: by cin-block, the flipped tap reading cout-block j.
    self._ids: Dict[str, torch.Tensor] = {}
    self.fwd = grouped('fwd', j, t * nkc + r, t, r, nnc)
    self.dx = grouped('dx', r, (t_dim - 1 - t) * nnc + j, t_dim - 1 - t, j,
                      nkc)
    self.dw = TapDwEntries(i32(t), i32(r), i32(j), i32(off))
    self._cache: Dict[str, 'TapIndex'] = {}

  @property
  def n_entries(self) -> int:
    return int(self.dw.taps.shape[0])

  @property
  def taps_per_pair(self) -> float:
    """The mean number of active taps of an active (cin-block, cout-block)
    pair (0 for an index with no entry)."""
    if 'taps_per_pair' not in self._cache:
      pairs = (self.dw.rblks.long() * (self.cout // self.bn)
               + self.dw.cblks.long()).unique().numel()
      self._cache['taps_per_pair'] = self.n_entries / max(1, pairs)
    return self._cache['taps_per_pair']

  def dw_groups(self, max_taps: int, device='cpu') -> TapDwGroups:
    """The dw entries in groups of at most max_taps taps (tap_dw_groups),
    on `device`; built once per (max_taps, device)."""
    device = torch.device(device)
    key = ('groups', max_taps, str(device))
    if key not in self._cache:
      groups = tap_dw_groups(*(a.cpu() for a in self.dw),
                             self.kh * self.kw, self.cout // self.bn,
                             max_taps)
      self._cache[key] = TapDwGroups(*(a.to(device) for a in groups))
    return self._cache[key]

  def mm_lists(self, mode: str, device) -> DenseLists:
    """A dense-w 1x1 index's lists as the forward / dx kernels of
    csrc/packed_mm.cu take them, on `device`, built once per (mode,
    device): the DenseLists of w's (cin, cout) view (beg = ptr[:-1], end =
    ptr[1:], seg = kblks, woffs), the entries in the index's order."""
    if not self.dense_w:
      raise ValueError('mm_lists: a packed-storage index has none')
    device = torch.device(device)
    key = ('mm', mode, str(device))
    if key not in self._cache:
      ptr, _, seg, woffs = self.fwd if mode == 'fwd' else self.dx
      self._cache[key] = DenseLists(
          *(a.to(device, torch.int32).contiguous()
            for a in (ptr[:-1], ptr[1:], seg, woffs)))
    return self._cache[key]

  def group_lists(self, mode: str, device, gcols: int) -> 'TapGroupLists':
    """The lists of the 'wgmma' branch for `mode`, on `device`, with the
    output block-columns in groups of `gcols` (TapGroupLists); built once
    per (mode, device, gcols)."""
    device = torch.device(device)
    key = ('groups', mode, str(device), gcols)
    if key not in self._cache and device.type != 'cpu':
      cpu = self.group_lists(mode, 'cpu', gcols)
      self._cache[key] = TapGroupLists(*(a.to(device) for a in cpu[:5]),
                                       gcols)
    if key not in self._cache:
      fwd = mode == 'fwd'
      ptr, taps, kblks, woffs = (a.long() for a in
                                 (self.fwd if fwd else self.dx))
      n_in = self.cin // self.bk if fwd else self.cout // self.bn
      ncols = ptr.numel() - 1
      n_groups = -(-ncols // gcols)
      col = torch.repeat_interleave(torch.arange(ncols), ptr.diff())
      pair = taps * n_in + kblks
      span = self.kh * self.kw * n_in
      uniq, inv = torch.unique((col // gcols) * span + pair,
                               return_inverse=True)
      counts = torch.bincount(uniq // span, minlength=n_groups)
      gptr = torch.zeros(n_groups + 1, dtype=torch.int64)
      gptr[1:] = torch.cumsum(counts, 0)
      gwoffs = torch.full((uniq.numel() * gcols,), -1, dtype=torch.int64)
      gwoffs[inv * gcols + col % gcols] = woffs
      order = torch.argsort(-counts, stable=True)
      lists = (gptr, (uniq % span) // n_in, uniq % n_in, gwoffs, order)
      self._cache[key] = TapGroupLists(
          *(a.to(torch.int32).contiguous() for a in lists), gcols)
    return self._cache[key]

  def panel_lists(self, mode: str, device, gcols: int,
                  width: int) -> TapPanelLists:
    """The lists of the 'tf32' branch for `mode` at image width `width`,
    on `device`, with the output block-columns in groups of `gcols`
    (TapPanelLists); built once per (mode, device, gcols, width)."""
    device = torch.device(device)
    key = ('panels', mode, str(device), gcols, width)
    if key not in self._cache and device.type != 'cpu':
      cpu = self.panel_lists(mode, 'cpu', gcols, width)
      self._cache[key] = TapPanelLists(*(a.to(device) for a in cpu[:3]),
                                       gcols, cpu.xrows)
    if key not in self._cache:
      self._cache[key] = self._panel_lists(mode, gcols, width)
    return self._cache[key]

  def _panel_lists(self, mode: str, gcols: int, width: int) -> TapPanelLists:
    fwd = mode == 'fwd'
    ptr, taps, kblks, _ = (a.long() for a in (self.fwd if fwd else self.dx))
    ids = self._ids[mode]
    n_in = self.cin // self.bk if fwd else self.cout // self.bn
    seg, out_w = (self.bk, self.bn) if fwd else (self.bn, self.bk)
    kh, kw = self.kh, self.kw
    t_dim = kh * kw
    ncols = ptr.numel() - 1
    n_groups = -(-ncols // gcols)
    col = torch.repeat_interleave(torch.arange(ncols), ptr.diff())
    span = n_in * t_dim
    uniq, inv = torch.unique((col // gcols) * span + kblks * t_dim + taps,
                             return_inverse=True)
    group, kblk, tap = uniq // span, (uniq % span) // t_dim, uniq % t_dim
    ents = torch.full((uniq.numel() * gcols,), -1, dtype=torch.int64)
    ents[inv * gcols + col % gcols] = ids
    masks = torch.zeros(uniq.numel(), dtype=torch.int64).index_add_(
        0, inv, 1 << (col % gcols))
    dy = tap // kw - kh // 2
    shift = dy * width + tap % kw - kw // 2
    # Runs of one (group, input block), or of one tap row where a whole
    # block's x tile would pass TAP_TF32_XROWS rows.
    by_row = (TAP_TF32_ROWS + 2 * ((kh // 2) * width + kw // 2)
              > TAP_TF32_XROWS)
    run_key = (group * n_in + kblk) * (kh if by_row else 1) + (
        dy + kh // 2 if by_row else 0)
    new_run = torch.ones(uniq.numel(), dtype=torch.bool)
    new_run[1:] = run_key[1:] != run_key[:-1]
    starts = new_run.nonzero().flatten()
    ends = torch.cat([starts[1:], torch.tensor([uniq.numel()])])
    run_id = torch.cumsum(new_run.long(), 0) - 1
    n_runs = starts.numel()
    lo = torch.zeros(n_runs, dtype=torch.int64).scatter_reduce(
        0, run_id, shift, 'amin', include_self=False)
    hi = torch.zeros(n_runs, dtype=torch.int64).scatter_reduce(
        0, run_id, shift, 'amax', include_self=False)
    # Each run a panel a chunk of TAP_TF32_CHUNK channels, each panel
    # stages of TAP_TF32_ENTRIES entries.
    n_chunks = -(-seg // TAP_TF32_CHUNK)
    run = torch.arange(n_runs).repeat_interleave(n_chunks)
    pk0 = torch.arange(n_chunks).repeat(n_runs) * TAP_TF32_CHUNK
    prows = TAP_TF32_ROWS + (hi - lo)[run]
    pstages = -(-(ends - starts)[run] // TAP_TF32_ENTRIES)
    gstages = torch.zeros(n_groups, dtype=torch.int64).index_add_(
        0, group[starts][run], pstages)
    order = torch.argsort(-gstages, stable=True)
    xrows = int(prows.max()) if prows.numel() else TAP_TF32_ROWS
    # The stage table: stage j of panel pp.
    pp = torch.arange(run.numel()).repeat_interleave(pstages)
    j = torch.arange(pp.numel()) - (torch.cumsum(pstages, 0) - pstages)[pp]
    e0, e1, plo, k0 = starts[run[pp]], ends[run[pp]], lo[run[pp]], pk0[pp]
    stab = torch.zeros(pp.numel(), TAP_TF32_ROW, dtype=torch.int64)
    stab[:, 0], stab[:, 1], stab[:, 4] = kblk[e0] * seg + k0, plo, k0
    stab[:, 2] = torch.where(j == 0, -(-prows[pp] // TAP_TF32_BOX), 0)
    dx = tap % kw - kw // 2
    for e in range(TAP_TF32_ENTRIES):
      u = e0 + TAP_TF32_ENTRIES * j + e
      on = u < e1
      uc = torch.where(on, u, 0)
      rec = [(shift[uc] - plo) * 64, dy[uc] * 65536 + (dx[uc] & 0xFFFF),
             masks[uc], torch.clamp(seg - k0, max=TAP_TF32_CHUNK) // 4]
      off = [0, -(1 << 14) * 65536, 0, 0]
      for i in range(4):
        stab[:, 8 + 4 * e + i] = torch.where(on, rec[i], off[i])
      for c in range(gcols):
        eid = ents[uc * gcols + c]
        eid = torch.where(on & (eid >= 0), eid, self.n_entries)
        stab[:, 8 + 4 * TAP_TF32_ENTRIES + e * gcols + c] = eid * out_w
    sptr = torch.zeros(n_groups + 1, dtype=torch.int64)
    sptr[1:] = torch.cumsum(gstages, 0)
    i32 = lambda a: a.to(torch.int32).contiguous()   # noqa: E731
    return TapPanelLists(i32(sptr), i32(order), i32(stab), gcols, xrows)

  def to(self, device) -> 'TapIndex':
    device = torch.device(device)
    if self.fwd.ptr.device == device:
      return self
    key = str(device)
    if key not in self._cache:
      new = object.__new__(TapIndex)
      new.__dict__.update(self.__dict__)
      new.fwd = TapLists(*(a.to(device) for a in self.fwd))
      new.dx = TapLists(*(a.to(device) for a in self.dx))
      new.dw = TapDwEntries(*(a.to(device) for a in self.dw))
      new._cache = {}
      self._cache[key] = new
    return self._cache[key]


def _check_geometry(kernel_size, cin, cout, block):
  kh, kw = kernel_size
  bk, bn = block
  if cin % bk or cout % bn:
    raise ValueError(f'channels ({cin},{cout}) must divide block {block}')
  if (kh, kw) != (1, 1) and (kh % 2 == 0 or kw % 2 == 0):
    raise ValueError(
        f'tap conv requires odd spatial kernel dims, got ({kh},{kw}): the '
        'symmetric ph=k//2 padding differs from SAME semantics for even k')


def tap_index(packing, w_shape, block: Tuple[int, int]) -> TapIndex:
  """The TapIndex of a pack_tap_active packing ({'cols','rows','taps'})
  over a dense (kh, kw, Cin, Cout) kernel; built once per (w_shape,
  block) and kept on the packing where it is a TapPack."""
  kh, kw, cin, cout = (int(s) for s in w_shape)
  block = tuple(block)

  def make():
    _check_geometry((kh, kw), cin, cout, block)
    bk, bn = block
    cols, rows, taps = (torch.as_tensor(packing[k]).cpu().long()
                        for k in ('cols', 'rows', 'taps'))
    keep = taps >= 0
    t, r, j = taps[keep], rows[keep], cols[keep]
    woffs = t * cin * cout + r * bk * cout + j * bn
    return TapIndex(t, r, j, woffs, kernel_size=(kh, kw), cin=cin,
                    cout=cout, block=block, w_shape=(kh, kw, cin, cout),
                    w_ld=cout, dense_w=True)
  if isinstance(packing, TapPack):
    return packing.derived(('tap', kh, kw, cin, cout, block), make)
  return make()


def packed_tap_index(packing: Packing, kernel_size: Tuple[int, int],
                     cin: int, block: Tuple[int, int]) -> TapIndex:
  """The TapIndex of a PackedConv's 2D Packing over the (kh*kw*Cin, Cout)
  view, reading the packed (n_active, bk, bn) storage; cached on the
  Packing."""
  key = ('tap', tuple(kernel_size), cin, tuple(block))
  if key not in packing._cache:
    kh, kw = kernel_size
    bk, bn = block
    nk2, nn_ = packing.shape
    _check_geometry((kh, kw), cin, nn_ * bn, block)
    nkc = cin // bk
    if nk2 != kh * kw * nkc:
      raise ValueError(f'packing grid {packing.shape} is not a '
                       f'({kh}x{kw}x{cin}, {nn_ * bn}) conv at block {block}')
    n_act = packing.n_active
    col_ptr, rows2d = (a.cpu().long() for a in packing.column_index('cpu'))
    cols = torch.repeat_interleave(torch.arange(nn_), col_ptr.diff())
    slots = torch.arange(n_act)
    packing._cache[key] = TapIndex(
        rows2d // nkc, rows2d % nkc, cols, slots * bk * bn,
        kernel_size=(kh, kw), cin=cin, cout=nn_ * bn, block=block,
        w_shape=(n_act, bk, bn), w_ld=bn, dense_w=False)
  return packing._cache[key]


# ------------------------------------------------------- plain versions ---
def _block(flat: torch.Tensor, off: int, rows: int, cols: int, ld: int):
  """The (rows x cols) block at element `off` of the flat tensor, rows `ld`
  apart: a view."""
  return flat[off:off + (rows - 1) * ld + cols].as_strided((rows, cols),
                                                           (ld, 1))


def _padded(x: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
  """x (N, H, W, C) in f32, zero-padded by kh//2 rows and kw//2 columns on
  each side: tap t's shifted input is the slice at (t // kw, t % kw)."""
  return F.pad(x.float(), (0, 0, kw // 2, kw // 2, kh // 2, kh // 2))


def tap_conv_reference(x: torch.Tensor, w: torch.Tensor, index: TapIndex,
                       mode: str = 'fwd') -> torch.Tensor:
  """Plain version of the tap conv ('fwd': y from x; 'dx': dx from gy):
  for each output column, the f32 sum over its entries of the shifted
  input block times the weight block (transposed for dx); one cast to
  x.dtype.  Columns without entries are zeros."""
  cpu = index.to('cpu')
  ptr, taps, kblks, woffs = (a.tolist()
                             for a in (cpu.fwd if mode == 'fwd' else cpu.dx))
  bk, bn = (index.bk, index.bn) if mode == 'fwd' else (index.bn, index.bk)
  n, h, wd, _ = x.shape
  kw = index.kw
  xp = _padded(x, index.kh, kw)
  n_cols = len(ptr) - 1
  y = torch.zeros((n, h, wd, n_cols * bn), dtype=torch.float32,
                  device=x.device)
  wf = w.detach().float().reshape(-1)
  for g in range(n_cols):
    for e in range(ptr[g], ptr[g + 1]):
      dy, dx = divmod(taps[e], kw)
      xs = xp[:, dy:dy + h, dx:dx + wd, kblks[e] * bk:(kblks[e] + 1) * bk]
      wb = (_block(wf, woffs[e], bn, bk, index.w_ld).T if mode == 'dx'
            else _block(wf, woffs[e], bk, bn, index.w_ld))
      y[..., g * bn:(g + 1) * bn] += xs @ wb
  return y.to(x.dtype)


def tap_dw_reference(x: torch.Tensor, gy: torch.Tensor, index: TapIndex,
                     out_dtype=None) -> torch.Tensor:
  """Plain version of dw: for each active entry, the f32 sum over all
  pixels of the shifted input block (transposed) times gy's block, written
  at the entry's offset of a tensor of w's shape (zeros elsewhere); one
  cast to `out_dtype` (x's when None)."""
  bk, bn, kw = index.bk, index.bn, index.kw
  n, h, wd, _ = x.shape
  xp = _padded(x, index.kh, kw)
  g2 = gy.float().reshape(-1, gy.shape[-1])
  out = torch.zeros(index.w_shape, dtype=torch.float32, device=x.device)
  flat = out.reshape(-1)
  for t, r, j, off in zip(*(a.tolist() for a in index.to('cpu').dw)):
    dy, dx = divmod(t, kw)
    xs = xp[:, dy:dy + h, dx:dx + wd, r * bk:(r + 1) * bk].reshape(-1, bk)
    _block(flat, off, bk, bn, index.w_ld).copy_(
        xs.T @ g2[:, j * bn:(j + 1) * bn])
  return out.to(out_dtype or x.dtype)


# ---------------------------------------------------------------- kernels --
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _kernel(name: str):
  """The C entry point `name` of csrc/tap_conv.cu: pointers, then ints,
  then the stream; returns the CUDA error code of the launch."""
  n_ptrs, n_ints = {'tap_conv_fwd': (11, 16), 'tap_conv_dx': (11, 16),
                    'tap_dw': (9, 15)}[name]
  fn = getattr(_build.load('tap_conv'), name)
  fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                 + [ctypes.c_void_p])
  fn.restype = ctypes.c_int
  return fn


def _launch(name: str, *args):
  err = _kernel(name)(*args)
  if err:
    raise RuntimeError(f'{name} launch failed: CUDA error {err}')


def _check_cuda(op: str, acts, w: torch.Tensor, index: TapIndex):
  """What every kernel takes: NHWC activations `acts` ((name, tensor,
  channels) triples) and w on one CUDA device, float32 or bfloat16 of one
  dtype, contiguous, 16-byte aligned, w of the index's shape, blocks of
  whole 16-byte copies, and sizes that fit int32 offsets.  Raises
  otherwise."""
  x = acts[0][1]
  for name, a, chans in acts:
    if not (a.is_cuda and w.device == a.device == x.device):
      raise ValueError(f'{name} ({a.device}) and w ({w.device}) must be on '
                       'one CUDA device')
    if a.dtype not in _DTYPE_CODE or w.dtype != a.dtype:
      raise TypeError(f'{op} takes float32 or bfloat16 {name} and w of one '
                      f'dtype, got {a.dtype} and {w.dtype}')
    if a.dim() != 4 or a.shape[-1] != chans or a.shape[:3] != x.shape[:3]:
      raise ValueError(f'{name} must be NHWC with {chans} channels, got '
                       f'{tuple(a.shape)}')
    if not a.is_contiguous() or a.data_ptr() % 16:
      raise ValueError(f'{op}: {name} must be contiguous and 16-byte aligned')
    if a.numel() >= 2 ** 31:
      raise ValueError(f'{op}: {name} has too many elements for the kernel')
  if tuple(w.shape) != index.w_shape:
    raise ValueError(f'w must be {index.w_shape}, got {tuple(w.shape)}')
  if not w.is_contiguous() or (w.numel() and w.data_ptr() % 16):
    raise ValueError(f'{op}: w must be contiguous and 16-byte aligned')
  vec = 16 // x.element_size()       # elements per 16-byte copy
  if index.bk % vec or index.bn % vec:
    raise ValueError(f'block {(index.bk, index.bn)} must be a multiple of '
                     f'{vec} for {x.dtype}')


def tap_conv_cuda(x: torch.Tensor, w: torch.Tensor, index: TapIndex,
                  mode: str = 'fwd') -> torch.Tensor:
  """The tap conv on the card ('fwd': y from x; 'dx': dx from gy) on the
  current stream, by the branch tap_branch names: 'mm' (a 1x1 kernel) on
  csrc/packed_mm.cu's forward / dx kernels over w's (cin, cout) view, as
  block_sparse_v4's B7 (a packed-storage 1x1 is refused: PackedConv runs
  its 1x1s as PackedConv1x1, on packed_matmul, and never here), else
  csrc/tap_conv.cu's kernel of that branch; counted in
  tap_conv_fwd_launches / tap_conv_dx_launches whatever the branch.
  Checks what the kernels take and raises on anything else; a branch that
  cannot take the call is refused, and nothing falls back to another
  kernel."""
  global tap_conv_fwd_launches, tap_conv_dx_launches
  global tap_mm_fwd_launches, tap_mm_dx_launches
  fwd = mode == 'fwd'
  cx, cy = (index.cin, index.cout) if fwd else (index.cout, index.cin)
  bk, bn = (index.bk, index.bn) if fwd else (index.bn, index.bk)
  _check_cuda(f'tap_conv_{mode}', [('x' if fwd else 'gy', x, cx)], w, index)
  n, h, wd, _ = x.shape
  if n * h * wd * cy == 0:
    return torch.empty((n, h, wd, cy), dtype=x.dtype, device=x.device)
  branch = tap_branch(index.kh, index.kw, index.bk, index.bn, x.dtype)
  if branch == 'mm':
    if (index.kh, index.kw) != (1, 1):
      raise ValueError(f"the 'mm' branch takes a 1x1 kernel, not "
                       f'{(index.kh, index.kw)}')
    if not index.dense_w:
      raise ValueError("the 'mm' branch takes a dense-w 1x1 index; packed "
                       '1x1 kernels run on packed_matmul (PackedConv1x1)')
    y = dense_mm_cuda(x.view(-1, cx), w.view(index.cin, index.cout),
                      index.mm_lists(mode, x.device), (index.bk, index.bn),
                      mode).view(n, h, wd, cy)
    if fwd:
      tap_mm_fwd_launches += 1
    else:
      tap_mm_dx_launches += 1
  else:
    y = torch.empty((n, h, wd, cy), dtype=x.dtype, device=x.device)
    gcols, tile, xrows, n_ent = 1, 0, 0, 0
    extra = [None] * 3     # tf32: stage table, entry offsets, W's copy
    if branch == 'wgmma':
      gcols = tap_wgmma_gcols(index, mode, n * h * wd,
                              dw_split.sm_count(x.device))
      tile = tap_wgmma_tile(gcols, bn)
      *lists, _ = index.group_lists(mode, x.device, gcols)
    else:   # 'tf32'
      gcols, tile = tap_tf32_tile(index, mode, n * h * wd,
                                  dw_split.sm_count(x.device), x.dtype)
      pl = index.panel_lists(mode, x.device, gcols, wd)
      lists = [pl.sptr, None, None, None, pl.order]
      n_ent, xrows = index.n_entries, pl.xrows
      # The blocks' K-major f32 copy (hi / lo in f32) and a block of zeros
      # (tap_w_split_kernel), each row's contraction in whole chunks: lives
      # through the launch, on the stream's allocator.
      segp = -(-bk // TAP_TF32_CHUNK) * TAP_TF32_CHUNK
      parts = 2 if x.dtype == torch.float32 else 1
      wt = torch.empty(parts * (n_ent + 1) * bn * segp, dtype=torch.float32,
                       device=x.device)
      extra = [pl.stab, index.to(x.device).dw.woffs, wt]
    _launch('tap_conv_fwd' if fwd else 'tap_conv_dx', x.data_ptr(),
            w.data_ptr(),
            *(0 if a is None else a.data_ptr() for a in lists + extra),
            y.data_ptr(), n * h * wd, h, wd, cx, cy // bn, index.kh,
            index.kw, bk, bn, index.w_ld, gcols, tile, xrows, n_ent,
            TAP_BRANCHES.index(branch), _DTYPE_CODE[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
  if fwd:
    tap_conv_fwd_launches += 1
  else:
    tap_conv_dx_launches += 1
  return y


def tap_dw_taps(index: TapIndex, dtype) -> int:
  """The group size tap_dw_kernel takes for `index` in `dtype`:
  TAP_SPARSE_TAPS where its pairs hold at most TAP_SPARSE_MEAN taps on
  average, else TAP_GROUP_TAPS[dtype]."""
  if index.taps_per_pair <= TAP_SPARSE_MEAN:
    return TAP_SPARSE_TAPS
  return TAP_GROUP_TAPS[dtype]


def tap_dw_plan(index: TapIndex, pixels: int, dtype,
                sm_count: int) -> DwPlan:
  """How tap_dw_kernel splits the pixel sum of `index`'s dw in `dtype` over
  `pixels` = N*H*W pixels on a card of sm_count SMs: slices, pixels per
  slice, the grid (groups, tiles per group, slices) and the f32
  workspace's bytes (0 with one slice).  A partial tile holds the group's
  tap_dw_taps taps; a chunk reads DP rows of x's and of gy's 16
  channels."""
  taps = tap_dw_taps(index, dtype)
  n_groups = int(index.dw_groups(taps).rblks.shape[0])
  tiles = -(-index.bk // TAP_DW_TILE) * -(-index.bn // TAP_DW_TILE)
  part = taps * TAP_DW_TILE * TAP_DW_TILE * 4
  chunk_bytes = TAP_DW_CHUNK * 2 * TAP_DW_TILE * dtype.itemsize
  per_sm = 4 if taps == TAP_SPARSE_TAPS else 2   # the kernel's launch bounds
  slices = dw_split.split_plan(n_groups * tiles, pixels, TAP_DW_CHUNK,
                               per_sm * sm_count, part / chunk_bytes)
  return DwPlan(slices, dw_split.slice_rows(pixels, TAP_DW_CHUNK, slices),
                (n_groups, tiles, slices),
                0 if slices == 1 else slices * n_groups * tiles * part)


def tap_dw_cuda(x: torch.Tensor, gy: torch.Tensor, w: torch.Tensor,
                index: TapIndex) -> torch.Tensor:
  """dw in w's layout and dtype: launches tap_dw_kernel over the index's
  tap groups, split as tap_dw_plan says, and tap_dw_reduce_kernel where
  it splits; a 1x1 kernel's dw runs the block dw of packed_mm.cu instead.
  A dense w's other elements are zeros.  Checks and raises as
  tap_conv_cuda does (x, gy and w of one dtype)."""
  global tap_dw_launches, tap_mm_dw_launches
  _check_cuda('tap_dw', [('x', x, index.cin), ('gy', gy, index.cout)], w,
              index)
  n, h, wd, _ = x.shape
  dw = (torch.zeros_like(w) if index.dense_w else torch.empty_like(w))
  if index.n_entries == 0 or x.numel() == 0:
    return dw.zero_()
  if index.kh == index.kw == 1:
    # No tap shifts: entry e's block is x[:, r-block]ᵀ @ gy[:, j-block] over
    # the pixels, the block dw of csrc/packed_mm.cu's dw kernels (wgmma on
    # 128 x 128 tiles in bf16), in packed storage (slot e, as
    # packed_tap_index lists the entries) or dense (w's (cin, cout) view).
    ent = index.to(x.device).dw
    dw_launch(x.view(-1, index.cin), gy.view(-1, index.cout), ent.rblks,
              ent.cblks, None, dw, (index.bk, index.bn), index.dense_w)
    tap_dw_launches += 1
    tap_mm_dw_launches += 1
    return dw
  taps = tap_dw_taps(index, x.dtype)
  groups = index.dw_groups(taps, x.device)
  plan = tap_dw_plan(index, n * h * wd, x.dtype, dw_split.sm_count(x.device))
  buf, ws = dw_workspace(plan, x.device)   # buf lives through the launch
  _launch('tap_dw', x.data_ptr(), gy.data_ptr(),
          *(a.data_ptr() for a in groups), dw.data_ptr(), ws,
          n * h * wd, h, wd, index.cin, index.cout, plan.grid[0], index.kh,
          index.kw, index.bk, index.bn, index.w_ld, taps, plan.slices,
          plan.slice_rows, _DTYPE_CODE[x.dtype],
          torch.cuda.current_stream(x.device).cuda_stream)
  tap_dw_launches += 1
  return dw


# --------------------------------------------------------------- autograd --
def _conv(x, w, index, mode='fwd'):
  fn = _on_device(f'tap conv {mode}', x, tap_conv_reference, tap_conv_cuda)
  return fn(x, w, index, mode)


class _TapConv(torch.autograd.Function):
  """y = the tap conv of x; backward: dx through the flipped, transposed
  entries (only if x needs it) and dw on the active entries in w's layout
  (only if w needs it), each by the plain version on the CPU and the
  kernel on CUDA."""

  @staticmethod
  def forward(ctx, x, w, index):
    ctx.save_for_backward(x, w)
    ctx.index = index
    return _conv(x, w, index)

  @staticmethod
  def backward(ctx, gy):
    x, w = ctx.saved_tensors
    index = ctx.index
    gy = gy.contiguous()
    dx = dw = None
    if ctx.needs_input_grad[0]:
      dx = _conv(gy, w, index, 'dx')
    if ctx.needs_input_grad[1]:
      def plain(x, gy, w, index):
        return tap_dw_reference(x, gy, index, w.dtype)
      dw = _on_device('tap conv dw', gy, plain, tap_dw_cuda)(x, gy, w, index)
    return dx, dw, None


def tap_conv(x: torch.Tensor, w: torch.Tensor, index: TapIndex):
  """The tap conv of NHWC x with w as `index` describes it, differentiable
  in x and w.  A call that needs no gradient skips the autograd Function."""
  x = x.contiguous()
  if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
    return _TapConv.apply(x, w, index)
  return _conv(x, w, index)


def block_sparse_conv_tap(x: torch.Tensor, w4d: torch.Tensor, packing,
                          block: Tuple[int, int] = (128, 128),
                          bm: Optional[int] = None):
  """Stride-1 SAME NHWC conv through the tap-block-skipping kernels.

  x: (N, H, W, Cin); w4d: (kh, kw, Cin, Cout), odd kh / kw (or 1x1);
  packing: {'cols','rows','taps'} from pack_tap_active.  dw is (kh, kw,
  Cin, Cout), zeros outside the active blocks.  `bm` is kept for the JAX
  signature: the kernels pick their own tiles."""
  del bm
  return tap_conv(x, w4d, tap_index(packing, w4d.shape, tuple(block)))


def packed_conv_tap(x: torch.Tensor, kernel: torch.Tensor, packing: Packing,
                    kernel_size: Tuple[int, int], block: Tuple[int, int]):
  """The same conv with the kernel in packed (n_active, bk, bn) storage
  over the (kh*kw*Cin, Cout) view of `packing`; dw comes back packed."""
  return tap_conv(x, kernel, packed_tap_index(packing, tuple(kernel_size),
                                              x.shape[-1], tuple(block)))
