"""Block-sparse matmul over DENSE weight storage from per-column index
lists, and the gathered dw, in PyTorch.

Counterpart of rigl_tpu/ops/pallas/block_sparse_v3.py, with
`pack_block_indices` imported from block_sparse_v2.py as there.  The
weight is the full (K, N)
matrix of a dense-masked layer; a (K/bk, N/bn) occupancy says which of its
(bk, bn) blocks take part:

  y  = x @ (expanded(block_mask) * w)      block_sparse_matmul_v3
  dx = gy @ (expanded(block_mask) * w)ᵀ    its backward, W read transposed
  dw = xᵀ @ gy at the active blocks        'gather' (the B9 kernel) or
                                           'dense' (one product, summed in
                                           f32, times the expanded mask)

Both products run on the mm kernels of csrc/packed_mm.cu (the branch by
block_sparse_packed.mm_branch) in their dense storage mode (replacing the TPU kernel `_v3_kernel`), and the gathered dw
on the dw kernels (`packed_dw_wgmma_kernel` in bf16,
`packed_dw_3xtf32_kernel` in f32) in their dense mode (replacing `_dw_v2_kernel`).  A
kernel reads DenseLists: for every output block-column, a run of entries,
each an input block-column and the element offset of its W block.  Here
the runs come from `pack_block_indices` (column j's entries are
j*nk .. j*nk + counts[j] - 1 of the flattened index table), so nothing on
the hot path waits for the device; block_sparse_v4.py builds them from its
flat packing.

`pallas_dense_matmul` (the dense tiled control, replacing `_dense_kernel`)
runs the forward mode over an all-active occupancy.

Each product has a plain PyTorch version that walks the same entries with
one torch.matmul per active block, summed in f32 and cast once
(`dense_mm_reference`, `dense_dw_reference`), which CPU tensors take; CUDA
tensors launch the kernel or raise.  The kernels mask ragged m, so rows
need no padding to `bm`, which is kept for the JAX signatures.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from rigl_tpu_torch.ops import _build
from rigl_tpu_torch.ops import block_sparse_packed as bsp
from rigl_tpu_torch.ops.block_sparse_packed import (_DTYPE_CODE, _on_device,
                                                    dw_launch)
from rigl_tpu_torch.ops.block_sparse_v2 import pack_block_indices

# Launches of each kernel mode through this module's wrappers.  Each
# wrapper adds one per launch; nothing else touches them but callers
# resetting them.
v3_fwd_launches = 0     # the mm kernels, dense forward, index-list form
v3_dx_launches = 0      # the mm kernels, dense dx, index-list form
dw_gather_launches = 0  # the dw kernels, dense mode (B9)
dense_control_launches = 0  # the mm kernels, dense forward, all active (B9')

# Density assumed by the 'auto' dw traffic model (JAX's _AUTO_DENSITY): the
# choice must be static, as the mask evolves.
_AUTO_DENSITY = 0.3


def dw_mode_for(shape: Tuple[int, int], block: Tuple[int, int],
                dw_mode: str) -> str:
  """'auto' -> 'gather' or 'dense' by JAX's traffic model: the gather
  re-reads (bk + bn)-wide row panels once per active block (assumed
  density _AUTO_DENSITY), the dense product reads each operand once."""
  if dw_mode != 'auto':
    if dw_mode not in ('dense', 'gather'):
      raise ValueError(f"dw_mode must be 'auto', 'dense' or 'gather', got "
                       f'{dw_mode!r}')
    return dw_mode
  kdim, n = shape
  bk, bn = block
  gather_bytes = _AUTO_DENSITY * (kdim // bk) * (n // bn) * (bk + bn)
  return 'gather' if gather_bytes < (kdim + n) else 'dense'


# ------------------------------------------------------------- entries ----
class DenseLists(NamedTuple):
  """One product's entries grouped by output block-column g: entries
  beg[g] .. end[g] - 1, each reading input block-column seg[e] and the
  (bk, bn) block of W at element offset woffs[e] (rows N apart).  int32,
  on the device of the index they came from."""
  beg: torch.Tensor
  end: torch.Tensor
  seg: torch.Tensor
  woffs: torch.Tensor


class DwEntries(NamedTuple):
  """The blocks dw writes: (rows[s], cols[s]) for each s, skipped where
  flags is given and flags[s] == 0.  int32."""
  rows: torch.Tensor
  cols: torch.Tensor
  flags: Optional[torch.Tensor]


def _i32(t: torch.Tensor) -> torch.Tensor:
  return t.to(torch.int32).contiguous()


def occupancy_lists(block_mask: torch.Tensor, block: Tuple[int, int],
                    n: int, mode: str = 'fwd') -> DenseLists:
  """The entries of an occupancy over a (K, N = n) weight: for the forward
  grouped by output column (pack_block_indices), for dx by block-row
  (pack_block_indices of the transpose)."""
  bk, bn = block
  occ = torch.as_tensor(block_mask)
  if mode == 'dx':
    occ = occ.T
  counts, idx = pack_block_indices(occ)
  groups, per = idx.shape
  dev = idx.device
  beg = torch.arange(groups, device=dev, dtype=torch.int64) * per
  seg = idx.reshape(-1).long()
  g = torch.arange(groups * per, device=dev, dtype=torch.int64) // per
  if mode == 'dx':   # group g = block-row k, seg = block-column j
    woffs = g * bk * n + seg * bn
  else:              # group g = block-column j, seg = block-row k
    woffs = seg * bk * n + g * bn
  return DenseLists(_i32(beg), _i32(beg + counts.long()), _i32(seg),
                    _i32(woffs))


def occupancy_dw_entries(block_mask: torch.Tensor) -> DwEntries:
  """Every block of the grid with its occupancy as the flag (JAX's grid
  over all blocks, inactive ones writing zeros)."""
  occ = torch.as_tensor(block_mask)
  nk, nn_ = occ.shape
  flat = torch.arange(nk * nn_, device=occ.device)
  return DwEntries(_i32(flat // nn_), _i32(flat % nn_),
                   _i32(occ.reshape(-1) != 0))


# ------------------------------------------------------- plain versions ---
def dense_mm_reference(x: torch.Tensor, w: torch.Tensor, lists: DenseLists,
                       block: Tuple[int, int], mode: str = 'fwd'):
  """Plain version of both products: for every output block-column, the
  f32 sum over its entries of x's block-column times the W block (read
  transposed for dx), one torch.matmul per entry; cast once to x.dtype.
  A column without entries is zero."""
  bk, bn = block
  seg_w, out_w = (bn, bk) if mode == 'dx' else (bk, bn)
  n = w.shape[1]
  beg, end, seg, woffs = (t.tolist() for t in lists)
  out = torch.zeros((x.shape[0], len(beg) * out_w), dtype=torch.float32,
                    device=x.device)
  wf = w.reshape(-1)
  for g, (b, e) in enumerate(zip(beg, end)):
    acc = out[:, g * out_w:(g + 1) * out_w]
    for a in range(b, e):
      blk = wf[woffs[a]:woffs[a] + (bk - 1) * n + bn].as_strided(
          (bk, bn), (n, 1)).float()
      xs = x[:, seg[a] * seg_w:(seg[a] + 1) * seg_w].float()
      acc += xs @ (blk.T if mode == 'dx' else blk)
  return out.to(x.dtype)


def dense_dw_reference(x: torch.Tensor, gy: torch.Tensor, entries: DwEntries,
                       block: Tuple[int, int], out_dtype):
  """Plain version of the gathered dw: a zero (K, N) with each flagged
  block (rows[s], cols[s]) set to x[:, r-block]ᵀ @ gy[:, c-block], summed
  over m in f32 and cast once to `out_dtype`."""
  bk, bn = block
  dw = torch.zeros((x.shape[1], gy.shape[1]), dtype=out_dtype,
                   device=x.device)
  flags = (entries.flags.tolist() if entries.flags is not None
           else [1] * entries.rows.numel())
  for r, c, f in zip(entries.rows.tolist(), entries.cols.tolist(), flags):
    if f:
      dw[r * bk:(r + 1) * bk, c * bn:(c + 1) * bn] = (
          x[:, r * bk:(r + 1) * bk].float().T
          @ gy[:, c * bn:(c + 1) * bn].float()).to(out_dtype)
  return dw


# --------------------------------------------------------------- kernels --
@functools.cache
def _kernel(name: str):
  """The C entry point `name` of csrc/packed_mm.cu's dense modes: pointers,
  then ints, then the stream; returns the CUDA error code of the launch."""
  n_ptrs, n_ints = {'dense_mm_fwd': (7, 9), 'dense_mm_dx': (7, 8)}[name]
  fn = getattr(_build.load('packed_mm'), name)
  fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                 + [ctypes.c_void_p])
  fn.restype = ctypes.c_int
  return fn


def _launch(name: str, *args):
  err = _kernel(name)(*args)
  if err:
    raise RuntimeError(f'{name} launch failed: CUDA error {err}')


def _check_cuda(op: str, acts, w: torch.Tensor, block: Tuple[int, int],
                index):
  """What the dense-mode kernels take: activations (name, tensor, width)
  and w on one CUDA device, float32 or bfloat16 of one dtype, contiguous
  and 16-byte aligned, the index on that device, a block of whole 16-byte
  copies that divides w, and offsets inside int32.  Raises otherwise."""
  bk, bn = block
  x = acts[0][1]
  for name, a, cols in acts:
    if not (a.is_cuda and a.device == w.device == x.device):
      raise ValueError(f'{name} ({a.device}) and w ({w.device}) must be on '
                       'one CUDA device')
    if a.dtype not in _DTYPE_CODE or w.dtype != a.dtype:
      raise TypeError(f'{op} takes float32 or bfloat16 {name} and w of one '
                      f'dtype, got {a.dtype} and {w.dtype}')
    if a.dim() != 2 or a.shape[1] != cols or a.shape[0] != x.shape[0]:
      raise ValueError(f'{name} must be (m, {cols}), got {tuple(a.shape)}')
  if w.dim() != 2 or w.shape[0] % bk or w.shape[1] % bn:
    raise ValueError(f'w {tuple(w.shape)} must be 2-D and divide block '
                     f'{block}')
  if w.numel() >= 2 ** 31:
    raise ValueError(f'{op}: w of {w.numel()} elements overflows the int32 '
                     'block offsets')
  if not (all(a.is_contiguous() for _, a, _ in acts) and w.is_contiguous()):
    raise ValueError(f'{op}: operands must be contiguous')
  vec = 16 // x.element_size()
  if bk % vec or bn % vec:
    raise ValueError(f'block {block} must be a multiple of {vec} for '
                     f'{x.dtype}')
  if any(a.data_ptr() % 16 for _, a, _ in acts) or w.data_ptr() % 16:
    raise ValueError(f'{op}: operands must start on a 16-byte boundary')
  for t in index:
    if t is not None and (t.device != w.device or t.dtype != torch.int32
                          or not t.is_contiguous()):
      raise ValueError(f'{op}: index tensors must be contiguous int32 on '
                       f'{w.device}')


def dense_mm_cuda(x: torch.Tensor, w: torch.Tensor, lists: DenseLists,
                  block: Tuple[int, int], mode: str = 'fwd'):
  """Launches the mm kernel of block_sparse_packed.mm_branch in its dense
  storage mode on the current stream: the forward (y = x @ W over the
  entries) or dx (gy @ Wᵀ, W read transposed in place).  The decode
  branch's plan takes every input block-column as the longest column (the
  lists lie on the device, and their lengths are not read back).  Counts
  only block_sparse_packed.mm_decode_launches: callers count their own
  launches.  Checks what the kernel takes and raises on anything else."""
  bk, bn = block
  kdim, n = w.shape
  width = n if mode == 'dx' else kdim
  _check_cuda(f'dense_mm {mode}', [('x', x, width)], w, block, lists)
  m, groups = x.shape[0], lists.beg.shape[0]
  out_w = bk if mode == 'dx' else bn
  y = torch.empty((m, groups * out_w), dtype=x.dtype, device=x.device)
  if m == 0:
    return y
  stream = torch.cuda.current_stream(x.device).cuda_stream
  ptrs = (x.data_ptr(), w.data_ptr(), lists.beg.data_ptr(),
          lists.end.data_ptr(), lists.seg.data_ptr(), lists.woffs.data_ptr(),
          y.data_ptr())
  seg_w = bn if mode == 'dx' else bk
  branch = bsp.mm_branch(m, seg_w, x.dtype)
  slices = bsp.decode_slices(branch, m, out_w, groups, seg_w,
                             width // seg_w, x.dtype, x.device)
  code = bsp.MM_BRANCHES.index(branch)
  if mode == 'dx':
    _launch('dense_mm_dx', *ptrs, m, n, groups, bk, bn, code, slices,
            _DTYPE_CODE[x.dtype], stream)
  else:
    _launch('dense_mm_fwd', *ptrs, m, kdim, groups, bk, bn, n, code, slices,
            _DTYPE_CODE[x.dtype], stream)
  bsp.mm_decode_launches += branch == 'decode'
  return y


def dense_dw_launch(x: torch.Tensor, gy: torch.Tensor, w: torch.Tensor,
                    entries: DwEntries, block: Tuple[int, int]):
  """The gathered dw (K, N) in w's dtype, zeros outside the written
  blocks: launches the dw kernel of the dtype in its dense mode on the
  current stream, split as block_sparse_packed.dw_plan says.  Counts
  nothing: callers count their own launches.  Checks and raises as
  dense_mm_cuda does.  Returns (dw, launched)."""
  kdim, n = w.shape
  _check_cuda('dense_dw', [('x', x, kdim), ('gy', gy, n)], w, block, entries)
  dw = torch.zeros_like(w)
  n_ent = entries.rows.shape[0]
  if x.shape[0] == 0 or n_ent == 0:
    return dw, False
  dw_launch(x, gy, entries.rows, entries.cols, entries.flags, dw, block,
            True)
  return dw, True


def dense_dw_cuda(x: torch.Tensor, gy: torch.Tensor, w: torch.Tensor,
                  entries: DwEntries, block: Tuple[int, int]):
  """dense_dw_launch counted in dw_gather_launches."""
  global dw_gather_launches
  dw, launched = dense_dw_launch(x, gy, w, entries, block)
  dw_gather_launches += launched
  return dw


def v3_matmul_cuda(x: torch.Tensor, w: torch.Tensor, lists: DenseLists,
                   block: Tuple[int, int], mode: str = 'fwd'):
  """dense_mm_cuda counted in v3_fwd_launches / v3_dx_launches."""
  global v3_fwd_launches, v3_dx_launches
  y = dense_mm_cuda(x, w, lists, block, mode)
  if x.shape[0]:
    if mode == 'dx':
      v3_dx_launches += 1
    else:
      v3_fwd_launches += 1
  return y


# -------------------------------------------------------------- products --
def _check_shapes(x: torch.Tensor, w: torch.Tensor, block: Tuple[int, int]):
  bk, bn = block
  if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
    raise ValueError(f'x {tuple(x.shape)} @ w {tuple(w.shape)}: need 2-D '
                     'operands with matching K')
  if w.shape[0] % bk or w.shape[1] % bn:
    raise ValueError(f'w {tuple(w.shape)} must divide block {block}')


def matmul_lists(x, w, lists, block, mode, kernel):
  """One product over `lists`: the plain version on the CPU, `kernel` (a
  counting wrapper of dense_mm_cuda) on CUDA."""
  fn = _on_device(f'dense block matmul {mode}', x, dense_mm_reference,
                  kernel)
  return fn(x, w, lists, block, mode)


def gather_dw(x, gy, w, entries, block, kernel=dense_dw_cuda):
  """The gathered dw (B9): the plain version on the CPU, `kernel` (a
  counting wrapper of dense_dw_launch) on CUDA."""
  def plain(x, gy, w, entries, block):
    return dense_dw_reference(x, gy, entries, block, w.dtype)
  return _on_device('gathered dw', x, plain, kernel)(x, gy, w, entries,
                                                       block)


def masked_dense_dw(x: torch.Tensor, gy: torch.Tensor, occ: torch.Tensor,
                    block: Tuple[int, int], out_dtype):
  """dw_mode='dense': the product xᵀ @ gy, summed in f32, times the
  expanded occupancy, in `out_dtype` (JAX leaves this one to XLA; it is a
  plain torch.matmul here).  When the operands are already in `out_dtype`
  the product runs in it, as JAX's dot with f32 accumulation does, with no
  f32 copies of the (m, K) and (m, N) operands: the matmul accumulates in
  f32 (cuBLAS may add split-k partial sums in bf16 under torch's default
  allow_bf16_reduced_precision_reduction) and the 0/1 mask is exact."""
  bk, bn = block
  nk, nn_ = occ.shape
  dt = x.dtype if x.dtype == gy.dtype == out_dtype else torch.float32
  dw = (x.to(dt).T @ gy.to(dt)).view(nk, bk, nn_, bn)
  m = occ.to(dw.device, dt)[:, None, :, None]
  return (dw * m).view(nk * bk, nn_ * bn).to(out_dtype)


class _V3Matmul(torch.autograd.Function):
  """y = x @ (mask * w) from the occupancy; backward: dx with the
  transposed occupancy (W read transposed), dw by `dw_mode`."""

  @staticmethod
  def forward(ctx, x, w, block_mask, block, dw_mode):
    lists = occupancy_lists(block_mask, block, w.shape[1])
    ctx.save_for_backward(x, w, block_mask)
    ctx.block, ctx.dw_mode = block, dw_mode
    return matmul_lists(x, w, lists, block, 'fwd', v3_matmul_cuda)

  @staticmethod
  def backward(ctx, gy):
    x, w, block_mask = ctx.saved_tensors
    block = ctx.block
    gy = gy.contiguous()
    dx = dw = None
    if ctx.needs_input_grad[0]:
      lists = occupancy_lists(block_mask, block, w.shape[1], 'dx')
      dx = matmul_lists(gy, w, lists, block, 'dx', v3_matmul_cuda)
    if ctx.needs_input_grad[1]:
      if dw_mode_for(tuple(w.shape), block, ctx.dw_mode) == 'dense':
        dw = masked_dense_dw(x, gy, block_mask, block, w.dtype)
      else:
        dw = gather_dw(x, gy, w, occupancy_dw_entries(block_mask), block)
    return dx, dw, None, None, None


def block_sparse_matmul_v3(x: torch.Tensor, w: torch.Tensor,
                           block_mask: torch.Tensor,
                           block: Tuple[int, int] = (512, 512),
                           bm: int = 512,
                           interpret: Optional[bool] = None,
                           dw_mode: str = 'auto'):
  """y = x @ (expanded(block_mask) * w), differentiable in x and w.

  x (m, K), w (K, N) dense storage, block_mask (K/bk, N/bn) occupancy.
  dx runs the kernel with the transposed occupancy; dw is 'dense' (the
  product, summed in f32, times the expanded mask), 'gather' (only the
  active blocks, zeros elsewhere) or 'auto' (JAX's traffic model,
  dw_mode_for).  `bm`
  and `interpret` are kept for the JAX signature: the kernel masks ragged
  m and CPU tensors take the plain version."""
  del bm, interpret
  block = tuple(block)
  _check_shapes(x, w, block)
  dw_mode_for(tuple(w.shape), block, dw_mode)   # validates the name
  block_mask = torch.as_tensor(block_mask).to(x.device, torch.int32)
  if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
    return _V3Matmul.apply(x, w, block_mask, block, dw_mode)
  lists = occupancy_lists(block_mask, block, w.shape[1])
  return matmul_lists(x, w, lists, block, 'fwd', v3_matmul_cuda)


def _dw_blocksparse_v2(x: torch.Tensor, g: torch.Tensor,
                       block_mask: torch.Tensor, block: Tuple[int, int],
                       bm: int = 512, out_dtype=None,
                       interpret: Optional[bool] = None):
  """dw = xᵀ @ g restricted to the active blocks of block_mask, zeros
  elsewhere, in `out_dtype` (x's when None).  x (M, K), g (M, N); M need
  not divide `bm`, kept for the JAX signature."""
  del bm, interpret
  out_dtype = out_dtype or x.dtype
  occ = torch.as_tensor(block_mask).to(x.device, torch.int32)
  w_like = torch.empty((x.shape[1], g.shape[1]), dtype=out_dtype,
                       device=x.device)
  return gather_dw(x.contiguous(), g.contiguous(), w_like,
                   occupancy_dw_entries(occ), tuple(block))


# --------------------------------------------------------------- control --
def dense_control_cuda(x: torch.Tensor, w: torch.Tensor, lists: DenseLists,
                       block: Tuple[int, int], mode: str = 'fwd'):
  """dense_mm_cuda counted in dense_control_launches."""
  global dense_control_launches
  y = dense_mm_cuda(x, w, lists, block, mode)
  dense_control_launches += bool(x.shape[0])
  return y


class ForwardOnly(torch.autograd.Function):
  """y = fn(*args) for an entry whose JAX counterpart has no VJP: the
  backward raises, where a plain call would have given no gradient path
  at all."""

  @staticmethod
  def forward(ctx, name, fn, *args):
    ctx.name = name
    return fn(*args)

  @staticmethod
  def backward(ctx, gy):
    raise NotImplementedError(
        f'{ctx.name} is forward only: its JAX counterpart has no VJP')


def forward_only(name, fn, *args):
  """fn(*args), through ForwardOnly when a tensor argument needs a
  gradient."""
  if torch.is_grad_enabled() and any(
      torch.is_tensor(a) and a.requires_grad for a in args):
    return ForwardOnly.apply(name, fn, *args)
  return fn(*args)


@functools.cache
def _all_active_lists(nk: int, nn_: int, block: Tuple[int, int], n: int,
                      device: torch.device) -> DenseLists:
  """The entry lists of an all-active (nk, nn) occupancy, built once per
  shape and device: the control times the kernel, not the lists."""
  occ = torch.ones(nk, nn_, dtype=torch.int32, device=device)
  return occupancy_lists(occ, block, n)


def pallas_dense_matmul(x: torch.Tensor, w: torch.Tensor,
                        tiles: Tuple[int, int, int] = (512, 512, 512),
                        interpret: Optional[bool] = None):
  """y = x @ w, the plain tiled kernel-overhead control (B9'), in x's
  dtype with f32 sums: the mm kernels' dense forward over an
  all-active occupancy of (bk, bn) = tiles[1:] blocks.  Forward only, as
  JAX's.  JAX leaves the output's tail unwritten where a tile does not
  divide its dimension; here that raises ValueError.  `bm` (tiles[0])
  only has to divide m, and `interpret` is kept for the JAX signature."""
  del interpret
  bm, bk, bn = tiles
  _check_shapes(x, w, (bk, bn))
  if x.shape[0] % bm:
    raise ValueError(f'shapes ({x.shape[0]},{w.shape[0]},{w.shape[1]}) must '
                     f'divide tiles {tuple(tiles)}')
  lists = _all_active_lists(w.shape[0] // bk, w.shape[1] // bn, (bk, bn),
                            w.shape[1], x.device)
  return forward_only('pallas_dense_matmul', matmul_lists, x.contiguous(),
                      w.contiguous(), lists, (bk, bn), 'fwd',
                      dense_control_cuda)
