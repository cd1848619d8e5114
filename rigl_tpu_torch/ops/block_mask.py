"""Block-granular masks: pooling scores onto the block grid, broadcasting
a block mask back, block-level drop/grow and the execution descriptors of
block-executable layers, in PyTorch.

Counterpart of rigl_tpu/ops/block_mask.py.  A kernel's 2D matmul view is
(rows = inputs, cols = outputs); a conv kernel (kh, kw, cin, cout)
flattens to (cin*kh*kw, cout), the im2col row order.  Spatial convs whose
channel dims the block divides take the tap layout instead: the block cell
is (1, 1, bk, bn), giving a (kh*kw, cin/bk, cout/bn) occupancy, the layout
the tap conv kernels execute (ops/block_sparse_conv.py).

Random masks draw from torch generators, not from JAX's keys: the tests
carry JAX's masks over instead.  Mask and collection dicts are keyed by
flax paths ('group2_block0/conv1/conv/kernel'); `block_mask_collection`
and `nest_entries` return the nested form, as JAX does, while the port's
models read the flat {path: entry} dict.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def block_shape_for(shape: Tuple[int, ...],
                    block: Tuple[int, int]) -> Tuple[int, int]:
  """Maps an ND kernel shape to its 2D matmul view (rows = inputs,
  cols = outputs): (kh, kw, cin, cout) -> (cin*kh*kw, cout)."""
  del block
  return int(np.prod(shape[:-1])), int(shape[-1])


def _to_2d(x: torch.Tensor) -> torch.Tensor:
  """The canonical 2D matmul view."""
  if x.dim() == 4:
    kh, kw, cin, cout = x.shape
    return x.permute(2, 0, 1, 3).reshape(cin * kh * kw, cout)
  return x.reshape(-1, x.shape[-1])


def _from_2d(v: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
  """Inverse of _to_2d."""
  if len(shape) == 4:
    kh, kw, cin, cout = shape
    return v.reshape(cin, kh, kw, cout).permute(1, 2, 0, 3)
  return v.reshape(shape)


def pool_to_blocks(x: torch.Tensor, block: Tuple[int, int],
                   reduce: str = 'sum') -> torch.Tensor:
  """Sum/max/mean-pools a 2D-viewed tensor into block cells.

  Requires block dims to divide the 2D view (pad upstream if not).
  """
  v2 = _to_2d(x)
  rows, cols = v2.shape
  br, bc = block
  if rows % br or cols % bc:
    raise ValueError(f'block {block} does not divide 2D view ({rows},{cols})')
  v = v2.reshape(rows // br, br, cols // bc, bc)
  if reduce == 'sum':
    return v.sum(dim=(1, 3))
  if reduce == 'max':
    return v.amax(dim=(1, 3))
  if reduce == 'mean':
    return v.mean(dim=(1, 3))
  raise ValueError(reduce)


def expand_from_blocks(block_mask: torch.Tensor, shape: Tuple[int, ...],
                       block: Tuple[int, int]) -> torch.Tensor:
  """Broadcasts a block mask back to the element-granular kernel shape."""
  br, bc = block
  m = block_mask.repeat_interleave(br, dim=0).repeat_interleave(bc, dim=1)
  return _from_2d(m, tuple(shape))


# ------------------------------------------------------------ tap layout --
def is_tap_layer(shape: Tuple[int, ...], block: Tuple[int, int]) -> bool:
  """True if `shape` is a spatial conv kernel divisible into tap blocks."""
  if len(shape) != 4 or tuple(shape[:2]) == (1, 1):
    return False
  br, bc = block
  return shape[2] % br == 0 and shape[3] % bc == 0


def pool_to_tap_blocks(x: torch.Tensor, block: Tuple[int, int],
                       reduce: str = 'sum') -> torch.Tensor:
  """(kh, kw, cin, cout) -> (kh*kw, cin/bk, cout/bn) block cells."""
  kh, kw, cin, cout = x.shape
  br, bc = block
  v = x.reshape(kh * kw, cin // br, br, cout // bc, bc)
  if reduce == 'sum':
    return v.sum(dim=(2, 4))
  if reduce == 'max':
    return v.amax(dim=(2, 4))
  if reduce == 'mean':
    return v.mean(dim=(2, 4))
  raise ValueError(reduce)


def expand_from_tap_blocks(tap_mask: torch.Tensor, shape: Tuple[int, ...],
                           block: Tuple[int, int]) -> torch.Tensor:
  """Broadcasts a (kh*kw, cin/bk, cout/bn) mask back to (kh, kw, cin,
  cout)."""
  br, bc = block
  m = tap_mask.repeat_interleave(br, dim=1).repeat_interleave(bc, dim=2)
  return m.reshape(tuple(shape))


def random_tap_block_mask(generator: Optional[torch.Generator],
                          shape: Tuple[int, ...], sparsity: float,
                          block: Tuple[int, int], dtype=torch.float32,
                          device=None) -> torch.Tensor:
  """Random spatial-conv mask with an exact tap-block-level zero count."""
  from rigl_tpu_torch.sparsity import masks as masks_lib
  kh, kw, cin, cout = shape
  br, bc = block
  bm = masks_lib.random_mask(generator, (kh * kw, cin // br, cout // bc),
                             sparsity, dtype, device)
  return expand_from_tap_blocks(bm, shape, block)


def blockwise_drop_grow(mask, weights, score_drop, score_grow, drop_fraction,
                        block: Tuple[int, int], grow_tensor=None,
                        reinit_when_same: bool = False):
  """Drop/grow at block granularity.

  Scores sum-pool over blocks; the element mask is the broadcast of the
  block decision.  Grown blocks' weights re-initialize from `grow_tensor`
  (zeros by default) and new_connections marks every element of a grown
  block.  Spatial conv kernels pool per tap (is_tap_layer); 2D kernels and
  1x1 convs pool over the 2D matmul view."""
  from rigl_tpu_torch.sparsity import update as update_lib
  shape = tuple(mask.shape)
  if is_tap_layer(shape, block):
    pool, expand = pool_to_tap_blocks, expand_from_tap_blocks
  else:
    pool, expand = pool_to_blocks, expand_from_blocks
  block_mask = pool(mask.to(torch.float32), block, 'max')
  bd = pool(torch.as_tensor(score_drop).to(torch.float32), block, 'sum')
  bg = pool(torch.as_tensor(score_grow).to(torch.float32), block, 'sum')
  res = update_lib.drop_grow_update(
      block_mask, torch.zeros_like(block_mask), bd, bg, drop_fraction,
      grow_tensor=torch.zeros_like(block_mask),
      reinit_when_same=reinit_when_same)
  new_mask = expand(res.mask, shape, block).to(mask.dtype)
  new_conn = expand(res.new_connections.to(torch.float32), shape,
                    block) == 1.0
  if grow_tensor is None:
    grow_tensor = torch.zeros_like(weights)
  new_weights = torch.where(new_conn, grow_tensor.to(weights.dtype), weights)
  return update_lib.DropGrowResult(new_mask, new_weights, new_conn)


def block_executable_layers(masks, block: Tuple[int, int],
                            conv3x3: bool = False):
  """Mask paths whose layers can execute on the block-skipping kernels:
  2D kernels and 1x1 conv kernels whose (rows, cols) view the block
  divides, plus, with `conv3x3`, spatial conv kernels in the tap layout."""
  out = []
  br, bc = block
  for path, m in masks.items():
    shape = tuple(m.shape)
    if len(shape) == 4 and tuple(shape[:2]) != (1, 1):
      if conv3x3 and is_tap_layer(shape, block):
        out.append(path)
      continue
    if len(shape) not in (2, 4):
      continue
    rows, cols = block_shape_for(shape, block)
    if rows % br == 0 and cols % bc == 0:
      out.append(path)
  return out


def block_entry(mask: torch.Tensor, block: Tuple[int, int],
                n_active: Optional[int] = None):
  """One layer's execution descriptor: a tap packing {'cols', 'rows',
  'taps'} for a spatial conv (its active count read off the mask when
  `n_active` is None), a flat packing {'cols', 'rows'} when `n_active`
  pins a matmul layer's count, else the int32 occupancy."""
  shape = tuple(mask.shape)
  if is_tap_layer(shape, block):
    from rigl_tpu_torch.ops.block_sparse_conv import pack_tap_active
    occ = (pool_to_tap_blocks(mask.to(torch.float32), block, 'max')
           > 0).to(torch.int32)
    # On the host: the tap kernels' index (tap_index) is built there.
    occ = occ.cpu()
    n_act = int(occ.sum()) if n_active is None else n_active
    cols, rows, taps = pack_tap_active(occ, n_act)
    return {'cols': cols, 'rows': rows, 'taps': taps}
  occ = (pool_to_blocks(mask.to(torch.float32), block, 'max')
         > 0).to(torch.int32)
  if n_active is not None:
    from rigl_tpu_torch.ops.block_sparse_v4 import (FlatPacking,
                                                    pack_flat_active)
    return FlatPacking(*pack_flat_active(occ, n_active))
  return occ


def block_mask_collection(masks, block: Tuple[int, int], paths=None,
                          conv3x3: bool = False, static_counts=None):
  """The nested 'block_masks' collection of a mask dict: each entry
  (block_entry) at its layer's path.  Entry forms: occupancy -> v3 matmul;
  {'cols', 'rows'} (count pinned by `static_counts`) -> v4 matmul;
  {'cols', 'rows', 'taps'} -> the tap conv kernels."""
  if paths is None:
    paths = block_executable_layers(masks, block, conv3x3=conv3x3)
  static_counts = static_counts or {}
  return nest_entries({p: block_entry(masks[p], block, static_counts.get(p))
                       for p in paths})


def nest_entries(entries):
  """{'a/b/kernel': entry} -> nested {'a': {'b': {'kernel': entry}}}."""
  col: dict = {}
  for path, entry in entries.items():
    node = col
    parts = path.split('/')
    for k in parts[:-1]:
      node = node.setdefault(k, {})
    node[parts[-1]] = entry
  return col


def random_block_mask(generator: Optional[torch.Generator],
                      shape: Tuple[int, ...], sparsity: float,
                      block: Tuple[int, int], dtype=torch.float32,
                      device=None) -> torch.Tensor:
  """Random mask with an exact block-level zero count (tap layout for
  spatial convs, 2D matmul-view layout otherwise)."""
  from rigl_tpu_torch.sparsity import masks as masks_lib
  if is_tap_layer(shape, block):
    return random_tap_block_mask(generator, shape, sparsity, block, dtype,
                                 device)
  rows, cols = block_shape_for(shape, block)
  br, bc = block
  bm = masks_lib.random_mask(generator, (rows // br, cols // bc), sparsity,
                             dtype, device)
  return expand_from_blocks(bm, shape, block)
