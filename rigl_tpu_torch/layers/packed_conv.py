"""Packed block-sparse convolutions: 1x1 (matmul engine) and spatial KxK.

Counterpart of rigl_tpu/layers/packed_conv.py.  Activations are NHWC, as
in JAX.

PackedConv1x1: a 1x1 conv is a matmul over the channel dim, so it is a
PackedDense applied to every pixel (after the stride's subsample): its
kernel, gradient and optimizer slots are `(n_active, bk, bn)` packed blocks.

PackedConv: a KxK SAME conv whose kernel IS packed storage over the
(kh*kw*Cin, Cout) 2D view, cin-minor (2D block-row r is tap r // (Cin/bk),
cin-block r % (Cin/bk)), so drop/grow and the optimizer's slots reuse the
packed machinery unchanged.  Engines:
  * 'xla': unpack to a transient dense (kh, kw, Cin, Cout) view and run
    torch's conv with XLA's SAME padding (`conv2d_same`: for stride 2 on an
    even input the pad is (0, 1), where torch's padding=1 would pad (1, 1)).
    The unpack's backward gathers the dense gradient back to packed.
  * 'tap': stride-1, non-1x1 convs run the block-sparse tap conv
    (ops/block_sparse_conv.py), which reads the packed storage directly
    through the tap entries of the 2D Packing (built once per Packing and
    cached on it) and writes dw straight into the packed slots.  JAX instead
    unpacks to a transient kernel and re-packs the tap lists on every call;
    the gradients are the same (the dense gradient gathered at the active
    blocks).  Other convs take 'xla', as in JAX.

Kernels are float32 master weights cast to `dtype` on each call
(layers/packed_dense.MasterWeight).  Flax infers a conv's input channels;
the port's modules take `in_features`.

DenseConvTwin is PackedConv's dense twin: the same conv on a 'd.kernel' of
shape (kh*kw*Cin, Cout), the unpack_dense view that dense_twin_params
produces.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rigl_tpu_torch.layers.packed_dense import (MasterWeight, PackedDense,
                                                random_occupancy)
from rigl_tpu_torch.ops.block_sparse_conv import packed_conv_tap
from rigl_tpu_torch.ops.block_sparse_packed import (Packing, make_packing,
                                                    unpack_dense)
from rigl_tpu_torch.sparsity.distributions import get_n_zeros
from rigl_tpu_torch.sparsity.layer_sparsity import resolve_sparsity


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
  """XLA's SAME padding (low, high) of one spatial dim: the output has
  ceil(size / stride) positions and the odd pixel of padding goes high."""
  out = -(-size // stride)
  total = max((out - 1) * stride + k - size, 0)
  return total // 2, total - total // 2


def conv2d_same(x: torch.Tensor, w4d: torch.Tensor, strides=(1, 1),
                dtype: Optional[torch.dtype] = None,
                groups: int = 1) -> torch.Tensor:
  """lax.conv_general_dilated(x, w4d, strides, 'SAME') with NHWC x and an
  HWIO kernel (kh, kw, Cin/groups, Cout), computed in `dtype` (x's when
  None) by torch's conv on the channels-last view."""
  dtype = dtype or x.dtype
  kh, kw = w4d.shape[:2]
  (pt, pb), (pl, pr) = (same_pads(x.shape[1], kh, strides[0]),
                        same_pads(x.shape[2], kw, strides[1]))
  xc = x.to(dtype).permute(0, 3, 1, 2)
  if (pt, pl) == (pb, pr):
    pad = (pt, pl)
  else:
    xc, pad = F.pad(xc, (pl, pr, pt, pb)), (0, 0)
  y = F.conv2d(xc, w4d.to(dtype).permute(3, 2, 0, 1), stride=tuple(strides),
               padding=pad, groups=groups)
  return y.permute(0, 2, 3, 1)


class PackedConv1x1(PackedDense):
  """y[b, h, w, :] = x[b, h, w, :] @ W (+ b) with W stored packed; `strides`
  subsample the spatial grid first (a 1x1 SAME conv with that stride)."""

  def __init__(self, in_features: int, features: int, *, sparsity=0.8,
               block: Tuple[int, int] = (128, 128), bm: int = 512,
               strides: Tuple[int, int] = (1, 1), use_bias: bool = False,
               dtype: torch.dtype = torch.float32, tp_shards: int = 1,
               path: Sequence[str] = (),
               generator: Optional[torch.Generator] = None, device='cuda'):
    super().__init__(in_features, features, sparsity=sparsity, block=block,
                     bm=bm, use_bias=use_bias, dtype=dtype,
                     tp_shards=tp_shards, path=path, generator=generator,
                     device=device)
    self.strides = tuple(strides)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    sh, sw = self.strides
    if sh != 1 or sw != 1:
      x = x[:, ::sh, ::sw, :]
    return super().forward(x)


class PackedConv(MasterWeight, nn.Module):
  """KxK SAME conv whose kernel is packed block-sparse storage over the
  (kh*kw*Cin, Cout) view (module docstring).  Cin % block[0] == 0 and
  features % block[1] == 0.  `sparsity` is a float or a SparsityMap
  resolved by `path`.  Active weights start at a dense lecun-normal
  kernel's scale, normal / sqrt(kh*kw*Cin)."""

  def __init__(self, in_features: int, features: int,
               kernel_size: Tuple[int, int] = (3, 3), *, sparsity=0.8,
               block: Tuple[int, int] = (16, 16), bm: int = 2048,
               strides: Tuple[int, int] = (1, 1), use_bias: bool = False,
               dtype: torch.dtype = torch.float32, engine: str = 'xla',
               path: Sequence[str] = (),
               generator: Optional[torch.Generator] = None, device='cuda'):
    super().__init__()
    bk, bn = block
    if in_features % bk or features % bn:
      raise ValueError(f'channels ({in_features},{features}) must divide '
                       f'block {block}')
    if engine not in ('xla', 'tap'):
      raise ValueError(f"engine must be 'xla' or 'tap', got {engine!r}")
    kh, kw = kernel_size
    self.in_features, self.features = in_features, features
    self.kernel_size, self.block = (kh, kw), tuple(block)
    self.bm, self.strides = bm, tuple(strides)
    self.dtype, self.engine = dtype, engine
    k2d = kh * kw * in_features
    nk, nn_ = k2d // bk, features // bn
    n_total = nk * nn_
    s = resolve_sparsity(sparsity, tuple(path))
    n_active = n_total - get_n_zeros(n_total, s)
    self.packing = make_packing(
        random_occupancy(generator, nk, nn_, n_active), n_active)
    gdev = generator.device if generator else None
    kernel = torch.randn((n_active, bk, bn), generator=generator, device=gdev)
    self.kernel = nn.Parameter(
        (kernel / math.sqrt(k2d)).to(device=device, dtype=torch.float32))
    self.bias = (nn.Parameter(torch.zeros(features, device=device))
                 if use_bias else None)

  def set_packing(self, packing: Packing):
    """Swap in another occupancy with the same grid and active count."""
    kh, kw = self.kernel_size
    grid = (kh * kw * self.in_features // self.block[0],
            self.features // self.block[1])
    if packing.shape != grid or packing.n_active != self.kernel.shape[0]:
      raise ValueError(f'packing {packing.shape} with {packing.n_active} '
                       f'actives does not fit {grid} with '
                       f'{self.kernel.shape[0]}')
    self.packing = packing

  @property
  def uses_tap(self) -> bool:
    return (self.engine == 'tap' and self.strides == (1, 1)
            and self.kernel_size != (1, 1))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    kh, kw = self.kernel_size
    if self.uses_tap:
      y = packed_conv_tap(x.to(self.dtype), self.compute_weight(),
                          self.packing, (kh, kw), self.block)
    else:
      w2d = unpack_dense(self.kernel, self.packing, self.block,
                         dtype=self.dtype)
      y = conv2d_same(x, w2d.reshape(kh, kw, self.in_features,
                                     self.features), self.strides,
                      self.dtype)
    if self.bias is not None:
      y = y + self.bias.to(self.dtype)
    return y


class _KernelHolder(nn.Module):
  """The dense twin's 'kernel' (K, N), float32 (flax's default)."""

  def __init__(self, k: int, n: int, device='cuda'):
    super().__init__()
    self.kernel = nn.Parameter(torch.zeros((k, n), device=device))


class DenseConvTwin(nn.Module):
  """Dense twin of PackedConv: the same conv on a (kh*kw*Cin, Cout)
  'd.kernel', so packed '<layer>.kernel' maps to '<layer>.d.kernel'."""

  def __init__(self, in_features: int, features: int,
               kernel_size: Tuple[int, int] = (3, 3),
               strides: Tuple[int, int] = (1, 1),
               dtype: torch.dtype = torch.float32, device='cuda'):
    super().__init__()
    kh, kw = kernel_size
    self.in_features, self.features = in_features, features
    self.kernel_size, self.strides, self.dtype = (kh, kw), tuple(strides), dtype
    self.d = _KernelHolder(kh * kw * in_features, features, device)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    kh, kw = self.kernel_size
    w4d = self.d.kernel.reshape(kh, kw, self.in_features, self.features)
    return conv2d_same(x, w4d, self.strides, self.dtype)
