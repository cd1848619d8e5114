"""Shared building blocks of the dense-masked model zoo, in PyTorch.

Counterpart of rigl_tpu/models/common.py.  Conventions kept from JAX:
NHWC activations, HWIO conv kernels ((kh, kw, Cin, Cout), the layout the
masks, the block pooling and the packings address), float32 parameters
and BatchNorm statistics with compute in `dtype` (bfloat16 for the
reference's ImageNet runs).  Module names follow the flax paths, so a
parameter's torch name read with '/' for '.' is its flax path
('group2_block0/conv1/conv/kernel').

BatchNorm is flax's, not torch's: momentum 0.9 on the running average
(ra = 0.9 ra + 0.1 batch), epsilon 1e-5, statistics in at least float32
(float32 under a bfloat16 dtype; var = E[x²] - E[x]², clipped at 0: the
BIASED batch variance, also in the running average, where torch's
BatchNorm keeps the unbiased one), and buffers named 'mean' and 'var' as
flax's batch_stats.
`frozen_batch_stats(model)` stops the running averages from moving (the
grow-score recomputation of a RigL update step runs the model a second
time, and JAX discards that pass's statistics).

`_BlockConv` executes a conv through the block-sparse kernels when the
caller hands it an entry (ops/block_mask.py's block_entry forms): an
occupancy runs the v3 matmul, a {'cols', 'rows'} flat packing the v4
matmul (1x1 kernels), a {'cols', 'rows', 'taps'} packing the tap conv
kernels; otherwise a dense conv on torch's channels-last view.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rigl_tpu_torch.layers.packed_conv import conv2d_same
from rigl_tpu_torch.layers.packed_dense import MasterWeight

# Reference BN hyperparameters (imagenet_resnet/resnet_model.py:37-38).
BATCH_NORM_DECAY = 0.9
BATCH_NORM_EPSILON = 1e-5


class BatchNorm(nn.Module):
  """flax nn.BatchNorm(momentum=0.9, epsilon=1e-5) over the last axis."""

  def __init__(self, features: int, dtype: torch.dtype = torch.float32,
               zero_scale: bool = False, device='cuda'):
    super().__init__()
    self.dtype = dtype
    self.update_stats = True
    init = torch.zeros if zero_scale else torch.ones
    self.scale = nn.Parameter(init(features, device=device))
    self.bias = nn.Parameter(torch.zeros(features, device=device))
    self.register_buffer('mean', torch.zeros(features, device=device))
    self.register_buffer('var', torch.ones(features, device=device))

  def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
    axes = tuple(range(x.dim() - 1))
    stat_dtype = torch.promote_types(x.dtype, torch.float32)
    if train:
      xf = x.to(stat_dtype)
      mean = xf.mean(axes)
      var = torch.clamp((xf * xf).mean(axes) - mean * mean, min=0.0)
      if self.update_stats:
        with torch.no_grad():
          self.mean.copy_(BATCH_NORM_DECAY * self.mean
                          + (1.0 - BATCH_NORM_DECAY) * mean)
          self.var.copy_(BATCH_NORM_DECAY * self.var
                         + (1.0 - BATCH_NORM_DECAY) * var)
    else:
      mean, var = self.mean, self.var
    mul = torch.rsqrt(var + BATCH_NORM_EPSILON) * self.scale
    y = (x.to(stat_dtype) - mean) * mul + self.bias
    return y.to(self.dtype)


@contextlib.contextmanager
def frozen_batch_stats(model: nn.Module):
  """Inside the block, BatchNorm layers of `model` normalize as usual but
  leave their running averages as they are."""
  bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
  try:
    for m in bns:
      m.update_stats = False
    yield model
  finally:
    for m in bns:
      m.update_stats = True


def conv_kernel_init(scale: float = 2.0):
  """He / variance-scaling fan_out normal init of an HWIO kernel:
  N(0, scale / (kh * kw * Cout)).  Returns (shape, generator) -> tensor."""
  def init(shape, generator=None):
    kh, kw, _, cout = shape
    gdev = generator.device if generator is not None else None
    return (torch.randn(shape, generator=generator, device=gdev)
            * math.sqrt(scale / (kh * kw * cout)))
  return init


def fixed_padding(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
  """Zero padding independent of input size (conv2d_fixed_padding): total
  kernel_size - 1, the odd pixel at the end; NHWC."""
  pad_total = kernel_size - 1
  pad_beg = pad_total // 2
  pad_end = pad_total - pad_beg
  return F.pad(x, (0, 0, pad_beg, pad_end, pad_beg, pad_end))


def conv_nhwc(x: torch.Tensor, w4d: torch.Tensor, stride: int,
              padding: str, groups: int = 1) -> torch.Tensor:
  """lax.conv_general_dilated(x, w4d, (stride, stride), padding,
  feature_group_count=groups) with NHWC x and an HWIO kernel
  (kh, kw, Cin / groups, Cout), by torch's conv on the channels-last
  view."""
  if padding == 'SAME':
    return conv2d_same(x, w4d, (stride, stride), groups=groups)
  if padding != 'VALID':
    raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
  y = F.conv2d(x.permute(0, 3, 1, 2), w4d.permute(3, 2, 0, 1), stride=stride,
               groups=groups)
  return y.permute(0, 2, 3, 1)


def lecun_normal_init(shape, generator=None):
  """N(0, 1 / fan_in) for a kernel whose last axis is its output
  (flax's lecun_normal scale; flax truncates the normal at 2 sigma, and
  tests carry JAX's values over with convert.py)."""
  fan_in = math.prod(shape[:-1])
  gdev = generator.device if generator is not None else None
  return (torch.randn(tuple(shape), generator=generator, device=gdev)
          / math.sqrt(fan_in))


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
  """jnp.mean(x, axis=(1, 2)) of NHWC x: summed in at least float32,
  returned in x's dtype."""
  return x.to(torch.promote_types(x.dtype, torch.float32)).mean(
      dim=(1, 2)).to(x.dtype)


def max_pool(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
  """flax nn.max_pool(x, (window, window), strides=(stride, stride)) on
  NHWC x, VALID (no padding)."""
  y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride)
  return y.permute(0, 2, 3, 1)


class Dropout(nn.Module):
  """flax nn.Dropout(rate): in train mode, each value kept with probability
  1 - rate and scaled by 1 / (1 - rate), the rest zeroed; identity in eval
  mode.  The keep draws come from `generator`, which must live on the
  activations' device."""

  def __init__(self, rate: float, generator: Optional[torch.Generator]):
    super().__init__()
    self.rate, self.generator = rate, generator

  def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
    if not train or self.rate == 0.0:
      return x
    if self.rate == 1.0:
      return torch.zeros_like(x)
    keep_prob = 1.0 - self.rate
    keep = torch.rand(x.shape, generator=self.generator,
                      device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def dropout_generator(generator: Optional[torch.Generator], device):
  """The generator a model's Dropout draws from: `generator` as given, or
  one seeded 0 on `device`."""
  if generator is not None:
    return generator
  return torch.Generator(device=device).manual_seed(0)


class _BlockConv(MasterWeight, nn.Module):
  """The conv core ('conv' in flax): an HWIO float32 `kernel`, computed in
  `dtype`, executed per call through the block-sparse kernels when an
  entry is given (module docstring), else as a dense conv.  `path` is the
  kernel's mask path, which the model sets."""

  def __init__(self, in_features: int, features: int, kernel_size: int,
               strides: int, padding: str,
               dtype: torch.dtype = torch.float32, use_bias: bool = False,
               kernel_init=None, block: Optional[Tuple[int, int]] = None,
               block_bm: int = 512, block_tap_bm: Optional[int] = None,
               generator: Optional[torch.Generator] = None, device='cuda'):
    super().__init__()
    k = kernel_size
    self.kernel_size, self.strides, self.padding = k, strides, padding
    self.dtype, self.block = dtype, None if block is None else tuple(block)
    self.block_bm, self.block_tap_bm = block_bm, block_tap_bm
    self.path = None
    init = kernel_init or conv_kernel_init()
    self.kernel = nn.Parameter(
        init((k, k, in_features, features), generator).to(device))
    self.bias = (nn.Parameter(torch.zeros(features, device=device))
                 if use_bias else None)

  def forward(self, x: torch.Tensor, entry=None) -> torch.Tensor:
    k, s = self.kernel_size, self.strides
    x = x.to(self.dtype)
    kernel = self.compute_weight()
    is_tap = isinstance(entry, dict) and 'taps' in entry
    if is_tap and k > 1:
      from rigl_tpu_torch.ops.block_sparse_conv import tap_batch_ok
      # Even k: the tap kernels' symmetric k//2 padding is not SAME.
      if not tap_batch_ok(x.shape[0]) or k % 2 == 0:
        entry = None
    if entry is not None and self.block is not None:
      if is_tap:
        from rigl_tpu_torch.ops.block_sparse_conv import (
            block_sparse_conv_tap)
        xx = x[:, ::s, ::s, :] if (k == 1 and s > 1) else x
        y = block_sparse_conv_tap(xx, kernel, entry, block=self.block,
                                  bm=self.block_tap_bm)
        if k > 1 and s > 1:
          # Strided spatial conv on the fixed-padded input: the stride-1
          # SAME conv computed every window centre; keep every s-th one
          # from k // 2 (autograd scatters gy back onto the full grid).
          oh = (x.shape[1] - k) // s + 1
          ow = (x.shape[2] - k) // s + 1
          c = k // 2
          y = y[:, c:c + s * (oh - 1) + 1:s, c:c + s * (ow - 1) + 1:s, :]
      else:
        from rigl_tpu_torch.ops import conv as bs_conv
        y = bs_conv.block_sparse_conv1x1(x, kernel, entry, stride=s,
                                         block=self.block, bm=self.block_bm)
    else:
      y = conv_nhwc(x, kernel, s, self.padding)
    if self.bias is not None:
      y = y + self.bias.to(self.dtype)
    return y


class ConvFixedPad(nn.Module):
  """Conv with the reference's fixed padding for strided convs (VALID on
  the padded input; SAME at stride 1).  Its parameter is 'conv.kernel'
  whether or not `block` is set, as in flax."""

  def __init__(self, in_features: int, features: int, kernel_size: int,
               strides: int = 1, dtype: torch.dtype = torch.float32,
               use_bias: bool = False, kernel_init=None,
               block: Optional[Tuple[int, int]] = None, block_bm: int = 512,
               block_tap_bm: Optional[int] = None,
               generator: Optional[torch.Generator] = None, device='cuda'):
    super().__init__()
    self.kernel_size, self.strides = kernel_size, strides
    self.conv = _BlockConv(
        in_features, features, kernel_size, strides,
        'VALID' if strides > 1 else 'SAME', dtype=dtype, use_bias=use_bias,
        kernel_init=kernel_init, block=block, block_bm=block_bm,
        block_tap_bm=block_tap_bm, generator=generator, device=device)

  def forward(self, x: torch.Tensor, block_masks=None) -> torch.Tensor:
    """`block_masks`: the flat {path: entry} dict of the step, or None."""
    if self.strides > 1:
      x = fixed_padding(x, self.kernel_size)
    entry = None
    if block_masks is not None and self.conv.block is not None:
      entry = block_masks.get(self.conv.path)
    return self.conv(x, entry)


def set_conv_paths(model: nn.Module):
  """Gives every _BlockConv of `model` its kernel's mask path."""
  for name, mod in model.named_modules():
    if isinstance(mod, _BlockConv):
      mod.path = f'{name}.kernel'.replace('.', '/')
  return model
