"""Conv nets on PACKED block-sparse storage, in PyTorch.

Counterpart of rigl_tpu/models/packed_convnet.py, every family with its
dense twin:
  * PackedConvNet / DenseConvNet: dense depthwise 3x3 + packed pointwise
    stages (the reference's MobileNet-v1 sparsity structure);
  * PackedMobileNetV1 / DenseMobileNetV1Twin: the full MobileNet-v1
    schedule at a width multiplier (make_divisible, mbv1_config);
  * PackedWideResNet / DenseWideResNetTwin: WRN-(6n+4, k), every 3x3 conv a
    PackedConv ('xla' or 'tap' engine);
  * PackedBottleneckGroup / DenseBottleneckGroupTwin: RN50-style
    bottlenecks with every conv packed;
  * PackedResNet / DenseResNetTwin: bottleneck ResNet-50/101/152/200.
Stems, depthwise convs, projections, norms and heads stay dense, as in JAX;
GroupNorm (epsilon 1e-6, min(8, C) groups) replaces BatchNorm, so the
models are stateless.  The *_layer_shapes helpers give the ERK solver's
input, as in JAX.

Activations are NHWC and every module path is its flax path, so a
parameter's name is the flax path joined with dots ('g0_b0.conv1.kernel')
and spec_for_model maps resolve per layer.  Dense parameters keep flax's
layouts: conv kernels HWIO (a depthwise kernel (3, 3, 1, C)), Dense kernels
(in, out), so convert.py carries JAX variables over by their paths alone;
the convs permute to torch's OIHW on each call.  Flax infers input
channels; the port's models take `in_channels`.  Initial values come from
`generator` (lecun-normal scale, not flax's draws): tests carry JAX's
variables over with convert.py.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rigl_tpu_torch.layers.packed_conv import (DenseConvTwin, PackedConv,
                                               PackedConv1x1, conv2d_same,
                                               same_pads)
from rigl_tpu_torch.layers.packed_dense import MasterWeight, PackedDense


# ------------------------------------------------------ dense flax layers --
def _normal(shape, fan_in, generator, device, dtype=torch.float32):
  gdev = generator.device if generator else None
  w = torch.randn(shape, generator=generator, device=gdev) / math.sqrt(fan_in)
  return nn.Parameter(w.to(device=device, dtype=dtype))


class Conv(MasterWeight, nn.Module):
  """flax nn.Conv(features, kernel_size, strides, padding,
  feature_group_count=groups, use_bias): an HWIO float32 kernel
  (kh, kw, Cin/groups, features), from `kernel_init(shape, generator)`
  if given, and with `use_bias` a zero-initialised bias; 'SAME' (XLA's
  padding) or 'VALID', computed in `dtype`."""

  def __init__(self, in_features: int, features: int,
               kernel_size: Tuple[int, int], strides=(1, 1), groups: int = 1,
               dtype: torch.dtype = torch.float32, padding: str = 'SAME',
               use_bias: bool = False, kernel_init=None,
               generator: Optional[torch.Generator] = None, device='cuda'):
    super().__init__()
    if padding not in ('SAME', 'VALID'):
      raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    kh, kw = kernel_size
    self.strides, self.groups, self.dtype = tuple(strides), groups, dtype
    self.padding = padding
    shape = (kh, kw, in_features // groups, features)
    if kernel_init is None:
      self.kernel = _normal(shape, kh * kw * in_features // groups,
                            generator, device)
    else:
      self.kernel = nn.Parameter(kernel_init(shape, generator).to(device))
    self.bias = (nn.Parameter(torch.zeros(features, device=device))
                 if use_bias else None)

  def forward(self, x):
    w = self.compute_weight()
    if self.padding == 'SAME':
      y = conv2d_same(x, w, self.strides, self.dtype, self.groups)
    else:
      y = F.conv2d(x.to(self.dtype).permute(0, 3, 1, 2),
                   w.permute(3, 2, 0, 1), stride=self.strides,
                   groups=self.groups).permute(0, 2, 3, 1)
    return y if self.bias is None else y + self.bias.to(self.dtype)


class Dense(MasterWeight, nn.Module):
  """flax nn.Dense: x @ kernel (+ bias), kernel (in, out) stored in
  `param_dtype`, computed in `dtype`."""

  def __init__(self, in_features: int, features: int,
               dtype: torch.dtype = torch.float32, use_bias: bool = True,
               param_dtype: torch.dtype = torch.float32,
               generator: Optional[torch.Generator] = None, device='cuda'):
    super().__init__()
    self.dtype = dtype
    self.kernel = _normal((in_features, features), in_features, generator,
                          device, param_dtype)
    self.bias = (nn.Parameter(torch.zeros(features, device=device,
                                          dtype=param_dtype))
                 if use_bias else None)

  def forward(self, x):
    y = x.to(self.dtype) @ self.compute_weight()
    return y if self.bias is None else y + self.bias.to(self.dtype)


class GroupNorm(nn.Module):
  """flax nn.GroupNorm over NHWC: f32 statistics over (H, W, C/groups) with
  Var = E[x^2] - E[x]^2, epsilon 1e-6, f32 scale and bias, result in
  `dtype`."""

  def __init__(self, features: int, num_groups: int,
               dtype: torch.dtype = torch.float32, eps: float = 1e-6,
               device='cuda'):
    super().__init__()
    self.num_groups, self.dtype, self.eps = num_groups, dtype, eps
    self.scale = nn.Parameter(torch.ones(features, device=device))
    self.bias = nn.Parameter(torch.zeros(features, device=device))

  def forward(self, x):
    n, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(n, -1, self.num_groups, c // self.num_groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = ((xf * xf).mean(dim=(1, 3), keepdim=True) - mean * mean).clamp(min=0)
    groups = (self.num_groups, c // self.num_groups)
    mul = torch.rsqrt(var + self.eps) * self.scale.reshape(groups)
    y = (xf - mean) * mul + self.bias.reshape(groups)
    return y.reshape(x.shape).to(self.dtype)


def _gn(features: int, dtype, device, groups: Optional[int] = None):
  return GroupNorm(features, groups or min(8, features), dtype, device=device)


def _pool(x):
  """Global average pool over (H, W)."""
  return x.mean(dim=(1, 2))


def _max_pool_same(x, k: int = 3, s: int = 2):
  """flax nn.max_pool(x, (k, k), (s, s), padding='SAME'): pads with -inf."""
  (pt, pb), (pl, pr) = same_pads(x.shape[1], k, s), same_pads(x.shape[2], k, s)
  xc = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb), value=float('-inf'))
  return F.max_pool2d(xc, k, s).permute(0, 2, 3, 1)


class _DensePointwise(nn.Module):
  """Dense twin of PackedConv1x1: strided subsample + matmul, the (cin,
  cout) kernel at child 'd' stored in `dtype`."""

  def __init__(self, in_features, features, strides=(1, 1),
               dtype=torch.float32, generator=None, device='cuda'):
    super().__init__()
    self.strides = tuple(strides)
    self.d = Dense(in_features, features, dtype, use_bias=False,
                   param_dtype=dtype, generator=generator, device=device)

  def forward(self, x):
    sh, sw = self.strides
    if sh != 1 or sw != 1:
      x = x[:, ::sh, ::sw, :]
    return self.d(x)


# ----------------------------------------------------------- ConvNet ------
class _Stage(nn.Module):
  """MobileNet-v1 block: dense depthwise 3x3 + GN/relu + pointwise (stride
  in its subsample) + GN/relu."""

  def __init__(self, cin, features, strides, make_pointwise, path, dtype,
               generator, device):
    super().__init__()
    self.dw = Conv(cin, cin, (3, 3), groups=cin, dtype=dtype,
                   generator=generator, device=device)
    self.gn1 = _gn(cin, dtype, device)
    self.pw = make_pointwise(cin, features, strides, path + ('pw',))
    self.gn2 = _gn(features, dtype, device)

  def forward(self, x):
    x = torch.relu(self.gn1(self.dw(x)))
    return torch.relu(self.gn2(self.pw(x)))


class _Backbone(nn.Module):
  """Stem conv -> GN/relu -> stages -> global pool -> head, shared by the
  ConvNet and MobileNet-v1 families.  `pointwise(cin, features, strides,
  path)` builds each stage's pointwise conv."""

  def _build(self, in_channels, stem_width, stem_strides, stages, pointwise,
             num_classes, dtype, generator, device):
    self.dtype = dtype
    self.stem = Conv(in_channels, stem_width, (3, 3), stem_strides, dtype=dtype,
                     generator=generator, device=device)
    self.gn_stem = _gn(stem_width, dtype, device)
    cin = stem_width
    self.n_stages = len(stages)
    for i, (features, stride) in enumerate(stages):
      self.add_module(f'stage{i}', _Stage(
          cin, features, (stride, stride), pointwise, (f'stage{i}',), dtype,
          generator, device))
      cin = features
    self.head = Dense(cin, num_classes, dtype, generator=generator,
                      device=device)

  def forward(self, x):
    x = torch.relu(self.gn_stem(self.stem(x)))
    for i in range(self.n_stages):
      x = getattr(self, f'stage{i}')(x)
    return self.head(_pool(x))


def convnet_layer_shapes(stem_width: int,
                         stages: Sequence[Tuple[int, int]]):
  """{path: (1, 1, cin, cout)} for every packed pointwise conv of a
  PackedConvNet (the ERK solver's input)."""
  shapes = {}
  cin = stem_width
  for i, (features, _) in enumerate(stages):
    shapes[f'stage{i}/pw/kernel'] = (1, 1, cin, features)
    cin = features
  return shapes


class PackedConvNet(_Backbone):
  """Depthwise-separable classifier whose pointwise convs are packed
  block-sparse.  `stages`: (features, stride) per block; `sparsity`: float
  or SparsityMap over convnet_layer_shapes paths."""

  def __init__(self, num_classes: int = 10, stem_width: int = 32,
               stages: Sequence[Tuple[int, int]] = ((64, 2), (128, 2),
                                                    (128, 1)),
               sparsity=0.8, block: Tuple[int, int] = (16, 16), bm: int = 128,
               dtype: torch.dtype = torch.float32, tp_shards: int = 1,
               in_channels: int = 3,
               generator: Optional[torch.Generator] = None, device='cuda'):
    super().__init__()

    def pointwise(cin, features, strides, path):
      return PackedConv1x1(cin, features, sparsity=sparsity, block=block,
                           bm=bm, strides=strides, dtype=dtype,
                           tp_shards=tp_shards, path=path,
                           generator=generator, device=device)

    self._build(in_channels, stem_width, (1, 1), stages, pointwise,
                num_classes, dtype, generator, device)


class DenseConvNet(_Backbone):
  """Equal-architecture dense twin of PackedConvNet."""

  def __init__(self, num_classes: int = 10, stem_width: int = 32,
               stages: Sequence[Tuple[int, int]] = ((64, 2), (128, 2),
                                                    (128, 1)),
               dtype: torch.dtype = torch.float32, in_channels: int = 3,
               generator: Optional[torch.Generator] = None, device='cuda'):
    super().__init__()

    def pointwise(cin, features, strides, path):
      del path
      return _DensePointwise(cin, features, strides, dtype, generator, device)

    self._build(in_channels, stem_width, (1, 1), stages, pointwise,
                num_classes, dtype, generator, device)


# --------------------------------------------------------------- MBv1 -----
MBV1_BLOCK_SCHEDULE = ((64, 1), (128, 2), (128, 1), (256, 2), (256, 1),
                       (512, 2), (512, 1), (512, 1), (512, 1), (512, 1),
                       (512, 1), (1024, 2), (1024, 1))


def make_divisible(v, divisor: int = 8, min_value=None) -> int:
  """The published MobileNet channel rounding (nearest multiple of
  `divisor`, never below min_value, never down by more than 10%)."""
  if min_value is None:
    min_value = divisor
  new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
  if new_v < 0.9 * v:
    new_v += divisor
  return new_v


def mbv1_config(width_mult: float = 1.0):
  """(stem_width, stages) of MobileNet-v1 at a width multiplier."""
  stem = make_divisible(32 * width_mult)
  stages = tuple((make_divisible(int(f * width_mult)), s)
                 for f, s in MBV1_BLOCK_SCHEDULE)
  return stem, stages


def _eligible(cin: int, features: int, block: Tuple[int, int]) -> bool:
  return cin % block[0] == 0 and features % block[1] == 0


def mbv1_layer_shapes(width_mult: float = 1.0,
                      block: Tuple[int, int] = (16, 16)):
  """{path: (1, 1, cin, cout)} for every PACKED pointwise conv of a
  PackedMobileNetV1 (the model's block-eligibility rule)."""
  stem, stages = mbv1_config(width_mult)
  shapes = {}
  cin = stem
  for i, (features, _) in enumerate(stages):
    if _eligible(cin, features, block):
      shapes[f'stage{i}/pw/kernel'] = (1, 1, cin, features)
    cin = features
  return shapes


def _mbv1_build(net, width_mult, block, eligible_pw, in_channels,
                num_classes, dtype, generator, device):
  """One MBv1 stage walk for the packed model and its twin: a block-
  eligible pointwise conv is `eligible_pw`'s, another a dense 1x1 Conv."""
  stem, stages = mbv1_config(width_mult)

  def pointwise(cin, features, strides, path):
    if _eligible(cin, features, block):
      return eligible_pw(cin, features, strides, path)
    return Conv(cin, features, (1, 1), strides, dtype=dtype,
                generator=generator, device=device)

  net._build(in_channels, stem, (2, 2), stages, pointwise, num_classes,
             dtype, generator, device)


class PackedMobileNetV1(_Backbone):
  """MobileNet-v1 with every block-eligible pointwise conv packed;
  `sparsity`: float or SparsityMap over mbv1_layer_shapes paths."""

  def __init__(self, num_classes: int = 1000, width_mult: float = 1.0,
               sparsity=0.8, block: Tuple[int, int] = (16, 16), bm: int = 128,
               dtype: torch.dtype = torch.float32, in_channels: int = 3,
               generator: Optional[torch.Generator] = None, device='cuda'):
    super().__init__()

    def packed_pw(cin, features, strides, path):
      return PackedConv1x1(cin, features, sparsity=sparsity, block=block,
                           bm=bm, strides=strides, dtype=dtype, path=path,
                           generator=generator, device=device)

    _mbv1_build(self, width_mult, block, packed_pw, in_channels, num_classes,
                dtype, generator, device)


class DenseMobileNetV1Twin(_Backbone):
  """Equal-architecture dense twin of PackedMobileNetV1."""

  def __init__(self, num_classes: int = 1000, width_mult: float = 1.0,
               block: Tuple[int, int] = (16, 16),
               dtype: torch.dtype = torch.float32, in_channels: int = 3,
               generator: Optional[torch.Generator] = None, device='cuda'):
    super().__init__()

    def twin_pw(cin, features, strides, path):
      del path
      return _DensePointwise(cin, features, strides, dtype, generator, device)

    _mbv1_build(self, width_mult, block, twin_pw, in_channels, num_classes,
                dtype, generator, device)


# ---------------------------------------------------------------- WRN -----
def wrn_layer_shapes(depth: int, width: int):
  """{path: (3, 3, cin, cout)} for every packed 3x3 conv of a
  PackedWideResNet."""
  if (depth - 4) % 6:
    raise ValueError(f'WRN depth must be 6n+4, got {depth}')
  n = (depth - 4) // 6
  shapes = {}
  cin = 16
  for g, feats in enumerate((16 * width, 32 * width, 64 * width)):
    for b in range(n):
      shapes[f'g{g}_b{b}/conv1/kernel'] = (3, 3, cin, feats)
      shapes[f'g{g}_b{b}/conv2/kernel'] = (3, 3, feats, feats)
      cin = feats
  return shapes


class _WRNBlock(nn.Module):
  """Pre-activation basic block: GN-relu-conv3x3(s)-GN-relu-conv3x3 +
  (projection on the pre-activated input) shortcut."""

  def __init__(self, cin, features, strides, make_conv, path, dtype,
               generator, device):
    super().__init__()
    self.gn1 = _gn(cin, dtype, device)
    if cin != features or tuple(strides) != (1, 1):
      self.proj = Conv(cin, features, (1, 1), strides, dtype=dtype,
                       generator=generator, device=device)
    else:
      self.proj = None
    self.conv1 = make_conv(cin, features, strides, path + ('conv1',))
    self.gn2 = _gn(features, dtype, device)
    self.conv2 = make_conv(features, features, (1, 1), path + ('conv2',))

  def forward(self, x):
    h = torch.relu(self.gn1(x))
    if self.proj is not None:
      x = self.proj(h)
    h = torch.relu(self.gn2(self.conv1(h)))
    return x + self.conv2(h)


class _WRN(nn.Module):
  """stem -> 3 groups of (depth-4)/6 blocks -> GN/relu -> pool -> head."""

  def _build(self, depth, width, make_conv, num_classes, dtype, in_channels,
             generator, device):
    n = (depth - 4) // 6
    if (depth - 4) % 6:
      raise ValueError(f'WRN depth must be 6n+4, got {depth}')
    self.dtype = dtype
    self.stem = Conv(in_channels, 16, (3, 3), dtype=dtype,
                     generator=generator, device=device)
    self.block_names = []
    cin = 16
    for g, feats in enumerate((16 * width, 32 * width, 64 * width)):
      for b in range(n):
        name = f'g{g}_b{b}'
        strides = (2, 2) if (g > 0 and b == 0) else (1, 1)
        self.add_module(name, _WRNBlock(cin, feats, strides, make_conv,
                                        (name,), dtype, generator, device))
        self.block_names.append(name)
        cin = feats
    self.gn_f = _gn(cin, dtype, device, groups=8)
    self.head = Dense(cin, num_classes, dtype, generator=generator,
                      device=device)

  def forward(self, x):
    x = self.stem(x)
    for name in self.block_names:
      x = getattr(self, name)(x)
    return self.head(_pool(torch.relu(self.gn_f(x))))


class PackedWideResNet(_WRN):
  """WRN-(6n+4, k) with packed 3x3 convs (PackedConv; engine 'xla' by
  default, 'tap' for the block-sparse tap kernels on stride-1 convs).
  `sparsity`: float or SparsityMap over wrn_layer_shapes paths."""

  def __init__(self, depth: int = 22, width: int = 2, num_classes: int = 10,
               sparsity=0.8, block: Tuple[int, int] = (16, 16),
               dtype: torch.dtype = torch.float32, engine: str = 'xla',
               in_channels: int = 3,
               generator: Optional[torch.Generator] = None, device='cuda'):
    super().__init__()

    def conv(cin, features, strides, path):
      return PackedConv(cin, features, (3, 3), sparsity=sparsity, block=block,
                        strides=strides, dtype=dtype, engine=engine,
                        path=path, generator=generator, device=device)

    self._build(depth, width, conv, num_classes, dtype, in_channels,
                generator, device)


class DenseWideResNetTwin(_WRN):
  """Equal-architecture dense twin: each 3x3 conv a DenseConvTwin, so
  packed '<layer>.kernel' maps to '<layer>.d.kernel'."""

  def __init__(self, depth: int = 22, width: int = 2, num_classes: int = 10,
               dtype: torch.dtype = torch.float32, in_channels: int = 3,
               generator: Optional[torch.Generator] = None, device='cuda'):
    super().__init__()

    def conv(cin, features, strides, path):
      del path
      return DenseConvTwin(cin, features, (3, 3), strides, dtype, device)

    self._build(depth, width, conv, num_classes, dtype, in_channels,
                generator, device)


# ------------------------------------------------------- bottlenecks ------
RESNET_BOTTLENECK_DEPTHS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3),
                            152: (3, 8, 36, 3), 200: (3, 24, 36, 3)}


def resnet_layer_shapes(depth: int, width_mult: float = 1.0,
                        block: Tuple[int, int] = (16, 16)):
  """{path: 4D conv shape} for every PACKED conv of a PackedResNet (the
  model's block-eligibility rule)."""
  shapes = {}
  cin = 64
  for g, (blocks, width) in enumerate(
      zip(RESNET_BOTTLENECK_DEPTHS[depth], (64, 128, 256, 512))):
    feats = int(width * width_mult)
    cout = 4 * feats
    for b in range(blocks):
      if _eligible(cin, feats, block):
        shapes[f'g{g}_b{b}/reduce/kernel'] = (1, 1, cin, feats)
      if _eligible(feats, feats, block):
        shapes[f'g{g}_b{b}/conv3x3/kernel'] = (3, 3, feats, feats)
      if _eligible(feats, cout, block):
        shapes[f'g{g}_b{b}/expand/kernel'] = (1, 1, feats, cout)
      cin = cout
  return shapes


class _Bottleneck(nn.Module):
  """Pre-act bottleneck from conv factories, so each packed net and its
  twin share one block: conv1x1(cin, features, path) and conv3x3(cin,
  features, strides, path); stride on the 3x3 and the projection."""

  def __init__(self, cin, features, strides, conv1x1, conv3x3, path, dtype,
               generator, device):
    super().__init__()
    cout = 4 * features
    self.gn0 = _gn(cin, dtype, device)
    if cin != cout or tuple(strides) != (1, 1):
      self.proj = Conv(cin, cout, (1, 1), strides, dtype=dtype,
                       generator=generator, device=device)
    else:
      self.proj = None
    self.reduce = conv1x1(cin, features, path + ('reduce',))
    self.gn1 = _gn(features, dtype, device)
    self.conv3x3 = conv3x3(features, features, strides, path + ('conv3x3',))
    self.gn2 = _gn(features, dtype, device)
    self.expand = conv1x1(features, cout, path + ('expand',))

  def forward(self, x):
    h = torch.relu(self.gn0(x))
    if self.proj is not None:
      x = self.proj(h)
    h = torch.relu(self.gn1(self.reduce(h)))
    h = torch.relu(self.gn2(self.conv3x3(h)))
    return x + self.expand(h)


class _BottleneckNet(nn.Module):
  """stem [-> GN/relu -> max pool] -> named bottlenecks -> GN/relu ->
  pool -> head."""

  def _build(self, stem, blocks, cout, num_classes, dtype, generator, device,
             stem_gn=False):
    self.dtype = dtype
    self.stem = stem
    self.gn_stem = _gn(stem.kernel.shape[-1], dtype, device, 8) if stem_gn \
        else None
    self.block_names = []
    for name, block in blocks:
      self.add_module(name, block)
      self.block_names.append(name)
    self.gn_f = _gn(cout, dtype, device, groups=8)
    self.head = Dense(cout, num_classes, dtype, generator=generator,
                      device=device)

  def forward(self, x):
    x = self.stem(x)
    if self.gn_stem is not None:
      x = _max_pool_same(torch.relu(self.gn_stem(x)))
    for name in self.block_names:
      x = getattr(self, name)(x)
    return self.head(_pool(torch.relu(self.gn_f(x))))


def _group_blocks(stem_width, features, n_blocks, strides, conv1x1, conv3x3,
                  dtype, generator, device):
  cin, out = stem_width, []
  for b in range(n_blocks):
    out.append((f'b{b}', _Bottleneck(
        cin, features, strides if b == 0 else (1, 1), conv1x1, conv3x3,
        (f'b{b}',), dtype, generator, device)))
    cin = 4 * features
  return out


class PackedBottleneckGroup(_BottleneckNet):
  """Classifier of `blocks` RN50-style bottlenecks, all convs packed
  (stem, projections and head dense)."""

  def __init__(self, num_classes: int = 10, features: int = 64,
               blocks: int = 3, strides: Tuple[int, int] = (1, 1),
               sparsity=0.8, block: Tuple[int, int] = (16, 16), bm: int = 128,
               dtype: torch.dtype = torch.float32, engine: str = 'xla',
               in_channels: int = 3,
               generator: Optional[torch.Generator] = None, device='cuda'):
    super().__init__()

    def conv1x1(cin, f, path):
      return PackedConv1x1(cin, f, sparsity=sparsity, block=block, bm=bm,
                           dtype=dtype, path=path, generator=generator,
                           device=device)

    def conv3x3(cin, f, s, path):
      return PackedConv(cin, f, (3, 3), sparsity=sparsity, block=block,
                        strides=s, dtype=dtype, engine=engine, path=path,
                        generator=generator, device=device)

    stem = Conv(in_channels, block[0], (3, 3), dtype=dtype,
                generator=generator, device=device)
    self._build(stem, _group_blocks(block[0], features, blocks, strides,
                                    conv1x1, conv3x3, dtype, generator,
                                    device),
                4 * features, num_classes, dtype, generator, device)


class DenseBottleneckGroupTwin(_BottleneckNet):
  """Equal-architecture dense twin of PackedBottleneckGroup."""

  def __init__(self, num_classes: int = 10, features: int = 64,
               blocks: int = 3, strides: Tuple[int, int] = (1, 1),
               block: Tuple[int, int] = (16, 16),
               dtype: torch.dtype = torch.float32, in_channels: int = 3,
               generator: Optional[torch.Generator] = None, device='cuda'):
    super().__init__()

    def conv1x1(cin, f, path):
      del path
      return _DensePointwise(cin, f, dtype=dtype, generator=generator,
                             device=device)

    def conv3x3(cin, f, s, path):
      del path
      return DenseConvTwin(cin, f, (3, 3), s, dtype, device)

    stem = Conv(in_channels, block[0], (3, 3), dtype=dtype,
                generator=generator, device=device)
    self._build(stem, _group_blocks(block[0], features, blocks, strides,
                                    conv1x1, conv3x3, dtype, generator,
                                    device),
                4 * features, num_classes, dtype, generator, device)


def _resnet(net, depth, width_mult, block, conv1x1, conv3x3, num_classes,
            dtype, in_channels, generator, device):
  """The bottleneck-ResNet walk of the packed net and its twin: a conv is
  the factory's when its channels divide the block, a dense Conv if not."""
  if depth not in RESNET_BOTTLENECK_DEPTHS:
    raise ValueError(f'depth must be one of '
                     f'{sorted(RESNET_BOTTLENECK_DEPTHS)}, got {depth}')

  def c1(cin, f, path):
    if _eligible(cin, f, block):
      return conv1x1(cin, f, path)
    return Conv(cin, f, (1, 1), dtype=dtype, generator=generator,
                device=device)

  def c3(cin, f, s, path):
    if _eligible(cin, f, block):
      return conv3x3(cin, f, s, path)
    return Conv(cin, f, (3, 3), s, dtype=dtype, generator=generator,
                device=device)

  blocks, cin = [], 64
  for g, (n_blocks, width) in enumerate(
      zip(RESNET_BOTTLENECK_DEPTHS[depth], (64, 128, 256, 512))):
    feats = int(width * width_mult)
    for b in range(n_blocks):
      name = f'g{g}_b{b}'
      strides = (2, 2) if (g > 0 and b == 0) else (1, 1)
      blocks.append((name, _Bottleneck(cin, feats, strides, c1, c3, (name,),
                                       dtype, generator, device)))
      cin = 4 * feats
  stem = Conv(in_channels, 64, (7, 7), (2, 2), dtype=dtype,
              generator=generator, device=device)
  net._build(stem, blocks, cin, num_classes, dtype, generator, device,
             stem_gn=True)


class PackedResNet(_BottleneckNet):
  """Bottleneck ResNet-50/101/152/200 with packed block-sparse convs;
  `sparsity`: float or SparsityMap over resnet_layer_shapes paths."""

  def __init__(self, depth: int = 50, num_classes: int = 1000,
               width_mult: float = 1.0, sparsity=0.8,
               block: Tuple[int, int] = (16, 16), bm: int = 128,
               dtype: torch.dtype = torch.float32, engine: str = 'xla',
               in_channels: int = 3,
               generator: Optional[torch.Generator] = None, device='cuda'):
    super().__init__()

    def conv1x1(cin, f, path):
      return PackedConv1x1(cin, f, sparsity=sparsity, block=block, bm=bm,
                           dtype=dtype, path=path, generator=generator,
                           device=device)

    def conv3x3(cin, f, s, path):
      return PackedConv(cin, f, (3, 3), sparsity=sparsity, block=block,
                        strides=s, dtype=dtype, engine=engine, path=path,
                        generator=generator, device=device)

    _resnet(self, depth, width_mult, block, conv1x1, conv3x3, num_classes,
            dtype, in_channels, generator, device)


class DenseResNetTwin(_BottleneckNet):
  """Equal-architecture dense twin of PackedResNet."""

  def __init__(self, depth: int = 50, num_classes: int = 1000,
               width_mult: float = 1.0, block: Tuple[int, int] = (16, 16),
               dtype: torch.dtype = torch.float32, in_channels: int = 3,
               generator: Optional[torch.Generator] = None, device='cuda'):
    super().__init__()

    def conv1x1(cin, f, path):
      del path
      return _DensePointwise(cin, f, dtype=dtype, generator=generator,
                             device=device)

    def conv3x3(cin, f, s, path):
      del path
      return DenseConvTwin(cin, f, (3, 3), s, dtype, device)

    _resnet(self, depth, width_mult, block, conv1x1, conv3x3, num_classes,
            dtype, in_channels, generator, device)


def packed_layers(model: nn.Module):
  """{dotted name of a packed kernel: its layer} for every packed layer
  (PackedDense, PackedConv1x1, PackedConv) of `model`."""
  return {f'{name}.kernel': mod for name, mod in model.named_modules()
          if isinstance(mod, (PackedConv, PackedDense))}
