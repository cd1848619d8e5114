"""MobileNet v1 / v2 over dense-masked weights, in PyTorch.

Counterpart of rigl_tpu/models/mobilenet.py.  The reference's convention
is kept: 3x3 depthwise kernels are never pruned, only the 1x1 pointwise /
expansion / projection convs and the classifier carry masks, and
`dense_layer_paths()` lists the depthwise kernels for a mask rule to
exclude.  The depthwise conv is grouped (one group a channel, kernel
(3, 3, 1, C)); at stride 2 it runs VALID on the fixed-padded input, at
stride 1 SAME (the odd pixel of padding high, as XLA pads).  Parameter
paths are JAX's ('block3_pointwise/kernel', 'block5/expand/kernel').
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rigl_tpu_torch.models import common
from rigl_tpu_torch.models.packed_convnet import Conv, Dense

# MobileNet-v1 blocks: (pointwise features, stride) after the stem.
_V1_BLOCKS: Sequence[Tuple[int, int]] = (
    (64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
    (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2), (1024, 1),
)

# MobileNet-v2 inverted residuals: (expansion t, channels c, repeats n,
# stride s).
_V2_BLOCKS: Sequence[Tuple[int, int, int, int]] = (
    (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
    (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
)


class _Depthwise(Conv):
  """flax's depthwise 3x3: fixed padding then VALID at stride 2, SAME at
  stride 1; no bias."""

  def __init__(self, features, stride, dtype, generator, device):
    super().__init__(
        features, features, (3, 3), (stride, stride), groups=features,
        dtype=dtype, padding='VALID' if stride > 1 else 'SAME',
        kernel_init=common.conv_kernel_init(), generator=generator,
        device=device)

  def forward(self, x):
    if self.strides[0] > 1:
      x = common.fixed_padding(x, 3)
    return super().forward(x)


def _pointwise(cin, features, dtype, generator, device):
  return Conv(cin, features, (1, 1), dtype=dtype,
              kernel_init=common.conv_kernel_init(), generator=generator,
              device=device)


class MobileNetV1(nn.Module):

  def __init__(self, width: float = 1.0, num_classes: int = 1000,
               dtype: torch.dtype = torch.float32, in_channels: int = 3,
               generator: Optional[torch.Generator] = None, device='cuda'):
    super().__init__()
    w, self.dtype = width, dtype
    cin = int(32 * w)
    self.initial_conv = common.ConvFixedPad(in_channels, cin, 3, 2,
                                            dtype=dtype, generator=generator,
                                            device=device)
    self.initial_bn = common.BatchNorm(cin, dtype, device=device)
    for i, (feats, stride) in enumerate(_V1_BLOCKS):
      feats = int(feats * w)
      self.add_module(f'block{i}_depthwise', _Depthwise(cin, stride, dtype,
                                                        generator, device))
      self.add_module(f'block{i}_dw_bn', common.BatchNorm(cin, dtype,
                                                          device=device))
      self.add_module(f'block{i}_pointwise', _pointwise(cin, feats, dtype,
                                                        generator, device))
      self.add_module(f'block{i}_pw_bn', common.BatchNorm(feats, dtype,
                                                          device=device))
      cin = feats
    self.conv_preds = Dense(cin, num_classes, dtype, generator=generator,
                            device=device)
    common.set_conv_paths(self)

  def forward(self, x: torch.Tensor, train: bool = False,
              block_masks=None) -> torch.Tensor:
    x = self.initial_conv(x.to(self.dtype), block_masks)
    x = F.relu6(self.initial_bn(x, train))
    for i in range(len(_V1_BLOCKS)):
      x = getattr(self, f'block{i}_depthwise')(x)
      x = F.relu6(getattr(self, f'block{i}_dw_bn')(x, train))
      x = getattr(self, f'block{i}_pointwise')(x)
      x = F.relu6(getattr(self, f'block{i}_pw_bn')(x, train))
    x = common.global_avg_pool(x)
    return self.conv_preds(x)

  def dense_layer_paths(self) -> List[str]:
    """Depthwise kernels stay dense (reference convention)."""
    return [f'block{i}_depthwise/kernel' for i in range(len(_V1_BLOCKS))]


class _InvertedResidual(nn.Module):

  def __init__(self, cin, expansion, features, stride, dtype, generator,
               device):
    super().__init__()
    hidden = cin * expansion
    self.expansion, self.stride = expansion, stride
    self.residual = stride == 1 and cin == features
    if expansion != 1:
      self.expand = _pointwise(cin, hidden, dtype, generator, device)
      self.expand_bn = common.BatchNorm(hidden, dtype, device=device)
    self.depthwise = _Depthwise(hidden, stride, dtype, generator, device)
    self.dw_bn = common.BatchNorm(hidden, dtype, device=device)
    self.project = _pointwise(hidden, features, dtype, generator, device)
    self.project_bn = common.BatchNorm(features, dtype, device=device)

  def forward(self, x, train: bool):
    y = x
    if self.expansion != 1:
      y = F.relu6(self.expand_bn(self.expand(y), train))
    y = F.relu6(self.dw_bn(self.depthwise(y), train))
    y = self.project_bn(self.project(y), train)
    return y + x if self.residual else y


class MobileNetV2(nn.Module):

  def __init__(self, width: float = 1.0, num_classes: int = 1000,
               dtype: torch.dtype = torch.float32, in_channels: int = 3,
               generator: Optional[torch.Generator] = None, device='cuda'):
    super().__init__()
    w, self.dtype = width, dtype
    cin = int(32 * w)
    self.initial_conv = common.ConvFixedPad(in_channels, cin, 3, 2,
                                            dtype=dtype, generator=generator,
                                            device=device)
    self.initial_bn = common.BatchNorm(cin, dtype, device=device)
    self.n_blocks = 0
    for t, c, n, s in _V2_BLOCKS:
      for i in range(n):
        feats = int(c * w)
        self.add_module(f'block{self.n_blocks}', _InvertedResidual(
            cin, t, feats, s if i == 0 else 1, dtype, generator, device))
        self.n_blocks += 1
        cin = feats
    head = int(1280 * max(1.0, w))
    self.head_conv = _pointwise(cin, head, dtype, generator, device)
    self.head_bn = common.BatchNorm(head, dtype, device=device)
    self.conv_preds = Dense(head, num_classes, dtype, generator=generator,
                            device=device)
    common.set_conv_paths(self)

  def forward(self, x: torch.Tensor, train: bool = False,
              block_masks=None) -> torch.Tensor:
    x = self.initial_conv(x.to(self.dtype), block_masks)
    x = F.relu6(self.initial_bn(x, train))
    for i in range(self.n_blocks):
      x = getattr(self, f'block{i}')(x, train)
    x = F.relu6(self.head_bn(self.head_conv(x), train))
    x = common.global_avg_pool(x)
    return self.conv_preds(x)

  def dense_layer_paths(self) -> List[str]:
    n_blocks = sum(n for _, _, n, _ in _V2_BLOCKS)
    return [f'block{i}/depthwise/kernel' for i in range(n_blocks)]
