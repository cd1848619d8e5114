"""ImageNet ResNet v1 family (18/34/50/101/152/200) over dense-masked
weights, in PyTorch.

Counterpart of rigl_tpu/models/resnet.py (parity with the reference's
imagenet_resnet/resnet_model.py): conv-BN-relu ordering, bottleneck
blocks whose final BN scale starts at zero, projection shortcuts, a width
multiplier, and the first/last-layer pruning switches.  Activations are
NHWC; every module is named as its flax path, so parameter names read
with '/' are the JAX package's mask paths ('initial_conv/conv/kernel',
'group2_block0/conv1/conv/kernel', 'final_dense/kernel') and BatchNorm
buffers its batch_stats paths ('initial_bn/mean').

`block`: with a (rows, cols) block shape, a call given `block_masks` (the
flat {mask path: entry} dict of ops/block_mask.py) runs each listed conv
on the block-sparse kernels; unlisted convs, and every conv without
`block`, run dense.  Parameters are the same either way.  Initial values
come from `generator`, not flax's draws: tests carry JAX's variables over
with convert.py.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from rigl_tpu_torch.models import common
from rigl_tpu_torch.models.packed_convnet import Dense

# depth -> (use_bottleneck, blocks per group)
DEPTHS = {
    18: (False, (2, 2, 2, 2)),
    34: (False, (3, 4, 6, 3)),
    50: (True, (3, 4, 6, 3)),
    101: (True, (3, 4, 23, 3)),
    152: (True, (3, 8, 36, 3)),
    200: (True, (3, 24, 36, 3)),
}


class _ResidualBlock(nn.Module):
  """Two 3x3 convs; projection shortcut on the first block of a group."""

  def __init__(self, cin, features, stride, use_projection, conv, bn):
    super().__init__()
    if use_projection:
      self.proj = conv(cin, features, 1, stride)
      self.proj_bn = bn(features)
    self.use_projection = use_projection
    self.conv1 = conv(cin, features, 3, stride)
    self.bn1 = bn(features)
    self.conv2 = conv(features, features, 3, 1)
    self.bn2 = bn(features, zero_scale=True)
    self.out_features = features

  def forward(self, x, train: bool, block_masks=None):
    shortcut = x
    if self.use_projection:
      shortcut = self.proj_bn(self.proj(x, block_masks), train)
    y = torch.relu(self.bn1(self.conv1(x, block_masks), train))
    y = self.bn2(self.conv2(y, block_masks), train)
    return torch.relu(y + shortcut)


class _BottleneckBlock(nn.Module):
  """1x1 reduce, 3x3, 1x1 expand (4x); projection on group entry."""

  def __init__(self, cin, features, stride, use_projection, conv, bn):
    super().__init__()
    out = 4 * features
    if use_projection:
      self.proj = conv(cin, out, 1, stride)
      self.proj_bn = bn(out)
    self.use_projection = use_projection
    self.conv1 = conv(cin, features, 1, 1)
    self.bn1 = bn(features)
    self.conv2 = conv(features, features, 3, stride)
    self.bn2 = bn(features)
    self.conv3 = conv(features, out, 1, 1)
    self.bn3 = bn(out, zero_scale=True)
    self.out_features = out

  def forward(self, x, train: bool, block_masks=None):
    shortcut = x
    if self.use_projection:
      shortcut = self.proj_bn(self.proj(x, block_masks), train)
    y = torch.relu(self.bn1(self.conv1(x, block_masks), train))
    y = torch.relu(self.bn2(self.conv2(y, block_masks), train))
    y = self.bn3(self.conv3(y, block_masks), train)
    return torch.relu(y + shortcut)


class ResNet(nn.Module):
  """ResNet v1; `width` scales every group's channel count."""

  def __init__(self, depth: int = 50, num_classes: int = 1000,
               width: float = 1.0, dtype: torch.dtype = torch.float32,
               block=None, block_bm: int = 512,
               block_tap_bm: Optional[int] = None, in_channels: int = 3,
               generator: Optional[torch.Generator] = None, device='cuda'):
    super().__init__()
    if depth not in DEPTHS:
      raise ValueError(f'Not a valid resnet_depth: {depth}')
    self.depth, self.width, self.dtype = depth, width, dtype
    use_bottleneck, layers = DEPTHS[depth]
    block_cls = _BottleneckBlock if use_bottleneck else _ResidualBlock

    def conv(cin, features, k, stride):
      return common.ConvFixedPad(cin, features, k, stride, dtype=dtype,
                                 block=block, block_bm=block_bm,
                                 block_tap_bm=block_tap_bm,
                                 generator=generator, device=device)

    def bn(features, zero_scale=False):
      return common.BatchNorm(features, dtype, zero_scale, device)

    stem = int(64 * width)
    self.initial_conv = common.ConvFixedPad(in_channels, stem, 7, 2,
                                            dtype=dtype, generator=generator,
                                            device=device)
    self.initial_bn = bn(stem)
    cin = stem
    self.block_names = []
    for group, n_blocks in enumerate(layers):
      feats = int(64 * (2 ** group) * width)
      for i in range(n_blocks):
        stride = 2 if (group > 0 and i == 0) else 1
        name = f'group{group + 1}_block{i}'
        blk = block_cls(cin, feats, stride, i == 0, conv, bn)
        self.add_module(name, blk)
        self.block_names.append(name)
        cin = blk.out_features
    self.final_dense = Dense(cin, num_classes, dtype, generator=generator,
                             device=device)
    common.set_conv_paths(self)

  def forward(self, x: torch.Tensor, train: bool = False,
              block_masks=None) -> torch.Tensor:
    """x (N, H, W, C) -> logits (N, num_classes) in `dtype`.
    `block_masks`: flat {mask path: entry} dict, or None."""
    x = x.to(self.dtype)
    x = torch.relu(self.initial_bn(self.initial_conv(x), train))
    x = common.fixed_padding(x, 3)
    x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2).permute(0, 2, 3, 1)
    for name in self.block_names:
      x = getattr(self, name)(x, train, block_masks)
    x = common.global_avg_pool(x)
    return self.final_dense(x)

  def first_last_layer_map(self, prune_first_layer: bool,
                           prune_last_layer: bool):
    """custom_sparsity_map entries pinning the first / last layers dense
    (the reference's prune_first_layer / prune_last_layer flags)."""
    out = {}
    if not prune_first_layer:
      out['initial_conv/conv/kernel'] = 0.0
    if not prune_last_layer:
      out['final_dense/kernel'] = 0.0
    return out


def resnet(depth: int = 50, **kwargs) -> ResNet:
  return ResNet(depth=depth, **kwargs)
