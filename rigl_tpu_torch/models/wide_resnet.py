"""Wide ResNet (6n+4, width k) for CIFAR over dense-masked weights, in
PyTorch.

Counterpart of rigl_tpu/models/wide_resnet.py: a 3x3 initial conv of 16,
three groups of n pre-activation residual blocks (BN-relu-conv) at 16k /
32k / 64k channels with strides 1 / 2 / 2, the projection shortcut taken
from the pre-activated tensor, a final BN and relu, global average
pooling and a linear classifier.  Convs are models/common.py's
ConvFixedPad and BatchNorm is flax's, so parameter paths are JAX's
('group2_block0/conv1/conv/kernel', 'group2_block0/proj/conv/kernel').
`droprate` dropout inside the blocks draws from `dropout_rng` (one seeded
0 on `device` when None).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from rigl_tpu_torch.models import common
from rigl_tpu_torch.models.packed_convnet import Dense


class _ResidualBlock(nn.Module):

  def __init__(self, cin, features, stride, droprate, dtype, generator,
               dropout_rng, device):
    super().__init__()
    kw = dict(dtype=dtype, generator=generator, device=device)
    self.bn1 = common.BatchNorm(cin, dtype, device=device)
    self.use_projection = stride > 1 or cin != features
    if self.use_projection:
      self.proj = common.ConvFixedPad(cin, features, 1, stride, **kw)
    self.conv1 = common.ConvFixedPad(cin, features, 3, stride, **kw)
    self.bn2 = common.BatchNorm(features, dtype, device=device)
    self.dropout = common.Dropout(droprate, dropout_rng)
    self.conv2 = common.ConvFixedPad(features, features, 3, 1, **kw)

  def forward(self, x, train: bool, block_masks=None):
    y = torch.relu(self.bn1(x, train))
    shortcut = self.proj(y, block_masks) if self.use_projection else x
    y = self.conv1(y, block_masks)
    y = torch.relu(self.bn2(y, train))
    y = self.dropout(y, train)
    y = self.conv2(y, block_masks)
    return y + shortcut


class WideResNet(nn.Module):
  """depth must be 6n+4; width is the multiplier k."""

  def __init__(self, depth: int = 22, width: int = 2, num_classes: int = 10,
               droprate: float = 0.0, dtype: torch.dtype = torch.float32,
               in_channels: int = 3,
               generator: Optional[torch.Generator] = None,
               dropout_rng: Optional[torch.Generator] = None, device='cuda'):
    super().__init__()
    if (depth - 4) % 6 != 0:
      raise ValueError('Depth of ResNet specified not sufficient.')
    n_blocks = (depth - 4) // 6
    self.dtype = dtype
    rng = common.dropout_generator(dropout_rng, device) if droprate else None
    self.init_conv = common.ConvFixedPad(in_channels, 16, 3, 1, dtype=dtype,
                                         generator=generator, device=device)
    cin = 16
    self.block_names = []
    for group, feats in enumerate((16 * width, 32 * width, 64 * width)):
      for block in range(n_blocks):
        stride = 2 if (group > 0 and block == 0) else 1
        name = f'group{group + 1}_block{block}'
        self.add_module(name, _ResidualBlock(cin, feats, stride, droprate,
                                             dtype, generator, rng, device))
        self.block_names.append(name)
        cin = feats
    self.final_bn = common.BatchNorm(cin, dtype, device=device)
    self.logits = Dense(cin, num_classes, dtype, generator=generator,
                        device=device)
    common.set_conv_paths(self)

  def forward(self, x: torch.Tensor, train: bool = False,
              block_masks=None) -> torch.Tensor:
    x = self.init_conv(x.to(self.dtype), block_masks)
    for name in self.block_names:
      x = getattr(self, name)(x, train, block_masks)
    x = torch.relu(self.final_bn(x, train))
    x = common.global_avg_pool(x)
    return self.logits(x)
