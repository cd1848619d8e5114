"""VGG-A / 16 / 19 over dense-masked weights, in PyTorch.

Counterpart of rigl_tpu/models/vgg.py: 3x3 SAME conv blocks at widths
(64, 128, 256, 512, 512), each block ending in a 2x2 max pool, then the
fully-convolutional head: 'fc6' a 7x7 VALID conv to 4096 (224 px inputs
give a 7x7 map), 'fc7' and 'fc8' 1x1 convs, all with biases, dropout
after fc6 and fc7.  Dropout draws from `dropout_rng` (one seeded 0 on
`device` when None).  Parameter paths are JAX's ('conv3_2/kernel',
'fc6/kernel').
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from rigl_tpu_torch.models import common
from rigl_tpu_torch.models.packed_convnet import Conv

# convs per block, at widths (64, 128, 256, 512, 512).
_CONFIGS: Dict[str, Sequence[int]] = {
    'vgg_a': (1, 1, 2, 2, 2),
    'vgg_16': (2, 2, 3, 3, 3),
    'vgg_19': (2, 2, 4, 4, 4),
}
_WIDTHS = (64, 128, 256, 512, 512)


class VGG(nn.Module):

  def __init__(self, variant: str = 'vgg_16', num_classes: int = 1000,
               dropout_rate: float = 0.5, dtype: torch.dtype = torch.float32,
               in_channels: int = 3,
               generator: Optional[torch.Generator] = None,
               dropout_rng: Optional[torch.Generator] = None, device='cuda'):
    super().__init__()
    if variant not in _CONFIGS:
      raise ValueError(f'Unknown VGG variant: {variant}')
    self.dtype = dtype
    kw = dict(dtype=dtype, use_bias=True, generator=generator, device=device)
    self.conv_names = []
    cin = in_channels
    for block, (n_convs, width) in enumerate(zip(_CONFIGS[variant],
                                                 _WIDTHS)):
      names = []
      for i in range(n_convs):
        name = f'conv{block + 1}_{i + 1}'
        self.add_module(name, Conv(
            cin, width, (3, 3), kernel_init=common.conv_kernel_init(), **kw))
        names.append(name)
        cin = width
      self.conv_names.append(names)
    self.fc6 = Conv(cin, 4096, (7, 7), padding='VALID', **kw)
    self.fc7 = Conv(4096, 4096, (1, 1), **kw)
    self.fc8 = Conv(4096, num_classes, (1, 1), **kw)
    self.dropout = common.Dropout(dropout_rate, common.dropout_generator(
        dropout_rng, device) if dropout_rate else None)

  def forward(self, x: torch.Tensor, train: bool = False,
              block_masks=None) -> torch.Tensor:
    del block_masks
    x = x.to(self.dtype)
    for names in self.conv_names:
      for name in names:
        x = torch.relu(getattr(self, name)(x))
      x = common.max_pool(x, 2, 2)
    x = self.dropout(torch.relu(self.fc6(x)), train)
    x = self.dropout(torch.relu(self.fc7(x)), train)
    return self.fc8(x).squeeze(2).squeeze(1)
