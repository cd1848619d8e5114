"""LeNet-5 and small CNNs, in PyTorch.

Counterpart of rigl_tpu/models/lenet.py: VALID 5x5 convs (LeNet5) or SAME
3x3 convs (SmallCNN), each followed by relu and a 2x2 VALID max pool, then
a dense head.  Activations are NHWC and the flatten before the first dense
layer runs in NHWC order, as flax's reshape does, so the converted
'dense1/kernel' rows line up.  Flax infers the flattened width; the port's
models take `input_shape` (H, W, C).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from rigl_tpu_torch.models import common
from rigl_tpu_torch.models.packed_convnet import Conv, Dense


class LeNet5(nn.Module):
  """Conv(6, 5x5)-pool-Conv(16, 5x5)-pool-Dense(120)-Dense(84)-Dense(classes),
  optional BatchNorm after each pool and hidden dense layer."""

  def __init__(self, num_classes: int = 10,
               hidden_sizes: Sequence[int] = (6, 16, 120, 84),
               use_batch_norm: bool = False,
               dtype: torch.dtype = torch.float32,
               input_shape: Tuple[int, int, int] = (28, 28, 1),
               generator: Optional[torch.Generator] = None, device='cuda'):
    super().__init__()
    h = tuple(hidden_sizes)
    self.dtype, self.use_batch_norm = dtype, use_batch_norm
    height, width, cin = input_shape
    kw = dict(dtype=dtype, generator=generator, device=device)
    conv = dict(padding='VALID', use_bias=True, **kw)
    self.conv1 = Conv(cin, h[0], (5, 5), **conv)
    self.conv2 = Conv(h[0], h[1], (5, 5), **conv)
    for _ in range(2):
      height, width = (height - 4) // 2, (width - 4) // 2
    self.dense1 = Dense(height * width * h[1], h[2], **kw)
    self.dense2 = Dense(h[2], h[3], **kw)
    self.logits = Dense(h[3], num_classes, **kw)
    if use_batch_norm:
      for i, feats in enumerate(h):
        self.add_module(f'bn{i + 1}', common.BatchNorm(feats, dtype,
                                                       device=device))

  def _bn(self, x, i, train):
    if self.use_batch_norm:
      x = getattr(self, f'bn{i}')(x, train)
    return x

  def forward(self, x: torch.Tensor, train: bool = False,
              block_masks=None) -> torch.Tensor:
    del block_masks
    x = x.to(self.dtype)
    x = common.max_pool(torch.relu(self.conv1(x)), 2, 2)
    x = self._bn(x, 1, train)
    x = common.max_pool(torch.relu(self.conv2(x)), 2, 2)
    x = self._bn(x, 2, train)
    x = x.reshape(x.shape[0], -1)
    x = self._bn(torch.relu(self.dense1(x)), 3, train)
    x = self._bn(torch.relu(self.dense2(x)), 4, train)
    return self.logits(x)


class SmallCNN(nn.Module):
  """Conv stacks (SAME 3x3, relu, 2x2 pool) and a dense head."""

  def __init__(self, num_classes: int = 10,
               conv_features: Sequence[int] = (32, 64),
               dense_features: Sequence[int] = (256,),
               dtype: torch.dtype = torch.float32,
               input_shape: Tuple[int, int, int] = (28, 28, 1),
               generator: Optional[torch.Generator] = None, device='cuda'):
    super().__init__()
    self.dtype = dtype
    self.n_conv, self.n_dense = len(conv_features), len(dense_features)
    height, width, cin = input_shape
    kw = dict(dtype=dtype, generator=generator, device=device)
    for i, feats in enumerate(conv_features):
      self.add_module(f'conv{i + 1}', Conv(cin, feats, (3, 3), use_bias=True,
                                           **kw))
      cin, height, width = feats, height // 2, width // 2
    fin = height * width * cin
    for i, feats in enumerate(dense_features):
      self.add_module(f'dense{i + 1}', Dense(fin, feats, **kw))
      fin = feats
    self.logits = Dense(fin, num_classes, **kw)

  def forward(self, x: torch.Tensor, train: bool = False,
              block_masks=None) -> torch.Tensor:
    del train, block_masks
    x = x.to(self.dtype)
    for i in range(self.n_conv):
      x = common.max_pool(torch.relu(getattr(self, f'conv{i + 1}')(x)), 2, 2)
    x = x.reshape(x.shape[0], -1)
    for i in range(self.n_dense):
      x = torch.relu(getattr(self, f'dense{i + 1}')(x))
    return self.logits(x)
