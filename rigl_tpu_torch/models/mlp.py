"""MNIST MLPs, in PyTorch: the 300-100-10 network of the RigL MNIST
experiments and the parameter-budget MLP.

Counterpart of rigl_tpu/models/mlp.py.  Layers are named as flax names
them ('layer1', ...), so parameter paths are JAX's ('layer1/kernel').
Flax infers the input width; the port's models take `input_size`.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from rigl_tpu_torch.models.packed_convnet import Dense


class MnistMLP(nn.Module):
  """300-100-10 fully-connected MNIST net.  `custom_sparsity_map` gives the
  reference's per-layer convention: the last hidden layer at
  end_sparsity * sparsity_scale, the output layer dense."""

  def __init__(self, features: Sequence[int] = (300, 100),
               num_classes: int = 10, dtype: torch.dtype = torch.float32,
               input_size: int = 784,
               generator: Optional[torch.Generator] = None, device='cuda'):
    super().__init__()
    self.features, self.dtype = tuple(features), dtype
    widths = (input_size,) + self.features
    for i, feat in enumerate(self.features):
      self.add_module(f'layer{i + 1}', Dense(widths[i], feat, dtype,
                                             generator=generator,
                                             device=device))
    self.add_module(f'layer{len(self.features) + 1}',
                    Dense(widths[-1], num_classes, dtype, generator=generator,
                          device=device))

  def forward(self, x: torch.Tensor, train: bool = False,
              block_masks=None) -> torch.Tensor:
    del train, block_masks
    x = x.reshape(x.shape[0], -1).to(self.dtype)
    for i in range(len(self.features)):
      x = torch.relu(getattr(self, f'layer{i + 1}')(x))
    return getattr(self, f'layer{len(self.features) + 1}')(x)

  def custom_sparsity_map(self, end_sparsity: float,
                          sparsity_scale: float = 0.9) -> Dict[str, float]:
    n = len(self.features) + 1
    return {
        f'layer{n - 1}/kernel': end_sparsity * sparsity_scale,
        f'layer{n}/kernel': 0.0,
    }


def width_for_param_budget(param_count: int, depth: int,
                           input_size: int = 784,
                           num_classes: int = 10) -> int:
  """Closed-form hidden width giving about `param_count` parameters at
  `depth` hidden layers."""
  if depth == 0:
    raise ValueError('depth must be >= 1')
  # params = in*w + w + (depth-1)*(w^2 + w) + w*classes + classes
  a = depth - 1
  b = input_size + depth + num_classes
  c = num_classes - param_count
  if a == 0:
    return max(1, int(round(-c / b)))
  disc = b * b - 4 * a * c
  return max(1, int(round((-b + np.sqrt(disc)) / (2 * a))))


class BudgetMLP(nn.Module):
  """Depth-N MLP whose width is solved from a parameter budget."""

  def __init__(self, param_count: int = 266200, depth: int = 2,
               num_classes: int = 10, input_size: int = 784,
               dtype: torch.dtype = torch.float32,
               generator: Optional[torch.Generator] = None, device='cuda'):
    super().__init__()
    self.depth, self.dtype = depth, dtype
    width = width_for_param_budget(param_count, depth, input_size,
                                   num_classes)
    for i in range(depth):
      self.add_module(f'layer{i + 1}', Dense(input_size if i == 0 else width,
                                             width, dtype,
                                             generator=generator,
                                             device=device))
    self.add_module(f'layer{depth + 1}', Dense(width, num_classes, dtype,
                                               generator=generator,
                                               device=device))

  def forward(self, x: torch.Tensor, train: bool = False,
              block_masks=None) -> torch.Tensor:
    del train, block_masks
    x = x.reshape(x.shape[0], -1).to(self.dtype)
    for i in range(self.depth):
      x = torch.relu(getattr(self, f'layer{i + 1}')(x))
    return getattr(self, f'layer{self.depth + 1}')(x)
