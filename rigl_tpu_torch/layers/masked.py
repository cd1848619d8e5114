"""Module-level masking: layers that carry their mask, in PyTorch.

Counterpart of rigl_tpu/layers/masked.py.  The framework's main masking
path is the functional overlay (sparsity/masks.py apply_masks), which
makes any model sparse without special layers; these layers keep the mask
with the module instead, as a buffer `kernel_mask` beside the parameter
`kernel`, multiplied into the kernel on every call.  Kernels keep flax's
layouts, (in, out) and HWIO, so a layer's mask path (the module path and
'kernel', as in flax's 'masks' collection) and its converted weights line
up with JAX's.

  layer = MaskedDense(8, 100)
  y = layer(x)                      # x @ (kernel_mask * kernel) + bias
  masks = masks_to_dict(model)      # {'d1/kernel': mask, ...}
  dict_to_masks(model, masks)       # writes them back
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from rigl_tpu_torch.models.common import conv_nhwc, lecun_normal_init
from rigl_tpu_torch.sparsity.masks import path_sorted, path_str


class MaskedDense(nn.Module):
  """Dense layer computing ``x @ (mask * kernel) + bias``."""

  def __init__(self, in_features: int, features: int, use_bias: bool = True,
               dtype: torch.dtype = torch.float32, kernel_init=None,
               generator: Optional[torch.Generator] = None, device='cuda'):
    super().__init__()
    self.dtype = dtype
    init = kernel_init or lecun_normal_init
    self.kernel = nn.Parameter(init((in_features, features),
                                    generator).to(device))
    self.register_buffer('kernel_mask', torch.ones(
        (in_features, features), device=device))
    self.bias = (nn.Parameter(torch.zeros(features, device=device))
                 if use_bias else None)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    y = x.to(self.dtype) @ (self.kernel * self.kernel_mask).to(self.dtype)
    if self.bias is not None:
      y = y + self.bias.to(self.dtype)
    return y


class MaskedConv(nn.Module):
  """Conv layer with a masked HWIO kernel, NHWC activations."""

  def __init__(self, in_features: int, features: int,
               kernel_size: Tuple[int, int] = (3, 3),
               strides: Union[int, Tuple[int, int]] = 1,
               padding: str = 'SAME', use_bias: bool = True,
               feature_group_count: int = 1,
               dtype: torch.dtype = torch.float32, kernel_init=None,
               generator: Optional[torch.Generator] = None, device='cuda'):
    super().__init__()
    if not isinstance(strides, int):
      if strides[0] != strides[1]:
        raise ValueError(f'unequal strides {strides} are not supported')
      strides = strides[0]
    self.strides, self.padding = strides, padding
    self.groups, self.dtype = feature_group_count, dtype
    kshape = tuple(kernel_size) + (in_features // feature_group_count,
                                   features)
    init = kernel_init or lecun_normal_init
    self.kernel = nn.Parameter(init(kshape, generator).to(device))
    self.register_buffer('kernel_mask', torch.ones(kshape, device=device))
    self.bias = (nn.Parameter(torch.zeros(features, device=device))
                 if use_bias else None)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    w = (self.kernel * self.kernel_mask).to(self.dtype)
    y = conv_nhwc(x.to(self.dtype), w, self.strides, self.padding,
                  self.groups)
    if self.bias is not None:
      y = y + self.bias.to(self.dtype)
    return y


_MASKED = (MaskedDense, MaskedConv)


def masks_to_dict(model: nn.Module) -> dict:
  """{mask path: mask} of every masked layer of `model`: the layer's path
  and 'kernel' ('d1/kernel'), in the order JAX flattens the 'masks'
  collection."""
  out = {path_str(f'{name}.kernel' if name else 'kernel'): mod.kernel_mask
         for name, mod in model.named_modules() if isinstance(mod, _MASKED)}
  return {p: out[p] for p in path_sorted(out)}


def dict_to_masks(model: nn.Module, mask_dict) -> nn.Module:
  """Copies the masks of `mask_dict` ({mask path: mask}) into the masked
  layers of `model`; layers not in the dict keep theirs."""
  with torch.no_grad():
    for name, mod in model.named_modules():
      path = path_str(f'{name}.kernel' if name else 'kernel')
      if isinstance(mod, _MASKED) and path in mask_dict:
        mod.kernel_mask.copy_(torch.as_tensor(mask_dict[path]))
  return model
