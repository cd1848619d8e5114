"""Sparse-aware weight initializers, in PyTorch.

Counterpart of rigl_tpu/models/init.py:

  * sparse_variance_scaling -- variance scaling with the expected-nnz fan
    (scale / (fan * (1 - sparsity)));
  * random_sparse_init -- dense init with floor(sparsity * size) random
    entries zeroed (the sparse-shaped dense baseline);
  * layer_scaled_init -- dense variance scaling divided by
    sqrt(density(mask));
  * unit_scaled_init -- per-connection variance from each unit's actual
    masked fan-in / fan-out;
  * sparse_init / xavier_sparse_normal / kaiming_sparse_normal -- per-neuron
    fan-in, fan-out the number of non-ablated neurons;
  * reinit_masked_params -- one of the mask-driven schemes over a dict of
    masks.

Every function takes an explicit torch.Generator and draws on its device.
The variances are computed as JAX computes them (float32, the same
clamps); the draws themselves are torch's.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

# Standard deviation of a unit normal truncated at +-2 sigma.
_TRUNC_STD = 0.87962566103423978


def _sample(generator, shape, scale: torch.Tensor, distribution: str,
            dtype) -> torch.Tensor:
  """A draw of `shape` with per-element variance `scale`
  (broadcastable)."""
  gdev = generator.device if generator is not None else None
  shape = tuple(shape)
  scale = torch.as_tensor(scale, dtype=torch.float32).to(gdev)
  if distribution == 'normal':
    return (torch.randn(shape, generator=generator, device=gdev)
            * torch.sqrt(scale)).to(dtype)
  if distribution == 'truncated_normal':
    # TF VarianceScaling: truncated at 2 sigma, corrected std.
    z = torch.empty(shape, device=gdev)
    torch.nn.init.trunc_normal_(z, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (z * (torch.sqrt(scale) / _TRUNC_STD)).to(dtype)
  if distribution == 'uniform':
    u = torch.rand(shape, generator=generator, device=gdev) * 2.0 - 1.0
    return (u * torch.sqrt(3.0 * scale)).to(dtype)
  raise ValueError(f'Unknown distribution {distribution!r}')


def sparse_variance_scaling(sparsity: float, scale: float = 2.0,
                            mode: str = 'fan_in',
                            distribution: str = 'truncated_normal'):
  """An initializer (generator, shape, dtype) -> tensor whose fan counts
  are discounted by the density."""

  def init(generator, shape, dtype=torch.float32):
    fan_in = float(np.prod(shape[:-1]))
    fan_out = float(shape[-1])
    density = max(1.0 - sparsity, 1e-6)
    if mode == 'fan_in':
      denom = max(1.0, fan_in * density)
    elif mode == 'fan_out':
      denom = max(1.0, fan_out * density)
    else:
      denom = max(1.0, (fan_in + fan_out) * density / 2.0)
    return _sample(generator, shape, torch.tensor(scale / denom),
                   distribution, dtype)

  return init


def random_sparse_init(sparsity: float,
                       base_init: Optional[Callable] = None):
  """Dense init (`base_init`, default variance scaling 2 / fan_in on a
  truncated normal) with floor(sparsity * size) random entries zeroed."""
  base_init = base_init or sparse_variance_scaling(0.0, 2.0, 'fan_in',
                                                   'truncated_normal')

  def init(generator, shape, dtype=torch.float32):
    w = base_init(generator, shape, dtype)
    size = int(np.prod(shape))
    n_zeros = int(np.floor(sparsity * size))
    keep = torch.cat([torch.zeros(n_zeros, dtype=dtype),
                      torch.ones(size - n_zeros, dtype=dtype)])
    gdev = generator.device if generator is not None else None
    perm = torch.randperm(size, generator=generator, device=gdev).cpu()
    return w * keep[perm].reshape(tuple(shape)).to(w.device)

  return init


def _mask_2d_fans(mask: torch.Tensor):
  """Per-unit fans from a mask: conv masks reduce over spatial dims
  first."""
  if mask.dim() == 4:
    m2d = mask.sum(dim=(0, 1))
  elif mask.dim() == 2:
    m2d = mask
  else:
    raise ValueError(f'mask.shape: {tuple(mask.shape)} must be 4 or 2 '
                     'dimensional.')
  return m2d.sum(dim=-2), m2d.sum(dim=-1)   # per output, per input unit


def unit_scaled_init(generator, mask: torch.Tensor,
                     method: str = 'fanavg_uniform', scale: float = 1.0,
                     dtype=torch.float32) -> torch.Tensor:
  """Per-connection variance-scaled init from the mask's actual fans."""
  mode, distribution = method.strip().split('_')
  mask = mask.to(torch.float32)
  fan_ins, fan_outs = _mask_2d_fans(mask)
  fi = torch.clamp(fan_ins[None, :], min=1.0)    # indexed by output
  fo = torch.clamp(fan_outs[:, None], min=1.0)   # indexed by input
  if mode == 'fanin':
    s2d = scale / fi + 0.0 * fo
  elif mode == 'fanout':
    s2d = scale / fo + 0.0 * fi
  elif mode == 'fanavg':
    s2d = scale / torch.clamp((fi + fo) / 2.0, min=1.0)
  else:
    raise ValueError(f'mode: {mode} must be fanin, fanout or fanavg.')
  s = s2d.expand(mask.shape[-2:]).expand(mask.shape)
  w = _sample(generator, mask.shape, s, distribution, dtype)
  return w * mask.to(w.device, dtype)


def layer_scaled_init(generator, mask: torch.Tensor,
                      method: str = 'fanavg_uniform', scale: float = 1.0,
                      dtype=torch.float32) -> torch.Tensor:
  """Dense variance-scaling init divided by sqrt(layer density)."""
  mode, distribution = method.strip().split('_')
  fan_in = float(np.prod(mask.shape[:-1]))
  fan_out = float(mask.shape[-1])
  denom = {'fanin': fan_in, 'fanout': fan_out,
           'fanavg': (fan_in + fan_out) / 2.0}[mode]
  dense = _sample(generator, mask.shape,
                  torch.tensor(scale / max(denom, 1.0)), distribution, dtype)
  density = mask.to(torch.float32).sum() / mask.numel()
  return dense / torch.sqrt(torch.clamp(density, min=1e-12)).to(dense.device)


def sparse_init(generator, mask: torch.Tensor, scale: float = 1.0,
                mode: str = 'fan_avg', distribution: str = 'normal',
                dtype=torch.float32) -> torch.Tensor:
  """Per-neuron corrected init: each output neuron's fan-in is its
  surviving input count; fan-out is the number of non-ablated neurons."""
  mask = mask.to(torch.float32)
  neuron_fan_in = mask.reshape(-1, mask.shape[-1]).sum(dim=0)
  non_zero_neurons = (neuron_fan_in != 0).sum()
  fi = torch.clamp(neuron_fan_in, min=1.0)
  fo = torch.clamp(non_zero_neurons.to(torch.float32), min=1.0)
  if mode == 'fan_in':
    s = scale / fi
  elif mode == 'fan_out':
    s = scale / fo
  else:
    s = scale / ((fi + fo) / 2.0)
  w = _sample(generator, mask.shape, torch.broadcast_to(s, mask.shape),
              distribution, dtype)
  return w * mask.to(w.device, dtype)


def xavier_sparse_normal(generator, mask, dtype=torch.float32):
  return sparse_init(generator, mask, scale=1.0, mode='fan_avg',
                     distribution='normal', dtype=dtype)


def kaiming_sparse_normal(generator, mask, dtype=torch.float32):
  return sparse_init(generator, mask, scale=2.0, mode='fan_in',
                     distribution='normal', dtype=dtype)


def reinit_masked_params(generator, params_sel, masks,
                         method: str = 'unit_scaled', **kwargs):
  """Re-initializes a dict of masked kernels with a sparse-aware scheme,
  one draw after the other from `generator` in the dict's order."""
  del params_sel
  fns = {
      'unit_scaled': unit_scaled_init,
      'layer_scaled': layer_scaled_init,
      'sparse': sparse_init,
  }
  if method not in fns:
    raise ValueError(f'Unknown sparse re-init {method!r}')
  fn = fns[method]
  return {path: fn(generator, mask, **kwargs) for path, mask in masks.items()}
