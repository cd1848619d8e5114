"""Q / value networks of the RL workload, in PyTorch.

Counterpart of rigl_tpu/rl/networks.py (parity with
rigl/rl/dqn_agents.py: NatureDQNNetwork with width-scaled convs,
:211-306, ImpalaNetwork, :103-208, and a small MLP Q-net for classic
control).  The zoo's conventions hold (models/common.py): NHWC
activations, HWIO conv kernels, Dense kernels (in, out), module names
that read as the flax paths ('conv1/kernel', 'block0/res1_conv2/bias'),
and flax's default initializers: every kernel lecun-normal (a normal
truncated at 2 sigma, variance 1 / fan_in, models/init.py), every bias
zero.  Convs are SAME as XLA pads them (the odd pixel high; NatureDQN's
4x4 stride-2 conv on 3x3 pads 1 / 2), Impala's max pool SAME with -inf.
Sparsity comes from the mask overlay, as everywhere else.

Flax infers input widths; these modules take `obs_shape` (without the
batch).  `reset_parameters(generator)` redraws every kernel and zeroes
every bias, in definition order, from the generator (the agents' init).
`apply_params(params, x)` runs a network on a {path: tensor} dict of its
parameters, as flax's apply does (the agents' masked and target
weights); `forward(x)` is apply_params on the module's own parameters.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from rigl_tpu_torch.layers.packed_conv import conv2d_same
from rigl_tpu_torch.models import init as init_lib
from rigl_tpu_torch.models.packed_convnet import Conv, Dense, _max_pool_same
from rigl_tpu_torch.sparsity import masks as masks_lib

_LECUN = init_lib.sparse_variance_scaling(0.0, 1.0, 'fan_in',
                                          'truncated_normal')


def reset_parameters(module: nn.Module,
                     generator: Optional[torch.Generator] = None):
  """flax's default init of every Dense and Conv of `module`, in
  definition order: lecun-normal kernels, zero biases."""
  with torch.no_grad():
    for m in module.modules():
      if isinstance(m, (Dense, Conv)):
        m.kernel.copy_(_LECUN(generator, tuple(m.kernel.shape)))
        if m.bias is not None:
          m.bias.zero_()
  return module


def _same(n: int, stride: int) -> int:
  return -(-n // stride)


def dense(params, name: str, x, dtype=None):
  """flax Dense `name` on x with the kernel (and bias) in `params`,
  computed in `dtype`, or (flax's dtype=None) in x's and the kernel's
  promoted dtype."""
  kernel = params[f'{name}/kernel']
  dtype = dtype or torch.promote_types(x.dtype, kernel.dtype)
  y = x.to(dtype) @ kernel.to(dtype)
  bias = params.get(f'{name}/bias')
  return y if bias is None else y + bias.to(dtype)


def conv(params, name: str, x, strides=(1, 1), dtype=torch.float32):
  """flax Conv `name` (SAME, with bias) on NHWC x."""
  y = conv2d_same(x, params[f'{name}/kernel'], strides, dtype)
  return y + params[f'{name}/bias'].to(dtype)


class _Net(nn.Module):
  def reset_parameters(self, generator: Optional[torch.Generator] = None):
    return reset_parameters(self, generator)

  def forward(self, *inputs, train: bool = False):
    del train
    return self.apply_params(masks_lib.param_dict(self), *inputs)


class MLPQNetwork(_Net):
  def __init__(self, num_actions: int, hidden: Sequence[int] = (256, 256),
               dtype: torch.dtype = torch.float32,
               obs_shape: Tuple[int, ...] = (4,),
               generator: Optional[torch.Generator] = None, device='cuda'):
    super().__init__()
    self.hidden, self.dtype = tuple(hidden), dtype
    widths = (math.prod(obs_shape),) + self.hidden
    kw = dict(dtype=dtype, generator=generator, device=device)
    for i, h in enumerate(self.hidden):
      self.add_module(f'dense{i + 1}', Dense(widths[i], h, **kw))
    self.q = Dense(widths[-1], num_actions, **kw)
    self.reset_parameters(generator)

  def apply_params(self, params, x):
    x = x.reshape(x.shape[0], -1)
    for i in range(len(self.hidden)):
      x = torch.relu(dense(params, f'dense{i + 1}', x, self.dtype))
    return dense(params, 'q', x, self.dtype)


class NatureDQN(_Net):
  """Nature-DQN convnet with a width multiplier (dqn_agents.py:211-306)."""

  def __init__(self, num_actions: int, width: float = 1.0,
               dtype: torch.dtype = torch.float32,
               obs_shape: Tuple[int, ...] = (10, 10, 4),
               generator: Optional[torch.Generator] = None, device='cuda'):
    super().__init__()
    self.dtype = dtype
    h, w, cin = obs_shape
    c1, c2, c3 = int(32 * width), int(64 * width), int(64 * width)
    kw = dict(dtype=dtype, use_bias=True, generator=generator, device=device)
    self.conv1 = Conv(cin, c1, (8, 8), strides=(4, 4), **kw)
    self.conv2 = Conv(c1, c2, (4, 4), strides=(2, 2), **kw)
    self.conv3 = Conv(c2, c3, (3, 3), strides=(1, 1), **kw)
    h, w = _same(_same(h, 4), 2), _same(_same(w, 4), 2)
    dkw = dict(dtype=dtype, generator=generator, device=device)
    self.dense1 = Dense(h * w * c3, int(512 * width), **dkw)
    self.q = Dense(int(512 * width), num_actions, **dkw)
    self.reset_parameters(generator)

  def apply_params(self, params, x):
    x = torch.relu(conv(params, 'conv1', x, (4, 4), self.dtype))
    x = torch.relu(conv(params, 'conv2', x, (2, 2), self.dtype))
    x = torch.relu(conv(params, 'conv3', x, (1, 1), self.dtype))
    x = x.reshape(x.shape[0], -1)
    x = torch.relu(dense(params, 'dense1', x, self.dtype))
    return dense(params, 'q', x, self.dtype)


class _ImpalaBlock(nn.Module):
  def __init__(self, in_features: int, features: int,
               dtype: torch.dtype = torch.float32,
               generator: Optional[torch.Generator] = None, device='cuda'):
    super().__init__()
    kw = dict(dtype=dtype, use_bias=True, generator=generator, device=device)
    self.conv = Conv(in_features, features, (3, 3), **kw)
    for i in range(2):
      self.add_module(f'res{i}_conv1', Conv(features, features, (3, 3), **kw))
      self.add_module(f'res{i}_conv2', Conv(features, features, (3, 3), **kw))


def _impala_block(params, name, x, dtype):
  x = conv(params, f'{name}/conv', x, dtype=dtype)
  x = _max_pool_same(x, 3, 2)
  for i in range(2):
    y = torch.relu(x)
    y = conv(params, f'{name}/res{i}_conv1', y, dtype=dtype)
    y = torch.relu(y)
    y = conv(params, f'{name}/res{i}_conv2', y, dtype=dtype)
    x = x + y
  return x


class ImpalaNet(_Net):
  """IMPALA deep net (dqn_agents.py:103-208), width-scaled."""

  def __init__(self, num_actions: int, width: float = 1.0,
               dtype: torch.dtype = torch.float32,
               obs_shape: Tuple[int, ...] = (10, 10, 4),
               generator: Optional[torch.Generator] = None, device='cuda'):
    super().__init__()
    self.dtype = dtype
    h, w, cin = obs_shape
    for i, feats in enumerate((16, 32, 32)):
      f = int(feats * width)
      self.add_module(f'block{i}', _ImpalaBlock(cin, f, dtype, generator,
                                                device))
      cin, h, w = f, _same(h, 2), _same(w, 2)
    kw = dict(dtype=dtype, generator=generator, device=device)
    self.dense1 = Dense(h * w * cin, int(256 * width), **kw)
    self.q = Dense(int(256 * width), num_actions, **kw)
    self.reset_parameters(generator)

  def apply_params(self, params, x):
    for i in range(3):
      x = _impala_block(params, f'block{i}', x, self.dtype)
    x = torch.relu(x)
    x = x.reshape(x.shape[0], -1)
    x = torch.relu(dense(params, 'dense1', x, self.dtype))
    return dense(params, 'q', x, self.dtype)
