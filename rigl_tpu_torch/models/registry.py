"""Model registry of the port: a name or preset -> a torch module.

Counterpart of rigl_tpu/models/registry.py, with every name and preset it
has.  Keyword arguments go to the model's constructor, so the port's own
(device, generator, in_channels or input_shape / input_size) pass
through with the JAX fields.  `create_model` also derives the input
kwargs from the data's shape and the random generators from a seed, as
the trainer and the export loader build their models.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict

import torch

from rigl_tpu_torch.models.lenet import LeNet5, SmallCNN
from rigl_tpu_torch.models.mlp import BudgetMLP, MnistMLP
from rigl_tpu_torch.models.mobilenet import MobileNetV1, MobileNetV2
from rigl_tpu_torch.models.resnet import ResNet
from rigl_tpu_torch.models.vgg import VGG
from rigl_tpu_torch.models.wide_resnet import WideResNet

_REGISTRY: Dict[str, Callable[..., Any]] = {
    'mnist_mlp': MnistMLP,
    'budget_mlp': BudgetMLP,
    'lenet5': LeNet5,
    'small_cnn': SmallCNN,
    'wide_resnet': WideResNet,
    'resnet': ResNet,
    'mobilenet_v1': MobileNetV1,
    'mobilenet_v2': MobileNetV2,
    'vgg': VGG,
}

# Named configurations matching the reference trainers.
_PRESETS = {
    'wrn_22_2': ('wide_resnet', dict(depth=22, width=2)),
    'wrn_16_4': ('wide_resnet', dict(depth=16, width=4)),
    'resnet18': ('resnet', dict(depth=18)),
    'resnet34': ('resnet', dict(depth=34)),
    'resnet50': ('resnet', dict(depth=50)),
    'resnet101': ('resnet', dict(depth=101)),
    'resnet152': ('resnet', dict(depth=152)),
    'resnet200': ('resnet', dict(depth=200)),
    'vgg_16': ('vgg', dict(variant='vgg_16')),
    'vgg_19': ('vgg', dict(variant='vgg_19')),
    'vgg_a': ('vgg', dict(variant='vgg_a')),
}


# The families whose train mode draws dropout noise (VGG's fc6 / fc7, WRN's
# droprate).
_DROPOUT = ('vgg', 'wide_resnet')


def _input_kwargs(base: str, data_shape) -> Dict[str, Any]:
  """The constructor kwargs giving family `base` its input shape (H, W, C),
  which flax infers at init: MLPs take the flattened size, LeNet-style
  nets the whole shape, the conv nets the channels."""
  if base in ('mnist_mlp', 'budget_mlp'):
    return {'input_size': math.prod(int(s) for s in data_shape)}
  if base in ('lenet5', 'small_cnn'):
    return {'input_shape': tuple(int(s) for s in data_shape)}
  return {'in_channels': int(data_shape[-1])}


def create_model(name: str, data_shape=None, seed=None, **kwargs):
  """Instantiates a model by registry name or preset name.  With
  `data_shape` (H, W, C) the input kwargs come from it; with `seed` the
  weights come from a torch generator seeded `seed`, and dropout from one
  on the model's device seeded `seed`.  A `dtype` given by name, as a
  JSON config holds it ('bfloat16', 'torch.bfloat16'), is resolved."""
  if name not in _PRESETS and name not in _REGISTRY:
    raise ValueError(
        f'Unknown model {name!r}; available: '
        f'{sorted(_REGISTRY) + sorted(_PRESETS)}')
  base, preset_kwargs = _PRESETS.get(name, (name, {}))
  kw = {**preset_kwargs, **kwargs}
  if isinstance(kw.get('dtype'), str):
    kw['dtype'] = getattr(torch, kw['dtype'].rsplit('.', 1)[-1])
  if data_shape is not None:
    kw.update(_input_kwargs(base, data_shape))
  if seed is not None:
    kw['generator'] = torch.Generator().manual_seed(seed)
    if base in _DROPOUT:
      kw['dropout_rng'] = torch.Generator(
          device=kw.get('device', 'cuda')).manual_seed(seed)
  return _REGISTRY[base](**kw)


def available_models():
  return sorted(_REGISTRY) + sorted(_PRESETS)
