"""Model registry of the port: a name or preset -> a torch module.

Counterpart of rigl_tpu/models/registry.py, with every name and preset it
has.  Keyword arguments go to the model's constructor, so the port's own
(device, generator, in_channels or input_shape / input_size) pass
through with the JAX fields.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

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


def create_model(name: str, **kwargs):
  """Instantiates a model by registry name or preset name."""
  if name in _PRESETS:
    base, preset_kwargs = _PRESETS[name]
    merged = dict(preset_kwargs)
    merged.update(kwargs)
    return _REGISTRY[base](**merged)
  if name in _REGISTRY:
    return _REGISTRY[name](**kwargs)
  raise ValueError(
      f'Unknown model {name!r}; available: '
      f'{sorted(_REGISTRY) + sorted(_PRESETS)}')


def available_models():
  return sorted(_REGISTRY) + sorted(_PRESETS)
