"""ImageNet driver: parity with rigl/imagenet_resnet/imagenet_train_eval.py:
ResNet-50/MobileNet/VGG, bfloat16, label smoothing 0.1, weight decay 1e-4,
batch 1024, piecewise-warmup LR, training_steps_multiplier for the
5x-100x runs.

Counterpart of rigl_tpu/drivers/imagenet.py, with its flags and defaults
on argparse, plus --device (default cuda; --device=cpu runs on the CPU).
The port runs on one device: --n_model_shards above 1 is refused.

  python -m rigl_tpu_torch.drivers.imagenet --model_architecture=resnet \\
      --training_method=rigl --end_sparsity=0.8
"""

from __future__ import annotations

from typing import Optional, Sequence

from rigl_tpu_torch.drivers import common


def build_parser():
  p = common.make_parser(__doc__.split('\n\n')[0])
  g = common.define_common_flags(
      p, default_method='rigl', default_sparsity=0.8, default_steps=112590,
      default_batch=1024, default_frequency=100, default_end_step=25000,
      default_weight_decay=1e-4, default_label_smoothing=0.1)
  g.add_argument('--model_architecture', default='resnet',
                 help='resnet|mobilenet_v1|mobilenet_v2|vgg_16|vgg_19|vgg_a')
  g.add_argument('--resnet_depth', type=int, default=50)
  g.add_argument('--width', type=float, default=1.0,
                 help='width multiplier')
  common.add_bool(g, 'prune_first_layer', False,
                  'mask the first conv (default dense, like the reference '
                  'first_layer_sparsity=0)')
  common.add_bool(g, 'prune_last_layer', True)
  g.add_argument('--first_layer_sparsity', type=float, default=-1.0,
                 help='override; <0 disabled')
  g.add_argument('--last_layer_sparsity', type=float, default=-1.0)
  g.add_argument('--n_model_shards', type=int, default=1,
                 help="size of the mesh 'model' axis (1 on the port)")
  return p


def config_from_args(args):
  """The TrainConfig main trains (model, kwargs and layer map from the
  architecture flags)."""
  import torch
  arch = args.model_architecture
  if arch == 'resnet':
    model, mkw = 'resnet', dict(depth=args.resnet_depth, width=args.width)
  elif arch in ('mobilenet_v1', 'mobilenet_v2'):
    model, mkw = arch, dict(width=args.width)
  elif arch.startswith('vgg'):
    model, mkw = 'vgg', dict(variant=arch)
  else:
    raise ValueError(f'unknown architecture {arch}')

  custom_map = {}
  if arch == 'resnet':
    from rigl_tpu_torch.models.resnet import ResNet
    custom_map.update(ResNet(depth=args.resnet_depth, device='meta')
                      .first_last_layer_map(args.prune_first_layer,
                                            args.prune_last_layer))
    if args.first_layer_sparsity > 0:
      custom_map['initial_conv/conv/kernel'] = args.first_layer_sparsity
    if args.last_layer_sparsity > 0:
      custom_map['final_dense/kernel'] = args.last_layer_sparsity

  mkw['dtype'] = torch.bfloat16
  return common.config_from_flags(
      args,
      model=model,
      model_kwargs=mkw,
      dataset='imagenet',
      lr_schedule='imagenet',
      custom_sparsity_map=custom_map,
      n_model_shards=args.n_model_shards,
  )


def build_trainer(argv: Optional[Sequence[str]] = None):
  """(Trainer, output_dir) of the command line `argv`."""
  from rigl_tpu_torch.train.trainer import Trainer
  args = build_parser().parse_args(argv)
  return Trainer(config_from_args(args), device=args.device), args.output_dir


def main(argv: Optional[Sequence[str]] = None):
  return common.run_and_report(*build_trainer(argv))


if __name__ == '__main__':
  main()
