"""CIFAR-10 WideResNet driver: parity with
rigl/cifar_resnet/resnet_train_eval.py: WRN-22-2, momentum+nesterov, LR /5 at
30k/60k/90k, 250 epochs = 97656 steps (resnet_train_eval.py:62), weight decay
5e-4, all sparse methods.

Counterpart of rigl_tpu/drivers/cifar.py, with its flags and defaults on
argparse, plus --device (default cuda; --device=cpu runs on the CPU):

  python -m rigl_tpu_torch.drivers.cifar --training_method=rigl \\
      --end_sparsity=0.9
"""

from __future__ import annotations

from typing import Optional, Sequence

from rigl_tpu_torch.drivers import common


def build_parser():
  p = common.make_parser(__doc__.split('\n\n')[0])
  g = common.define_common_flags(
      p, default_method='rigl', default_sparsity=0.9, default_steps=97656,
      default_batch=128, default_frequency=100, default_end_step=75000,
      default_weight_decay=5e-4)
  g.add_argument('--resnet_depth', type=int, default=22,
                 help='WRN depth (6n+4)')
  g.add_argument('--resnet_width', type=int, default=2,
                 help='WRN width multiplier')
  return p


def build_trainer(argv: Optional[Sequence[str]] = None):
  """(Trainer, output_dir) of the command line `argv`."""
  from rigl_tpu_torch.train.trainer import Trainer
  args = build_parser().parse_args(argv)
  cfg = common.config_from_flags(
      args,
      model='wide_resnet',
      model_kwargs=dict(depth=args.resnet_depth, width=args.resnet_width),
      dataset='cifar10',
      lr_schedule='cifar',
  )
  return Trainer(cfg, device=args.device), args.output_dir


def main(argv: Optional[Sequence[str]] = None):
  return common.run_and_report(*build_trainer(argv))


if __name__ == '__main__':
  main()
