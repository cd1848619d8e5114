"""MNIST sparse-training driver: parity with rigl/mnist/mnist_train_eval.py:
300-100-10 MLP, per-layer custom sparsities {layer2: end*scale, layer3: 0},
staircase-decay momentum SGD, mask-record dumping.

Counterpart of rigl_tpu/drivers/mnist.py, with its flags and defaults on
argparse, plus --device (default cuda; --device=cpu runs on the CPU):

  python -m rigl_tpu_torch.drivers.mnist --training_method=rigl \\
      --end_sparsity=0.98
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from rigl_tpu_torch.drivers import common


def build_parser():
  p = common.make_parser(__doc__.split('\n\n')[0])
  g = common.define_common_flags(
      p, default_method='rigl', default_sparsity=0.98, default_steps=40000,
      default_batch=100, default_frequency=100, default_end_step=50000,
      default_anneal='cosine', default_lr=0.2)
  g.add_argument('--sparsity_scale', type=float, default=0.9,
                 help='layer2 sparsity = end_sparsity * scale '
                 '(mnist_train_eval.py:269-272)')
  common.add_bool(g, 'record_masks', False,
                  'dump mask snapshots to .npy (mnist_train_eval.py:410-415)')
  return p


def build_trainer(argv: Optional[Sequence[str]] = None):
  """(Trainer, parsed arguments) of the command line `argv`."""
  from rigl_tpu_torch.models.mlp import MnistMLP
  from rigl_tpu_torch.train.trainer import Trainer
  args = build_parser().parse_args(argv)
  cmap = MnistMLP(device='meta').custom_sparsity_map(args.end_sparsity,
                                                     args.sparsity_scale)
  cfg = common.config_from_flags(
      args, model='mnist_mlp', dataset='mnist',
      custom_sparsity_map=cmap,
      lr_schedule='mnist')
  return Trainer(cfg, device=args.device), args


def main(argv: Optional[Sequence[str]] = None):
  trainer, args = build_trainer(argv)

  mask_records = []
  if args.record_masks:
    orig_train = trainer.train

    def train_with_records(progress_fn=None, **kw):
      def record(m):
        if trainer.state is not None and trainer.state.sparse.masks:
          mask_records.append({
              k: v.detach().cpu().numpy()
              for k, v in trainer.state.sparse.masks.items()
          })
        (progress_fn or print)(m)

      return orig_train(progress_fn=record, **kw)

    trainer.train = train_with_records

  result = common.run_and_report(trainer, args.output_dir)
  if args.record_masks and args.output_dir:
    np.save(os.path.join(args.output_dir, 'mask_records.npy'),
            mask_records, allow_pickle=True)
  return result


if __name__ == '__main__':
  main()
