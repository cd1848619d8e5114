"""Packed block-sparse MLP driver: sparse training where the sparse layers'
weights, gradients and momentum all live as `(n_active, bk, bn)` packed
blocks (train/packed_loop.py), with RigL drop/grow ON packed storage.

Counterpart of rigl_tpu/drivers/packed_mlp.py, with the flags it reads and
their defaults, on argparse, plus --device (default cuda):

  python -m rigl_tpu_torch.drivers.packed_mlp --train_steps=2000 \\
      --end_sparsity=0.9 --data_dir=/data/mnist
  # synthetic MNIST-shaped data when --data_dir is unset; --device=cpu
  # runs the plain versions of the kernels

It prints progress lines and a JSON result; with --output_dir it resumes
from and writes a checkpoint (the JAX trainer's layout) and result.json.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import numpy as np


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
  p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  p.add_argument('--training_method', default='rigl',
                 help='rigl (drop/grow) or static (frozen topology)')
  p.add_argument('--end_sparsity', type=float, default=0.9)
  p.add_argument('--maskupdate_begin_step', type=int, default=0)
  p.add_argument('--maskupdate_end_step', type=int, default=1500,
                 help='last mask-update step; must be > begin for '
                 'cosine/exponential anneals; -1 = forever (constant only)')
  p.add_argument('--maskupdate_frequency', type=int, default=100)
  p.add_argument('--drop_fraction', type=float, default=0.3)
  p.add_argument('--drop_fraction_anneal', default='cosine',
                 help='constant|cosine|exponential_<p>')
  p.add_argument('--train_steps', type=int, default=2000)
  p.add_argument('--training_steps_multiplier', type=float, default=1.0)
  p.add_argument('--batch_size', type=int, default=100)
  p.add_argument('--learning_rate', type=float, default=0.05)
  p.add_argument('--momentum', type=float, default=0.9)
  p.add_argument('--seed', type=int, default=0)
  p.add_argument('--data_dir', default=None,
                 help='raw MNIST dir (synthetic if unset)')
  p.add_argument('--output_dir', default=None, help='checkpoint + result')
  p.add_argument('--log_every', type=int, default=100)
  p.add_argument('--widths', default='512,256',
                 help='comma-separated hidden widths (packed layers)')
  p.add_argument('--packed_block', default='16,16',
                 help='block (bk,bn) of packed storage')
  p.add_argument('--packed_via', default='auto',
                 help='kernel|dense_view|auto (PackedMLPConfig.resolve_via)')
  p.add_argument('--device', default='cuda', help='torch device')
  return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None):
  from rigl_tpu_torch.data import datasets as datasets_lib
  from rigl_tpu_torch.train.packed_loop import (PackedMLPConfig,
                                                PackedMLPTrainer)

  args = parse_args(argv)
  if args.training_method not in ('rigl', 'static'):
    raise ValueError('packed MLP driver supports rigl (drop/grow) or '
                     f'static (frozen topology); got {args.training_method!r}')

  train_ds, eval_ds, info = datasets_lib.create_dataset(
      'mnist', args.batch_size, data_dir=args.data_dir, seed=args.seed)
  xtr = train_ds.images.reshape(len(train_ds.images), -1)
  ytr = train_ds.labels
  xte = eval_ds.images.reshape(len(eval_ds.images), -1)
  yte = eval_ds.labels

  rigl = args.training_method == 'rigl'
  cfg = PackedMLPConfig(
      in_features=xtr.shape[-1],
      widths=tuple(int(w) for w in args.widths.split(',') if w),
      num_classes=info['num_classes'],
      sparsity=args.end_sparsity,
      block=tuple(int(b) for b in args.packed_block.split(',')),
      via=args.packed_via,
      learning_rate=args.learning_rate,
      momentum=args.momentum,
      train_steps=int(args.train_steps * args.training_steps_multiplier),
      batch_size=args.batch_size,
      maskupdate_begin_step=args.maskupdate_begin_step,
      maskupdate_end_step=args.maskupdate_end_step if rigl else 0,
      maskupdate_frequency=args.maskupdate_frequency,
      drop_fraction=args.drop_fraction,
      drop_fraction_anneal=args.drop_fraction_anneal if rigl else 'constant',
      seed=args.seed)

  trainer = PackedMLPTrainer(cfg, device=args.device)
  if args.output_dir and trainer.restore(args.output_dir):
    print(f'# resumed at step {trainer.step}')

  result = trainer.train((xtr, ytr), eval_xy=(xte, yte),
                         progress_fn=print, log_every=args.log_every)
  result['data_source'] = info['source']
  result['device'] = str(trainer.device)
  result['n_params_packed'] = int(sum(
      np.prod(trainer.params[n].shape) for n in trainer.packings))
  result['n_params_dense_equiv'] = int(sum(
      kin * kout for kin, kout in cfg.layer_dims().values()))

  if args.output_dir:
    trainer.save(args.output_dir)
    with open(os.path.join(args.output_dir, 'result.json'), 'w') as f:
      json.dump(result, f, indent=2)
  print(json.dumps(result, indent=2))
  return result


if __name__ == '__main__':
  main()
