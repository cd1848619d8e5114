"""Packed block-sparse CONV driver: image classification where every
packed conv's weights, gradients and momentum live as `(n_active, bk, bn)`
packed blocks (models/packed_convnet.py + train/packed_classifier.py),
with RigL, SET or SNFS drop/grow ON packed storage.

Counterpart of rigl_tpu/drivers/packed_conv.py, with the flags its `main`
reads and their defaults, on argparse, plus --device (default cuda).
Archs: mobilenet (dense depthwise + packed 1x1 stages from --conv_stages),
mbv1 (the full MobileNet-v1), wrn (WideResNet, packed 3x3 convs), rn50
(bottleneck ResNet).  Like JAX it has no engine flag, so the WRN's and
ResNet's 3x3 convs run the 'xla' engine (unpack, then a dense conv).
--conv_n_data / --conv_n_model are accepted at 1 only.

  python -m rigl_tpu_torch.drivers.packed_conv --dataset=cifar10 \\
      --arch=wrn --train_steps=2000 --data_dir=/data/cifar10
  # synthetic data of the dataset's shape when --data_dir is unset;
  # --device=cpu runs the plain versions of the kernels

For --dataset=cifar10 it trains on the raw uint8 training images and
evaluates on standardized ones, as the JAX driver does (data/datasets.py).
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
                 help='rigl | set | momentum (SNFS) | static')
  p.add_argument('--end_sparsity', type=float, default=0.8)
  p.add_argument('--mask_init_method', default='erdos_renyi_kernel',
                 help='random | erdos_renyi | erdos_renyi_kernel')
  p.add_argument('--erk_power_scale', type=float, default=1.0)
  p.add_argument('--maskupdate_begin_step', type=int, default=0)
  p.add_argument('--maskupdate_end_step', type=int, default=750)
  p.add_argument('--maskupdate_frequency', type=int, default=100)
  p.add_argument('--drop_fraction', type=float, default=0.3)
  p.add_argument('--drop_fraction_anneal', default='cosine',
                 help='constant|cosine|exponential_<p>')
  p.add_argument('--train_steps', type=int, default=1000)
  p.add_argument('--training_steps_multiplier', type=float, default=1.0)
  p.add_argument('--batch_size', type=int, default=100)
  p.add_argument('--learning_rate', type=float, default=0.05)
  p.add_argument('--seed', type=int, default=0)
  p.add_argument('--data_dir', default=None,
                 help='raw dataset dir (synthetic if unset)')
  p.add_argument('--output_dir', default=None, help='checkpoint + result')
  p.add_argument('--log_every', type=int, default=100)
  p.add_argument('--dataset', default='mnist', help='mnist|cifar10')
  p.add_argument('--arch', default='mobilenet',
                 help='mobilenet | mbv1 | wrn | rn50')
  p.add_argument('--wrn_depth', type=int, default=22)
  p.add_argument('--wrn_width', type=int, default=2)
  p.add_argument('--rn_depth', type=int, default=50)
  p.add_argument('--rn_width_mult', type=float, default=1.0)
  p.add_argument('--mbv1_width', type=float, default=1.0)
  p.add_argument('--stem_width', type=int, default=32)
  p.add_argument('--conv_stages', default='64:2,128:2,128:1',
                 help='comma-separated features:stride per packed stage')
  p.add_argument('--packed_block', default='16,16',
                 help='block (bk,bn) of packed storage')
  p.add_argument('--packed_bm', type=int, default=128)
  p.add_argument('--conv_n_data', type=int, default=1,
                 help='single-device value only')
  p.add_argument('--conv_n_model', type=int, default=1,
                 help='single-device value only')
  p.add_argument('--snfs_momentum', type=float, default=0.9)
  p.add_argument('--custom_sparsity_map', default=None,
                 help='JSON {layer_path: sparsity} kept out of the ERK solve')
  p.add_argument('--device', default='cuda', help='torch device')
  return p.parse_args(argv)


def build_models(args, block, num_classes, in_channels, device):
  """(packed model, dense twin on 'meta') of --arch, with the sparsity
  spec of --mask_init_method over the arch's layer shapes."""
  import torch
  from rigl_tpu_torch.models import packed_convnet as pc
  from rigl_tpu_torch.sparsity.layer_sparsity import spec_for_model
  custom = (json.loads(args.custom_sparsity_map)
            if args.custom_sparsity_map else None)

  def spec(shapes):
    return spec_for_model(shapes, args.mask_init_method, args.end_sparsity,
                          custom_sparsity_map=custom,
                          erk_power_scale=args.erk_power_scale)

  gen = torch.Generator().manual_seed(args.seed)
  common = dict(num_classes=num_classes, in_channels=in_channels)
  if args.arch == 'rn50':
    kw = dict(depth=args.rn_depth, width_mult=args.rn_width_mult, **common)
    model = pc.PackedResNet(
        sparsity=spec(pc.resnet_layer_shapes(args.rn_depth,
                                             args.rn_width_mult, block)),
        block=block, bm=args.packed_bm, generator=gen, device=device, **kw)
    twin = pc.DenseResNetTwin(block=block, device='meta', **kw)
  elif args.arch == 'mbv1':
    kw = dict(width_mult=args.mbv1_width, **common)
    model = pc.PackedMobileNetV1(
        sparsity=spec(pc.mbv1_layer_shapes(args.mbv1_width, block)),
        block=block, bm=args.packed_bm, generator=gen, device=device, **kw)
    twin = pc.DenseMobileNetV1Twin(block=block, device='meta', **kw)
  elif args.arch == 'wrn':
    kw = dict(depth=args.wrn_depth, width=args.wrn_width, **common)
    model = pc.PackedWideResNet(
        sparsity=spec(pc.wrn_layer_shapes(args.wrn_depth, args.wrn_width)),
        block=block, generator=gen, device=device, **kw)
    twin = pc.DenseWideResNetTwin(device='meta', **kw)
  elif args.arch == 'mobilenet':
    stages = tuple((int(f), int(s)) for f, s in
                   (part.split(':') for part in args.conv_stages.split(',')))
    kw = dict(stem_width=args.stem_width, stages=stages, **common)
    model = pc.PackedConvNet(
        sparsity=spec(pc.convnet_layer_shapes(args.stem_width, stages)),
        block=block, bm=args.packed_bm, generator=gen, device=device, **kw)
    twin = pc.DenseConvNet(device='meta', **kw)
  else:
    raise ValueError(f'unknown --arch {args.arch!r}')
  return model, twin


def main(argv: Optional[Sequence[str]] = None):
  from rigl_tpu_torch.data import datasets as datasets_lib
  from rigl_tpu_torch.train.packed_classifier import (PackedClassifierConfig,
                                                      PackedClassifierTrainer)

  args = parse_args(argv)
  if args.training_method not in ('rigl', 'static', 'set', 'momentum'):
    raise ValueError('packed conv driver supports rigl / set / momentum '
                     '(SNFS) drop/grow or static (frozen topology), got '
                     f'{args.training_method!r}')
  # 'momentum' is the reference's name for SNFS; static freezes the
  # topology through end_step=0 and rides the rigl code path.
  algo = {'rigl': 'rigl', 'static': 'rigl', 'set': 'set',
          'momentum': 'snfs'}[args.training_method]
  static = args.training_method == 'static'

  train_ds, eval_ds, info = datasets_lib.create_dataset(
      args.dataset, args.batch_size, data_dir=args.data_dir, seed=args.seed)
  cfg = PackedClassifierConfig(
      sparsity=args.end_sparsity, algo=algo,
      snfs_momentum=args.snfs_momentum,
      block=tuple(int(b) for b in args.packed_block.split(',')),
      learning_rate=args.learning_rate,
      train_steps=int(args.train_steps * args.training_steps_multiplier),
      batch_size=args.batch_size,
      maskupdate_begin_step=args.maskupdate_begin_step,
      maskupdate_end_step=0 if static else args.maskupdate_end_step,
      maskupdate_frequency=args.maskupdate_frequency,
      drop_fraction=args.drop_fraction,
      drop_fraction_anneal='constant' if static else args.drop_fraction_anneal,
      seed=args.seed, n_data=args.conv_n_data, n_model=args.conv_n_model)
  if (cfg.n_data, cfg.n_model) != (1, 1):
    raise NotImplementedError('--conv_n_data / --conv_n_model: only the '
                              'single-device value 1 is ported')
  model, twin = build_models(args, cfg.block, info['num_classes'],
                             info['shape'][-1], args.device)
  trainer = PackedClassifierTrainer(model, twin, cfg,
                                    input_shape=info['shape'])
  if args.output_dir and trainer.restore(args.output_dir):
    print(f'# resumed at step {trainer.step}')

  result = trainer.train(
      (np.asarray(train_ds.images), np.asarray(train_ds.labels)),
      eval_xy=(np.asarray(eval_ds.images), np.asarray(eval_ds.labels)),
      progress_fn=print, log_every=args.log_every)
  result.update(data_source=info['source'], dataset=args.dataset,
                sparsity_distribution=args.mask_init_method, algo=algo,
                device=str(trainer.device))

  if args.output_dir:
    trainer.save(args.output_dir)
    with open(os.path.join(args.output_dir, 'result.json'), 'w') as f:
      json.dump(result, f, indent=2)
  print(json.dumps(result, indent=2))
  return result


if __name__ == '__main__':
  main()
