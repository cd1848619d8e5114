"""Shared flags of the trainer drivers, on argparse: the reference's flag
surface (mnist_train_eval.py, resnet_train_eval.py, imagenet_train_eval.py).

Counterpart of rigl_tpu/drivers/common.py, whose absl flags become
argument groups of one parser, with the same names and defaults (each
driver's own defaults included), plus --device (default cuda).
`config_from_flags(args, **overrides)` takes the parsed namespace where
JAX reads absl's global FLAGS.
"""

from __future__ import annotations

import argparse
import json
import os


def _bool(value) -> bool:
  """absl's boolean parsing: true / false, 1 / 0, yes / no."""
  if isinstance(value, bool):
    return value
  v = str(value).lower()
  if v in ('true', 't', '1', 'yes', 'y'):
    return True
  if v in ('false', 'f', '0', 'no', 'n'):
    return False
  raise argparse.ArgumentTypeError(f'not a boolean: {value!r}')


def add_bool(group, name: str, default: bool, help_: str = ''):
  """--name, --name=<bool> and --noname, as absl's DEFINE_bool takes."""
  group.add_argument(f'--{name}', nargs='?', const=True, default=default,
                     type=_bool, help=help_)
  group.add_argument(f'--no{name}', dest=name, action='store_false',
                     help=argparse.SUPPRESS)


def make_parser(description: str) -> argparse.ArgumentParser:
  p = argparse.ArgumentParser(description=description)
  p.add_argument('--device', default='cuda', help='torch device')
  return p


def define_common_flags(parser, default_method='rigl', default_sparsity=0.9,
                        default_steps=1000, default_batch=128,
                        default_frequency=100, default_end_step=25000,
                        default_anneal='constant', default_lr=0.1,
                        default_weight_decay=0.0,
                        default_label_smoothing=0.0):
  g = parser.add_argument_group('common')
  g.add_argument('--training_method', default=default_method,
                 help='rigl|set|static|momentum|snip|dnw|prune|scratch|none')
  g.add_argument('--end_sparsity', type=float, default=default_sparsity,
                 help='target sparsity')
  g.add_argument('--mask_init_method', default='erdos_renyi_kernel',
                 help='random|erdos_renyi|erdos_renyi_kernel|str')
  g.add_argument('--erk_power_scale', type=float, default=1.0,
                 help='ERK softening exponent')
  g.add_argument('--maskupdate_begin_step', type=int, default=0)
  g.add_argument('--maskupdate_end_step', type=int, default=default_end_step,
                 help='last mask-update step; must be > begin for '
                 'cosine/exponential anneals; -1 = forever (constant '
                 'anneal only)')
  g.add_argument('--maskupdate_frequency', type=int,
                 default=default_frequency)
  g.add_argument('--drop_fraction', type=float, default=0.3)
  g.add_argument('--drop_fraction_anneal', default=default_anneal,
                 help='constant|cosine|exponential_<p>')
  g.add_argument('--grow_init', default='zeros')
  g.add_argument('--initial_acc_scale', type=float, default=0.0)
  g.add_argument('--train_steps', type=int, default=default_steps)
  g.add_argument('--training_steps_multiplier', type=float, default=1.0,
                 help='extended training (5x-100x runs)')
  g.add_argument('--batch_size', type=int, default=default_batch)
  g.add_argument('--learning_rate', type=float, default=default_lr)
  g.add_argument('--momentum', type=float, default=0.9)
  g.add_argument('--weight_decay', type=float, default=default_weight_decay)
  g.add_argument('--label_smoothing', type=float,
                 default=default_label_smoothing)
  g.add_argument('--seed', type=int, default=0)
  g.add_argument('--data_dir', default=None,
                 help='raw dataset dir (synthetic if unset)')
  g.add_argument('--output_dir', default=None, help='checkpoints + metrics')
  g.add_argument('--log_every', type=int, default=100)
  g.add_argument('--eval_every', type=int, default=0)
  return g


def config_from_flags(args, **overrides):
  from rigl_tpu_torch.train.trainer import TrainConfig
  cfg = TrainConfig(
      training_method=args.training_method,
      sparsity=args.end_sparsity,
      mask_init_method=args.mask_init_method,
      erk_power_scale=args.erk_power_scale,
      maskupdate_begin_step=args.maskupdate_begin_step,
      maskupdate_end_step=args.maskupdate_end_step,
      maskupdate_frequency=args.maskupdate_frequency,
      drop_fraction=args.drop_fraction,
      drop_fraction_anneal=args.drop_fraction_anneal,
      grow_init=args.grow_init,
      initial_acc_scale=args.initial_acc_scale,
      train_steps=args.train_steps,
      training_steps_multiplier=args.training_steps_multiplier,
      batch_size=args.batch_size,
      base_learning_rate=args.learning_rate,
      momentum=args.momentum,
      weight_decay=args.weight_decay,
      label_smoothing=args.label_smoothing,
      seed=args.seed,
      data_dir=args.data_dir,
      checkpoint_dir=args.output_dir,
      log_every=args.log_every,
      eval_every=args.eval_every,
  )
  for k, v in overrides.items():
    setattr(cfg, k, v)
  return cfg


def run_and_report(trainer, output_dir=None):
  """Trains, prints metrics, dumps resolved config + results (the reference
  dumps its operative gin config, rigl_tf2/train.py:495-499)."""
  result = trainer.train(progress_fn=lambda m: print(m))
  print(json.dumps(result, indent=2))
  if output_dir:
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, 'config.json'), 'w') as f:
      f.write(trainer.config.to_json())
    with open(os.path.join(output_dir, 'results.json'), 'w') as f:
      json.dump(result, f, indent=2)
  return result


def define_block_flags(parser):
  """Block-granular sparsity flags (the reference reserved these at
  imagenet_train_eval.py:271-272)."""
  g = parser.add_argument_group('block')
  g.add_argument('--block_width', type=int, default=0,
                 help='mask block columns; 0=element')
  g.add_argument('--block_height', type=int, default=0,
                 help='mask block rows; 0=element')
  g.add_argument('--mask_type', default=None,
                 help='structured init: per_neuron|symmetric|'
                 'per_neuron_no_input_ablation|shuffled|random')
  add_bool(g, 'block_execution', False,
           'execute eligible convs through the block-skipping kernels '
           '(requires block_width/height)')
  add_bool(g, 'block_conv3x3', False,
           'extend block execution to spatial convs')
  return g


def define_surgery_flags(parser):
  """Cross-experiment checkpoint surgery flags (imagenet flags :256-261,
  rigl_tf2 mask shuffling)."""
  g = parser.add_argument_group('surgery')
  g.add_argument('--init_masks_from', default=None,
                 help='checkpoint dir to load masks (topology) from')
  g.add_argument('--init_params_from', default=None,
                 help='checkpoint dir to load params from (lottery-style)')
  add_bool(g, 'shuffle_loaded_masks', False,
           'shuffle loaded masks per layer (control experiment)')
  return g
