"""Generic config-driven trainer: the reference's gin workflow as JSON.

Counterpart of rigl_tpu/drivers/train.py, on argparse, plus --device
(default cuda; --device=cpu runs on the CPU):

  python -m rigl_tpu_torch.drivers.train --config=configs/lenet_rigl.json \\
      [--override train_steps=100] [--output_dir=/tmp/run]

The presets in configs/ load into the port's TrainConfig as into JAX's.
The resolved config is dumped next to the results, like the reference's
operative-config dump (rigl_tf2/train.py:495-499).
"""

from __future__ import annotations

import argparse
import ast
import json
from typing import Optional, Sequence

from rigl_tpu_torch.drivers import common


def build_parser() -> argparse.ArgumentParser:
  p = common.make_parser(__doc__.split('\n\n')[0])
  p.add_argument('--config', default=None,
                 help='path to a TrainConfig JSON preset (required)')
  p.add_argument('--override', action='append', default=[],
                 help='field=value overrides (value parsed as python '
                 'literal when possible); repeatable')
  p.add_argument('--output_dir', default=None)
  return p


def load_config(path: str, overrides=()):
  from rigl_tpu_torch.train.trainer import TrainConfig
  with open(path) as f:
    # Keys starting with '_' are documentation (_reference citation,
    # _usage notes), not TrainConfig fields.
    raw = {k: v for k, v in json.load(f).items() if not k.startswith('_')}
  for ov in overrides:
    key, _, value = ov.partition('=')
    try:
      raw[key] = ast.literal_eval(value)
    except (ValueError, SyntaxError):
      raw[key] = value
  return TrainConfig(**raw)


def build_trainer(argv: Optional[Sequence[str]] = None):
  """(Trainer, output_dir) of the command line `argv`."""
  from rigl_tpu_torch.train.trainer import Trainer
  parser = build_parser()
  args = parser.parse_args(argv)
  if not args.config:
    parser.error('--config is required')
  cfg = load_config(args.config, args.override)
  if args.output_dir:
    cfg.checkpoint_dir = args.output_dir
  return Trainer(cfg, device=args.device), args.output_dir


def main(argv: Optional[Sequence[str]] = None):
  return common.run_and_report(*build_trainer(argv))


if __name__ == '__main__':
  main()
