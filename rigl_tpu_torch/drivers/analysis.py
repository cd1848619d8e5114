"""Research-harness driver, in PyTorch: Hessian spectrum / loss
interpolation / MetaInit over a training run of drivers/train.py.

Counterpart of rigl_tpu/drivers/analysis.py, its absl flags on argparse
with the same names and defaults, plus --device (default cuda).  The
modes reproduce the reference's analysis modes:
  * hessian      -- rigl_tf2/train.py:58-166 ('hessian' mode, hessian.gin):
                    spectrum of the loss Hessian restricted to active
                    (unmasked) coordinates, per checkpoint.
  * interpolate  -- rigl_tf2/interpolate.py:80-96 (interpolate.gin): loss
                    along the linear path between two checkpoints, range
                    [i_start, i_end] (reference default -0.2..1.2, 29 pts).
  * metainit     -- rigl_tf2/metainit.py:23-120: gradient-quotient
                    meta-loss minimized over per-tensor weight scales.

The run to analyze is an output dir of the port's drivers/train.py
(config.json and the port's checkpoints, train/checkpoint.py); pre /
post-mask-update snapshot subdirs (snapshot_mask_updates) are reachable by
pointing --run_dir at them with --config_from naming the parent run's
config.json.  The loss is the model's in eval mode (BatchNorm on the
restored statistics) on the run's first eval batch, repeated to
--batch_size.

  python -m rigl_tpu_torch.drivers.analysis \\
      --config=configs/lenet_hessian.json --run_dir=/tmp/lenet_rigl_run
  python -m rigl_tpu_torch.drivers.analysis --mode=interpolate \\
      --run_dir=/tmp/run --step_a=100 --step_b=200
"""

from __future__ import annotations

import argparse
import ast
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch


def build_parser(suppress_defaults: bool = False) -> argparse.ArgumentParser:
  """The driver's flags; with `suppress_defaults`, a namespace holds only
  the flags given on the command line."""
  p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])

  def add(name, default, type_=str, help_=''):
    p.add_argument(f'--{name}', type=type_,
                   default=argparse.SUPPRESS if suppress_defaults else default,
                   help=help_)

  def steps_list(value):
    return [s for s in str(value).split(',') if s]

  add('device', 'cuda', help_='torch device')
  add('config', None, help_='optional analysis preset JSON '
      '(configs/*_hessian.json etc.); keys mirror these flags; "_" keys '
      'are docs')
  add('mode', None, help_='hessian | interpolate | metainit')
  add('run_dir', None, help_='training run output dir (config.json + '
      'checkpoints)')
  add('config_from', None, help_="path to the run's config.json when "
      'run_dir points elsewhere (e.g. a pre_update/ snapshot dir)')
  add('ckpt_steps', [], steps_list, 'checkpoint steps to analyze '
      '(hessian), comma-separated; empty = all')
  add('batch_size', 0, int, "analysis batch size; 0 = the run's eval batch "
      '(reference hessian.gin uses the full train set)')
  add('lanczos_order', 0, int, '0 = exact dense Hessian (small models); '
      '>0 = stochastic Lanczos quadrature of this order')
  add('step_a', -1, int, 'interpolate: first checkpoint step')
  add('step_b', -1, int, 'interpolate: second checkpoint step')
  add('i_start', -0.2, float, 'interpolate.gin i_start')
  add('i_end', 1.2, float, 'interpolate.gin i_end')
  add('n_points', 29, int, 'interpolate.gin n_interpolation')
  add('metainit_steps', 100, int, 'metainit optimization steps')
  add('output', None, help_='results JSON path; default stdout')
  return p


def _load_trainer(run_dir: str, config_from=None, device='cuda'):
  from rigl_tpu_torch.train.trainer import TrainConfig, Trainer
  cfg_path = config_from or os.path.join(run_dir, 'config.json')
  with open(cfg_path) as f:
    raw = json.load(f)
  known = set(TrainConfig.__dataclass_fields__)
  raw = {k: v for k, v in raw.items() if k in known}
  for key in ('model_kwargs', 'custom_sparsity_map', 'block_routing'):
    if isinstance(raw.get(key), str):
      raw[key] = ast.literal_eval(raw[key])
  raw['checkpoint_dir'] = run_dir
  raw['auto_resume'] = False
  trainer = Trainer(TrainConfig(**raw), device=device)
  trainer.init_state()
  return trainer


def _analysis_batch(trainer, batch_size: int):
  batch = next(iter(trainer.eval_ds.epoch()))
  if batch_size and batch['image'].shape[0] != batch_size:
    reps = -(-batch_size // batch['image'].shape[0])
    batch = {k: np.concatenate([np.asarray(v)] * reps)[:batch_size]
             for k, v in batch.items()}
  return {k: torch.as_tensor(np.asarray(v)).to(trainer.device)
          for k, v in batch.items()}


def _loss_fn(trainer, batch):
  """loss(params, batch_stats) over a fixed batch at the given BatchNorm
  statistics, in eval mode; both dicts keyed by path."""
  from rigl_tpu_torch.sparsity import masks as masks_lib
  from rigl_tpu_torch.train import steps

  def loss(params, batch_stats):
    named = {masks_lib.torch_name(p): t
             for p, t in {**params, **batch_stats}.items()}
    logits = torch.func.functional_call(trainer.model, named,
                                        (batch['image'],), {'train': False})
    return steps.cross_entropy_loss(logits, batch['label'])

  return loss


def _manager(trainer):
  from rigl_tpu_torch.train.checkpoint import CheckpointManager
  return CheckpointManager(trainer.config.checkpoint_dir)


def run_hessian(trainer, ckpt_steps, batch_size, lanczos_order):
  from rigl_tpu_torch.analysis import hessian as hessian_lib
  mgr = _manager(trainer)
  steps_avail = mgr.all_steps()
  steps_to_do = ([int(s) for s in ckpt_steps] if ckpt_steps else steps_avail)
  batch = _analysis_batch(trainer, batch_size)
  results = []
  for step in steps_to_do:
    state = mgr.restore(trainer.state, step=step)
    loss = _loss_fn(trainer, batch)
    fn = lambda p: loss(p, state.batch_stats)  # noqa: E731
    if lanczos_order > 0:
      eigs, _ = hessian_lib.lanczos_spectrum(
          fn, state.params, state.sparse.masks, order=lanczos_order)
    else:
      eigs = hessian_lib.sparse_hessian_spectrum(
          fn, state.params, state.sparse.masks)
    eigs = np.asarray(eigs, np.float64)
    results.append({
        'step': step,
        'max_eig': float(eigs.max()),
        'min_eig': float(eigs.min()),
        'trace': float(eigs.sum()),
        'n_active': int(eigs.size),
        'eigs_head': [float(v) for v in np.sort(eigs)[::-1][:16]],
    })
  mgr.close()
  return {'mode': 'hessian', 'results': results}


def run_interpolate(trainer, step_a, step_b, i_start, i_end, n_points,
                    batch_size):
  from rigl_tpu_torch.analysis import interpolate as interp_lib
  from rigl_tpu_torch.sparsity import masks as masks_lib
  mgr = _manager(trainer)
  steps_avail = mgr.all_steps()
  if step_a < 0:
    step_a = steps_avail[0]
  if step_b < 0:
    step_b = steps_avail[-1]
  state_a = mgr.restore(trainer.state, step=step_a)
  state_b = mgr.restore(trainer.state, step=step_b)
  mgr.close()
  batch = _analysis_batch(trainer, batch_size)
  loss = _loss_fn(trainer, batch)
  eff_a = masks_lib.apply_masks(state_a.params, state_a.sparse.masks)
  eff_b = masks_lib.apply_masks(state_b.params, state_b.sparse.masks)
  ts = np.linspace(i_start, i_end, n_points)
  pts = interp_lib.interpolate_losses(
      lambda p: loss(p, state_a.batch_stats), eff_a, eff_b, ts=ts)
  return {'mode': 'interpolate', 'step_a': step_a, 'step_b': step_b,
          'points': pts}


def run_metainit(trainer, batch_size, steps):
  from rigl_tpu_torch.analysis import metainit as metainit_lib
  batch = _analysis_batch(trainer, batch_size)
  loss = _loss_fn(trainer, batch)
  state = trainer.state
  stats = {p: b.detach() for p, b in state.batch_stats.items()}
  _, history = metainit_lib.meta_init(
      lambda p: loss(p, stats), state.params, steps=steps)
  return {'mode': 'metainit',
          'gq_first': float(history[0]), 'gq_last': float(history[-1]),
          'n_steps': len(history)}


def parse_args(argv: Optional[Sequence[str]] = None):
  """The command line's namespace: the preset's values where the flag
  was not given."""
  parser = build_parser()
  args = parser.parse_args(argv)
  given = vars(build_parser(suppress_defaults=True).parse_args(argv))
  if args.config:
    with open(args.config) as f:
      preset = {k: v for k, v in json.load(f).items()
                if not k.startswith('_')}
    for key, value in preset.items():
      if not hasattr(args, key):
        raise ValueError(f'unknown preset key {key!r} in {args.config}')
      if key not in given:
        setattr(args, key, value)
  if not args.mode or not args.run_dir:
    parser.error('--mode and --run_dir are required (directly or via '
                 '--config)')
  return args


def main(argv: Optional[Sequence[str]] = None):
  args = parse_args(argv)
  trainer = _load_trainer(args.run_dir, args.config_from, args.device)
  if args.mode == 'hessian':
    result = run_hessian(trainer, args.ckpt_steps, args.batch_size,
                         args.lanczos_order)
  elif args.mode == 'interpolate':
    result = run_interpolate(trainer, args.step_a, args.step_b,
                             args.i_start, args.i_end, args.n_points,
                             args.batch_size)
  elif args.mode == 'metainit':
    result = run_metainit(trainer, args.batch_size, args.metainit_steps)
  else:
    raise ValueError(f'unknown mode {args.mode!r}')

  text = json.dumps(result, indent=2)
  print(text)
  if args.output:
    with open(args.output, 'w') as f:
      f.write(text)
  return result


if __name__ == '__main__':
  main()
