"""Checkpointing of the dense-masked TrainState: full save / restore and
mask surgery.

Counterpart of rigl_tpu/train/checkpoint.py, whose checkpoints are
orbax's.  Here a checkpoint is a directory <dir>/<step>/ holding one
`torch.save` file of a flat {key: CPU tensor, int or bool} dict, keyed by
the JAX TrainState's paths:

  params/<path>, batch_stats/<path>        the model's tensors;
  opt_state/<path>/<slot>                  the optimizer's tensors for
                                           that parameter (SGD's
                                           momentum_buffer; Adam's
                                           exp_avg, exp_avg_sq, step);
  sparse/masks/<path>, sparse/ema_grads/<path>,
  sparse/initial_weights/<path>            the SparseState's dicts;
  sparse/step, sparse/last_update_step, sparse/is_snipped.

The block packs are not saved: `restore` rebuilds them from the restored
masks when given the SparseTraining.  A save writes into a temporary
directory and renames it into place, so a reader polling the directory
never sees half a checkpoint.  Neither package restores the other's
checkpoints.  CheckpointManager keeps the interface of orbax's, which the
trainer and the eval loop call: every save is written at once, so
`save`'s `force` changes nothing and `close` has nothing to flush.

Parity targets:
  * periodic save / auto-resume        (TF Estimator model_dir behavior,
    rigl_tf2/train.py:304-313)
  * mask-only or params-only restore from a different experiment
    (imagenet_resnet/utils.py:93-125, flags :256-261)
  * pre/post-mask-update snapshots     (rigl_tf2/train.py:418-428)
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, Dict, List, Optional

import torch

from rigl_tpu_torch.train.train_state import TrainState

_FILE = 'state.pt'


def optimizer_slots(optimizer: torch.optim.Optimizer,
                    paths: List[str]) -> Dict[str, Dict[str, Any]]:
  """{path: the optimizer's state dict for that parameter}: the
  optimizer's parameters, in its groups' order, are `paths`' (every
  optimizer of the dense-masked path is built over the parameter dict's
  values, in order)."""
  flat = [t for g in optimizer.param_groups for t in g['params']]
  if len(flat) != len(paths):
    raise ValueError(f'the optimizer holds {len(flat)} parameters, the '
                     f'state {len(paths)}')
  return {p: optimizer.state[t] for p, t in zip(paths, flat)}


def state_arrays(state: TrainState) -> Dict[str, Any]:
  """The flat {key: CPU tensor, int or bool} dict a checkpoint holds."""
  out: Dict[str, Any] = {}
  for p, t in state.params.items():
    out[f'params/{p}'] = t.detach().cpu()
  for p, t in state.batch_stats.items():
    out[f'batch_stats/{p}'] = t.detach().cpu()
  for p, slots in optimizer_slots(state.optimizer,
                                  list(state.params)).items():
    for k, v in slots.items():
      if torch.is_tensor(v):
        out[f'opt_state/{p}/{k}'] = v.detach().cpu()
  sp = state.sparse
  for name in ('masks', 'ema_grads', 'initial_weights'):
    for p, t in (getattr(sp, name) or {}).items():
      out[f'sparse/{name}/{p}'] = t.detach().cpu()
  out['sparse/step'] = int(sp.step)
  out['sparse/last_update_step'] = int(sp.last_update_step)
  out['sparse/is_snipped'] = bool(sp.is_snipped)
  return out


class CheckpointManager:
  """Checkpoints keyed by optimizer step, the newest `max_to_keep` kept."""

  def __init__(self, directory: str, max_to_keep: int = 5):
    self.directory = os.path.abspath(directory)
    self.max_to_keep = max_to_keep
    os.makedirs(self.directory, exist_ok=True)

  def all_steps(self) -> List[int]:
    try:
      names = os.listdir(self.directory)
    except FileNotFoundError:
      return []
    return sorted(int(n) for n in names if n.isdigit() and os.path.isfile(
        os.path.join(self.directory, n, _FILE)))

  def save(self, step: int, state: TrainState, force: bool = False) -> bool:
    """Writes `state` as step `step`; False (and nothing written) where
    that step is already saved."""
    step = int(step)
    if step in self.all_steps():
      return False
    tmp = tempfile.mkdtemp(prefix=f'.tmp-{step}-', dir=self.directory)
    try:
      torch.save(state_arrays(state), os.path.join(tmp, _FILE))
      os.rename(tmp, os.path.join(self.directory, str(step)))
    except BaseException:
      shutil.rmtree(tmp, ignore_errors=True)
      raise
    for old in self.all_steps()[:-self.max_to_keep]:
      shutil.rmtree(os.path.join(self.directory, str(old)),
                    ignore_errors=True)
    return True

  def latest_step(self) -> Optional[int]:
    steps = self.all_steps()
    return steps[-1] if steps else None

  def restore(self, state: TrainState, step: Optional[int] = None,
              sparse_training=None) -> TrainState:
    """A new TrainState of `state`'s structure holding checkpoint `step`
    (the latest by default): its tensors are new, on the devices and in
    the dtypes of `state`'s, and its optimizer a new one of `state`'s
    class and hyperparameters over them.  With `sparse_training` the block
    packs are rebuilt from the restored masks (else None).  Raises
    FileNotFoundError without a checkpoint and KeyError where the
    checkpoint lacks one of `state`'s entries."""
    step = step if step is not None else self.latest_step()
    if step is None:
      raise FileNotFoundError(f'No checkpoint under {self.directory}')
    arrays = torch.load(os.path.join(self.directory, str(step), _FILE),
                        map_location='cpu', weights_only=True)

    def take(prefix, like):
      if like is None:
        return None
      return {p: arrays[f'{prefix}/{p}'].to(t.device, t.dtype)
              for p, t in like.items()}

    params = take('params', state.params)
    stats = take('batch_stats', state.batch_stats)
    opt = state.optimizer
    groups = []
    flat_paths = iter(params)
    for g in opt.param_groups:
      groups.append({**{k: v for k, v in g.items() if k != 'params'},
                     'params': [params[next(flat_paths)] for _ in
                                g['params']]})
    new_opt = type(opt)(groups, **opt.defaults)
    old_slots = optimizer_slots(opt, list(state.params))
    for p, slots in optimizer_slots(new_opt, list(params)).items():
      prefix = f'opt_state/{p}/'
      for key in (k for k in arrays if k.startswith(prefix)):
        v = arrays[key]
        name = key[len(prefix):]
        like = old_slots[p].get(name)
        if v.shape == params[p].shape:
          v = v.to(params[p].device, params[p].dtype)
        elif torch.is_tensor(like):
          v = v.to(like.device, like.dtype)
        slots[name] = v
    sp = state.sparse
    masks = take('sparse/masks', sp.masks)
    new_sparse = sp.replace(
        masks=masks, step=int(arrays['sparse/step']),
        last_update_step=int(arrays['sparse/last_update_step']),
        is_snipped=bool(arrays['sparse/is_snipped']),
        ema_grads=take('sparse/ema_grads', sp.ema_grads),
        initial_weights=take('sparse/initial_weights', sp.initial_weights),
        block_packs=(None if sparse_training is None
                     else sparse_training._compute_packs(masks)))
    return TrainState(params=params, batch_stats=stats, optimizer=new_opt,
                      sparse=new_sparse)

  def close(self):
    pass


def restore_masks_only(state: TrainState, other: TrainState) -> TrainState:
  """Takes masks (and mask bookkeeping, and the block packs built from
  them) from `other`, keeping params: the 'load a discovered topology,
  retrain from scratch' experiment (imagenet_resnet/utils.py mask-suffix
  restore)."""
  return state.replace(sparse=state.sparse.replace(
      masks=other.sparse.masks,
      last_update_step=other.sparse.last_update_step,
      is_snipped=other.sparse.is_snipped,
      block_packs=other.sparse.block_packs))


def restore_params_only(state: TrainState, other: TrainState) -> TrainState:
  """Takes params/batch_stats from `other`, keeping current masks: the
  'lottery ticket' style restore (params-suffix restore)."""
  return state.replace(params=other.params, batch_stats=other.batch_stats)


def shuffle_masks(key: int, masks: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
  """Per-layer random shuffle preserving layer sparsities: the
  reference's mask-shuffling control experiment (rigl_tf2/utils.py:
  126-128).  Layer i draws its permutation from a torch.Generator seeded
  from (key, i)."""
  from rigl_tpu_torch.transforms.sparse_training import _seed
  out = {}
  for i, (path, m) in enumerate(masks.items()):
    gen = torch.Generator().manual_seed(_seed(key, i))
    perm = torch.randperm(m.numel(), generator=gen).to(m.device)
    out[path] = m.reshape(-1)[perm].reshape(m.shape)
  return out
