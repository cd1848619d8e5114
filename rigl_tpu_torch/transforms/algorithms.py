"""Sparse-training algorithm definitions.

Counterpart of rigl_tpu/transforms/algorithms.py, with the same frozen
configs: each says (a) how drop and grow scores are computed, (b) whether
the gradient step is skipped on mask-update iterations, and (c) how new
connections and their optimizer slots are initialized.  The state machine
is rigl_tpu_torch/transforms/sparse_training.py.

Score semantics (the reference's rigl/sparse_optimizers*.py):
  SET     - drop |m*w|+noise, grow uniform random
  RigL    - drop |m*w|+noise, grow |dense grad|; the gradient step is
            skipped on update iterations
  RigLInverted - grow -|dense grad|
  Static  - grow score is the mask itself; dropped-and-regrown connections
            are re-initialized
  SNFS/Momentum - grow |EMA(dense grad)| with per-step EMA updates
  SNIP    - one-shot saliency prune |g*w| at step 0
  DNW     - per-step re-mask by |w|, dense gradients applied to all weights
  GradualPruning - magnitude pruning on a polynomial-decay sparsity schedule
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from rigl_tpu_torch.sparsity.schedules import UpdateSchedule


@dataclasses.dataclass(frozen=True)
class Algorithm:
  """Base class: a no-op (dense or fixed-topology) algorithm."""
  name: str = 'none'
  schedule: Optional[UpdateSchedule] = None
  grow_init: str = 'zeros'
  noise_std: float = 1e-5
  # RigL semantics: replace the gradient step by the mask update on update
  # iterations (the reference's cond with apply_gradient_op as false branch).
  skip_apply_on_update: bool = False
  # Seed momentum of grown connections with scaled dense gradient
  # (sparse_optimizers_base.py:555-564); 0 = plain zero reset.
  initial_acc_scale: float = 0.0
  # Static algorithm re-inits connections that drop and immediately regrow.
  reinit_when_same: bool = False
  # Whether dense (unmasked) gradients are fed to the inner optimizer (DNW).
  dense_gradients: bool = False

  @property
  def needs_dense_grad_score(self) -> bool:
    return False

  @property
  def needs_ema(self) -> bool:
    return False

  @property
  def updates_masks(self) -> bool:
    return self.schedule is not None


@dataclasses.dataclass(frozen=True)
class SET(Algorithm):
  name: str = 'set'
  schedule: UpdateSchedule = dataclasses.field(default_factory=UpdateSchedule)


@dataclasses.dataclass(frozen=True)
class RigL(Algorithm):
  name: str = 'rigl'
  schedule: UpdateSchedule = dataclasses.field(default_factory=UpdateSchedule)
  skip_apply_on_update: bool = True

  @property
  def needs_dense_grad_score(self) -> bool:
    return True


@dataclasses.dataclass(frozen=True)
class RigLInverted(RigL):
  """Grows the *least* salient connections — a control from the GradFlow study."""
  name: str = 'rigl_inverted'


@dataclasses.dataclass(frozen=True)
class Static(Algorithm):
  name: str = 'static'
  schedule: UpdateSchedule = dataclasses.field(default_factory=UpdateSchedule)
  reinit_when_same: bool = True


@dataclasses.dataclass(frozen=True)
class SNFS(Algorithm):
  """Sparse Networks From Scratch / 'momentum' method (no redistribution)."""
  name: str = 'momentum'
  schedule: UpdateSchedule = dataclasses.field(default_factory=UpdateSchedule)
  momentum: float = 0.9  # EMA decay for the dense-gradient average

  @property
  def needs_dense_grad_score(self) -> bool:
    return True

  @property
  def needs_ema(self) -> bool:
    return True


@dataclasses.dataclass(frozen=True)
class SNIP(Algorithm):
  """One-shot saliency pruning at step 0; passthrough afterwards."""
  name: str = 'snip'
  schedule: Optional[UpdateSchedule] = None
  skip_apply_on_update: bool = True  # the snip step replaces the grad step

  @property
  def updates_masks(self) -> bool:
    return True


@dataclasses.dataclass(frozen=True)
class DNW(Algorithm):
  """Discovering Neural Wirings: dense grads + per-step top-|w| re-masking."""
  name: str = 'dnw'
  schedule: Optional[UpdateSchedule] = None
  dense_gradients: bool = True

  @property
  def updates_masks(self) -> bool:
    return True


@dataclasses.dataclass(frozen=True)
class GradualPruning(Algorithm):
  """Zhu & Gupta magnitude pruning with polynomial sparsity decay.

  sparsity(t) = final + (initial - final) * (1 - (t-begin)/(end-begin))**power
  clamped to [begin, end], applied every `schedule.frequency` steps.
  """
  name: str = 'prune'
  schedule: UpdateSchedule = dataclasses.field(default_factory=UpdateSchedule)
  initial_sparsity: float = 0.0
  power: int = 3

  @property
  def updates_masks(self) -> bool:
    return True


DENSE = Algorithm(name='none')
# 'scratch': fixed random topology, no updates, no reinit.
SCRATCH = Algorithm(name='scratch')


def get_algorithm(name: str, schedule: Optional[UpdateSchedule] = None,
                  **kwargs) -> Algorithm:
  """Factory mirroring the reference's training_method switch
  (imagenet_train_eval.py:333-475, rigl_tf2/mask_updaters.py:349-394)."""
  name = name.lower()
  table = {
      'set': SET,
      'rigl': RigL,
      'rigl_inverted': RigLInverted,
      'static': Static,
      'momentum': SNFS,
      'snfs': SNFS,
      'snip': SNIP,
      'dnw': DNW,
      'prune': GradualPruning,
  }
  if name in ('none', 'dense', 'baseline'):
    return Algorithm(name='none', **kwargs)
  if name == 'scratch':
    return Algorithm(name='scratch', **kwargs)
  if name not in table:
    raise ValueError(f'Unknown sparse training algorithm: {name}')
  cls = table[name]
  if schedule is not None and 'schedule' not in kwargs:
    kwargs['schedule'] = schedule
  return cls(**kwargs)
