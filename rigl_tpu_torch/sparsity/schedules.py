"""Mask-update gating and drop-fraction annealing schedules.

Counterpart of rigl_tpu/sparsity/schedules.py, with the same semantics
(the reference's rigl/sparse_optimizers_base.py:198-258 and
rigl_tf2/mask_updaters.py:271-344).  Gating is integer arithmetic on
Python ints.  The anneals are computed in float32 tensors, as JAX
computes them: a last-ulp difference in the drop fraction can flip the
truncation `int(n_ones * drop_fraction)` of the drop/grow update.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Callable, Optional

import torch


def extract_number(token: str) -> float:
  """'exponential_2.5' -> 2.5; no trailing number -> 1.0.

  Mirrors sparse_optimizers_base.py:45-59.
  """
  m = re.search(r'.*_(\d*\.?\d*)$', token)
  return float(m.group(1)) if m else 1.0


def _f32(value) -> torch.Tensor:
  return torch.as_tensor(value, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class UpdateSchedule:
  """When masks update and how much is dropped.

  Attributes:
    begin_step: first step at which mask updates may fire.
    end_step: last step (inclusive); negative means "update forever";
      zero means "never update" (rigl_tf2 convention, mask_updaters.py:278).
    frequency: minimum steps between updates.
    drop_fraction: initial fraction of surviving connections to drop.
    drop_fraction_anneal: 'constant' | 'cosine' | 'exponential_<p>' | 'lr'.
    lr_fn: required for 'lr' anneal: step -> learning rate; the drop fraction
      scales by lr(step)/lr(0).
  """
  begin_step: int = 0
  end_step: int = -1
  frequency: int = 100
  drop_fraction: float = 0.3
  drop_fraction_anneal: str = 'constant'
  lr_fn: Optional[Callable] = None

  def __post_init__(self):
    if self.drop_fraction_anneal == 'lr' and self.lr_fn is None:
      raise ValueError("'lr' anneal requires lr_fn")
    if (self.drop_fraction_anneal not in ('constant', 'cosine', 'lr')
        and not self.drop_fraction_anneal.startswith('exponential')):
      raise ValueError(
          'drop_fraction_anneal: %s is not valid' % self.drop_fraction_anneal)
    if (self.drop_fraction_anneal == 'cosine'
        or self.drop_fraction_anneal.startswith('exponential')):
      # These anneal over [begin, end]; with end_step <= begin_step the
      # cosine degenerates to drop_fraction == 0 and the exponential to
      # > initial, so fail loudly instead.
      if self.end_step <= self.begin_step:
        raise ValueError(
            f"drop_fraction_anneal={self.drop_fraction_anneal!r} needs "
            f"end_step > begin_step (got begin={self.begin_step}, "
            f"end={self.end_step}); use end_step > 0 or anneal='constant'")

  @property
  def initial_last_update_step(self) -> int:
    # -frequency so that last + frequency = 0 <= step enables a step-0 update
    # (sparse_optimizers_base.py:166-171).
    return -self.frequency

  def is_update_iter(self, step: int, last_update_step: int) -> bool:
    """Does a mask update fire at `step`?"""
    step, last = int(step), int(last_update_step)
    if self.end_step == 0:
      return False
    in_range = step >= self.begin_step
    if self.end_step >= 0:
      in_range = in_range and step <= self.end_step
    return in_range and last + self.frequency <= step

  def get_drop_fraction(self, step) -> torch.Tensor:
    """Annealed drop fraction at `step` (unconditionally; gate separately),
    a float32 scalar tensor."""
    step_f = _f32(step)
    init = _f32(self.drop_fraction)
    anneal = self.drop_fraction_anneal
    if anneal == 'constant':
      return init
    if anneal == 'cosine':
      # TF cosine_decay(initial, global_step, decay_steps=end-begin): the raw
      # global step is used (not step-begin), clipped at decay_steps
      # (sparse_optimizers_base.py:236-242).
      decay_steps = _f32(float(self.end_step - self.begin_step))
      t = torch.clamp(step_f, _f32(0.0), decay_steps) / decay_steps
      return init * _f32(0.5) * (_f32(1.0) + torch.cos(_f32(math.pi) * t))
    if anneal.startswith('exponential'):
      exponent = _f32(extract_number(anneal))
      power = ((step_f - _f32(self.begin_step))
               / _f32(self.end_step - self.begin_step))
      return init * (_f32(1.0) - power) ** exponent
    if anneal == 'lr':
      lr0 = _f32(self.lr_fn(0))
      return init * _f32(self.lr_fn(step)) / lr0
    raise ValueError(anneal)


# Convenience constructors mirroring the rigl_tf2 gin factories
# (mask_updaters.py:299-344).
def constant_schedule(begin_step: int, end_step: int, frequency: int,
                      drop_fraction: float) -> UpdateSchedule:
  return UpdateSchedule(begin_step, end_step, frequency, drop_fraction,
                        'constant')


def cosine_schedule(begin_step: int, end_step: int, frequency: int,
                    drop_fraction: float) -> UpdateSchedule:
  return UpdateSchedule(begin_step, end_step, frequency, drop_fraction,
                        'cosine')


def lr_schedule(begin_step: int, end_step: int, frequency: int,
                drop_fraction: float, lr_fn: Callable) -> UpdateSchedule:
  return UpdateSchedule(begin_step, end_step, frequency, drop_fraction, 'lr',
                        lr_fn)
