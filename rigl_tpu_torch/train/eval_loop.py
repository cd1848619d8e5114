"""Standalone evaluation loop: poll a checkpoint dir, evaluate new steps.

Counterpart of rigl_tpu/train/eval_loop.py, parity with the reference's
eval job (imagenet_train_eval.py:772-823: ``checkpoints_iterator``
polling, tolerating deleted checkpoints, eval_once mode), over the port's
checkpoints (train/checkpoint.py).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

from rigl_tpu_torch.train.checkpoint import CheckpointManager


def evaluate_checkpoints(
    trainer,
    checkpoint_dir: str,
    poll_seconds: float = 10.0,
    timeout_seconds: float = 3600.0,
    max_evals: Optional[int] = None,
    eval_once: bool = False,
    progress_fn: Optional[Callable[[Dict], None]] = None,
):
  """Evaluates every new checkpoint step appearing in `checkpoint_dir`
  with `trainer` (train/trainer.py) on its device.

  Returns the list of {step, metrics} results.  `eval_once` evaluates the
  latest checkpoint and returns.
  """
  mgr = CheckpointManager(checkpoint_dir)
  seen = set()
  results = []
  deadline = time.time() + timeout_seconds
  template = trainer.init_state() if trainer.state is None else trainer.state
  while time.time() < deadline:
    try:
      step = mgr.latest_step()
    except FileNotFoundError:
      step = None
    if step is not None and step not in seen:
      seen.add(step)
      try:
        state = mgr.restore(template, step)
      except Exception:
        # Checkpoint may have been garbage-collected mid-poll; skip it
        # (the reference tolerates deleted checkpoints the same way).
        continue
      metrics = trainer.evaluate(state)
      record = {'step': step, **metrics}
      results.append(record)
      if progress_fn:
        progress_fn(record)
      if eval_once or (max_evals and len(results) >= max_evals):
        break
      deadline = time.time() + timeout_seconds
    else:
      if eval_once and step is None:
        raise FileNotFoundError(f'no checkpoint under {checkpoint_dir}')
      time.sleep(poll_seconds)
  mgr.close()
  return results
