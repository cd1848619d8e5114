"""The port's SparseTraining (rigl_tpu_torch/transforms/sparse_training.py)
replays the reference's TF-executed trajectories, as
tests/test_golden_trajectories.py does for the JAX package.

tests/golden/trajectory_traces.npz holds ~300-step trajectories recorded
by executing the reference's sparse optimizers (RigL with cosine anneal
and with initial_acc_scale, SET, Static, SNFS momentum, SNIP, DNW,
wrapping tf.train.MomentumOptimizer) on a tiny 2-layer model.  The same
per-step dense gradients go through SparseTraining.step with
torch.optim.SGD(momentum=0.9); the reference's recorded stateless drop
noise and SET grow draws go in through the `_drop_noise` / `_grow_score`
seams.  Masks and step accounting must be exactly equal at every step.
Weights and momentum slots agree to 1e-6 relative to each tensor's
largest value plus 1e-7: torch's SGD computes p + (-lr) * buf with its own
rounding (a fused multiply-add on some paths) where the reference and
optax round the product first, a last-ulp difference per step that sums
over the trajectory.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

from rigl_tpu_torch.sparsity.schedules import UpdateSchedule
from rigl_tpu_torch.transforms import algorithms
from rigl_tpu_torch.transforms.sparse_training import (SparseState,
                                                       SparseTraining)
from torch_threads import one_thread  # noqa: F401


GOLDEN_DIR = os.path.join(os.path.dirname(__file__), 'golden')
NPZ = os.path.join(GOLDEN_DIR, 'trajectory_traces.npz')
META = os.path.join(GOLDEN_DIR, 'trajectory_traces_meta.json')

LAYERS = ('layer1', 'layer2')
PATHS = tuple(f'{l}/kernel' for l in LAYERS)
RTOL, ATOL = 1e-6, 1e-7


def _case_names():
  with open(META) as f:
    return [c['name'] for c in json.load(f)['cases']]


def load_case(name):
  z = np.load(NPZ)
  with open(META) as f:
    meta = {c['name']: c for c in json.load(f)['cases']}
  rec = {'gs': z[f'{name}/gs']}
  for i in range(len(LAYERS)):
    for key in ('w_init', 'm_init', 'dense_grads', 'masks', 'weights',
                'slots', 'drop_noise', 'grow_uniform', 'noise_gs'):
      arr_key = f'{name}/{key}_{i}'
      if arr_key in z:
        rec.setdefault(key, []).append(z[arr_key])
  if f'{name}/is_snipped' in z:
    rec['is_snipped'] = z[f'{name}/is_snipped']
  return meta[name], rec


class ReplayTraining(SparseTraining):
  """SparseTraining with the reference's recorded draws injected.
  current_noise / current_grow are {path: array}, set before each step."""

  current_noise = None
  current_grow = None

  def _drop_noise(self, step, layer_idx, path, mask, w):
    return torch.as_tensor(self.current_noise[path])

  def _grow_score(self, algo, path, mask, weights, dense_grad, ema_grad,
                  generator):
    if algo.name == 'set':
      return torch.as_tensor(self.current_grow[path])
    return super()._grow_score(algo, path, mask, weights, dense_grad,
                               ema_grad, generator)


def make_training(case):
  tx = functools.partial(torch.optim.SGD, lr=case.get('lr', 0.1),
                         momentum=case.get('momentum', 0.9))
  kind = case['kind']
  sp = case['sparsities']
  kwargs = {}
  sched = None
  if case.get('sched'):
    s = case['sched']
    sched = UpdateSchedule(s['begin'], s['end'], s['freq'],
                           s['drop_fraction'], s['anneal'])
  if kind == 'rigl' and case.get('initial_acc_scale'):
    kwargs['initial_acc_scale'] = case['initial_acc_scale']
  if kind == 'momentum':
    kwargs['momentum'] = case.get('ema_momentum', 0.9)
  algo = algorithms.get_algorithm(kind, schedule=sched, **kwargs)
  st = ReplayTraining(tx, algo, default_sparsity=float(sp[0]),
                      custom_sparsity_map={PATHS[1]: float(sp[1])})
  st.sparsities = {PATHS[0]: float(sp[0]), PATHS[1]: float(sp[1])}
  st.layer_shapes = {PATHS[0]: (12, 16), PATHS[1]: (16, 4)}
  return st


def noise_at(rec, key, t, gs):
  """The recorded draw of step t at global_step == gs."""
  out = {}
  for i, path in enumerate(PATHS):
    cands = rec['noise_gs'][i][t]
    j = int(np.nonzero(cands == gs)[0][0])
    out[path] = rec[key][i][t][j]
  return out


def _close(got, want, msg):
  want = np.asarray(want, np.float32)
  scale = float(np.abs(want).max()) if want.size else 0.0
  np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * scale + ATOL,
                             err_msg=msg)


@pytest.mark.parametrize('name', _case_names())
def test_trajectory_matches_reference(name):
  case, rec = load_case(name)
  st = make_training(case)
  algo = st.algo
  steps = int(case['steps'])

  params = {p: torch.tensor(w, dtype=torch.float32)
            for p, w in zip(PATHS, rec['w_init'])}
  masks = {p: torch.tensor(m, dtype=torch.float32)
           for p, m in zip(PATHS, rec['m_init'])}
  optimizer = st.tx(list(params.values()))
  ema = ({p: torch.zeros_like(masks[p]) for p in PATHS}
         if algo.needs_ema else None)
  sstate = SparseState(
      masks=masks, step=0,
      last_update_step=(algo.schedule.initial_last_update_step
                        if algo.schedule is not None else 0),
      is_snipped=False, ema_grads=ema)

  hints = st.predict_update_iters(steps)
  for t in range(steps):
    gs_rec = int(rec['gs'][t])
    st.current_noise = noise_at(rec, 'drop_noise', t, gs_rec)
    if algo.name == 'set':
      st.current_grow = noise_at(rec, 'grow_uniform', t, gs_rec)
    grads = {p: torch.tensor(g[t], dtype=torch.float32)
             for p, g in zip(PATHS, rec['dense_grads'])}
    params, optimizer, sstate, metrics = st.step(
        params, optimizer, sstate, grads, update_hint=hints[t])
    assert metrics.get('update_hint_ok', True), (name, t)
    assert sstate.step == gs_rec, (
        f'{name} step {t}: step accounting {sstate.step} != reference '
        f'global_step {gs_rec}')
    for i, path in enumerate(PATHS):
      np.testing.assert_array_equal(
          sstate.masks[path].numpy(), rec['masks'][i][t],
          err_msg=f'{name} step {t} mask {path}')
      w = params[path]
      _close(w.detach().numpy(), rec['weights'][i][t],
             f'{name} step {t} weights {path}')
      slot = optimizer.state[w].get('momentum_buffer')
      slot = (np.zeros_like(rec['slots'][i][t]) if slot is None
              else slot.numpy())
      _close(slot, rec['slots'][i][t], f'{name} step {t} momentum {path}')
  if 'is_snipped' in rec:
    assert sstate.is_snipped == bool(rec['is_snipped'][-1])
