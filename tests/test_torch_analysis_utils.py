"""The port's analysis harness (rigl_tpu_torch/analysis), its driver
(drivers/analysis.py) and the last utils (utils/flops.py, compression.py,
symmetry.py) against the JAX package's, on the CPU.

* Hessian: sparse_hessian and its spectrum on JAX's quadratic (exact:
  the active submatrix) and on a small masked tanh net with JAX's
  weights, against JAX's within HESS_TOL of the largest entry; Lanczos
  from the same numpy start vector gives JAX's Ritz values and weights
  within RITZ_TOL (the net's Hessian-vector products differ in the last
  float32 places, which 8 steps carry to 1e-5 of the largest value).
* interpolate_losses, gradient_quotient and meta_init's 5-step history
  against JAX's in float64 (JAX under enable_x64; GQ_RTOL, META_RTOL:
  in float32 the quotient's terms at gradients near 0 swing with the
  last places);
  the twins of tests/test_analysis.py.
* utils: count_model's integers (dense and sparse FLOPs, params, bytes,
  per_layer) equal JAX's on ResNet-50 dense and at ERK 0.8 and on
  MobileNetV1, get_stats equals JAX's on the MNIST MLP; compression and
  symmetry give JAX's outputs; the twins of tests/test_flops.py and
  tests/test_utils_extra.py's compression cases.
* drivers.analysis on a small LeNet-5 run of drivers.train in tmp_path:
  every mode, the preset files, Lanczos's extreme Ritz values inside the
  exact spectrum, the interpolation's ends equal to the checkpoints'
  losses.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from rigl_tpu import analysis as janalysis
from rigl_tpu.models import registry as jregistry
from rigl_tpu.sparsity import distributions as jdist
from rigl_tpu.sparsity import masks as jmasks
from rigl_tpu.utils import compression as jcomp
from rigl_tpu.utils import flops as jflops
from rigl_tpu.utils import symmetry as jsym
from rigl_tpu_torch import analysis as tanalysis
from rigl_tpu_torch.analysis.visualize import connection_counts
from rigl_tpu_torch.drivers import analysis as adriver
from rigl_tpu_torch.drivers import train as train_driver
from rigl_tpu_torch.models import registry as tregistry
from rigl_tpu_torch.sparsity import distributions as tdist
from rigl_tpu_torch.sparsity import masks as tmasks
from rigl_tpu_torch.utils import compression as tcomp
from rigl_tpu_torch.utils import flops as tflops
from rigl_tpu_torch.utils import symmetry as tsym
from torch_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HESS_TOL = 1e-5
RITZ_TOL = 1e-4
GQ_RTOL = 1e-9
# Five meta-steps move the scales by signSGD; the quotients at gradients
# near 0 carry float64's last places to 1e-8 of the history.
META_RTOL = 1e-6


# ---------------------------------------------------------------- hessian --
def _quadratic():
  n = 6
  rs = np.random.RandomState(0)
  a = rs.randn(n, n)
  a = a @ a.T + np.eye(n)
  mask = np.ones(n, np.float32)
  mask[[1, 4]] = 0.0
  w = rs.randn(n, 1).astype(np.float32)
  a32 = a.astype(np.float32)
  jax_case = ({'layer': {'kernel': jnp.asarray(w)}},
              {'layer/kernel': jnp.asarray(mask.reshape(n, 1))},
              lambda p: 0.5 * p['layer']['kernel'][:, 0] @ jnp.asarray(a32)
              @ p['layer']['kernel'][:, 0])
  port_case = ({'layer/kernel': torch.tensor(w)},
               {'layer/kernel': torch.tensor(mask.reshape(n, 1))},
               lambda p: 0.5 * p['layer/kernel'][:, 0] @ torch.tensor(a32)
               @ p['layer/kernel'][:, 0])
  active = np.flatnonzero(mask)
  return jax_case, port_case, a[np.ix_(active, active)]


def _small_net(dtype=np.float32):
  rs = np.random.RandomState(1)
  x = rs.randn(24, 6).astype(dtype)
  y = rs.randint(0, 3, 24)
  k1 = rs.randn(6, 5).astype(dtype)
  b1 = (0.1 * rs.randn(5)).astype(dtype)
  k2 = rs.randn(5, 3).astype(dtype)
  m1 = (rs.rand(6, 5) < 0.6).astype(np.float32)
  m2 = (rs.rand(5, 3) < 0.7).astype(np.float32)

  def jloss(p):
    h = jnp.tanh(x @ p['l1']['kernel'] + p['l1']['bias'])
    return optax.softmax_cross_entropy_with_integer_labels(
        h @ p['l2']['kernel'], y).mean()

  def tloss(p):
    h = torch.tanh(torch.tensor(x) @ p['l1/kernel'] + p['l1/bias'])
    return F.cross_entropy(h @ p['l2/kernel'], torch.tensor(y))

  jp = {'l1': {'kernel': jnp.asarray(k1), 'bias': jnp.asarray(b1)},
        'l2': {'kernel': jnp.asarray(k2)}}
  tp = {'l1/bias': torch.tensor(b1), 'l1/kernel': torch.tensor(k1),
        'l2/kernel': torch.tensor(k2)}
  jm = {'l1/kernel': jnp.asarray(m1), 'l2/kernel': jnp.asarray(m2)}
  tm = {'l1/kernel': torch.tensor(m1), 'l2/kernel': torch.tensor(m2)}
  return (jp, jm, jloss), (tp, tm, tloss)


def test_sparse_hessian_exact():
  (jp, jm, jl), (tp, tm, tl), a_active = _quadratic()
  h = tanalysis.sparse_hessian(tl, tp, tm).numpy()
  np.testing.assert_allclose(h, a_active, rtol=1e-5)
  np.testing.assert_array_equal(h, np.asarray(janalysis.sparse_hessian(
      jl, jp, jm)))


def test_sparse_hessian_spectrum():
  (jp, jm, jl), (tp, tm, tl), a_active = _quadratic()
  evals = tanalysis.sparse_hessian_spectrum(tl, tp, tm)
  np.testing.assert_allclose(evals, np.linalg.eigvalsh(a_active), rtol=1e-4)
  np.testing.assert_allclose(
      evals, janalysis.sparse_hessian_spectrum(jl, jp, jm), rtol=1e-6)


def test_lanczos_matches_exact_for_quadratic():
  (jp, jm, jl), (tp, tm, tl), a_active = _quadratic()
  ritz, weights = tanalysis.lanczos_spectrum(tl, tp, tm, order=4)
  np.testing.assert_allclose(np.sort(ritz), np.linalg.eigvalsh(a_active),
                             rtol=1e-3)
  assert weights.sum() == pytest.approx(1.0, abs=1e-6)
  jritz, jweights = janalysis.lanczos_spectrum(jl, jp, jm, order=4)
  np.testing.assert_allclose(ritz, jritz, rtol=RITZ_TOL)
  np.testing.assert_allclose(weights, jweights, atol=RITZ_TOL)


def test_hessian_and_lanczos_of_a_net_match_jax():
  (jp, jm, jl), (tp, tm, tl) = _small_net()
  jh = np.asarray(janalysis.sparse_hessian(jl, jp, jm))
  th = tanalysis.sparse_hessian(tl, tp, tm).numpy()
  assert th.shape == jh.shape == (int(sum(m.sum() for m in tm.values())),) * 2
  assert np.abs(th - jh).max() <= HESS_TOL * np.abs(jh).max()
  np.testing.assert_allclose(
      tanalysis.sparse_hessian_spectrum(tl, tp, tm),
      janalysis.sparse_hessian_spectrum(jl, jp, jm),
      atol=HESS_TOL * np.abs(jh).max())
  ritz, weights = tanalysis.lanczos_spectrum(tl, tp, tm, order=8, seed=3)
  jritz, jweights = janalysis.lanczos_spectrum(jl, jp, jm, order=8, seed=3)
  scale = np.abs(jritz).max()
  np.testing.assert_allclose(ritz, jritz, atol=RITZ_TOL * scale)
  np.testing.assert_allclose(weights, jweights, atol=RITZ_TOL)


# ------------------------------------------------- interpolate / metainit --
def test_interpolate_losses():
  out = tanalysis.interpolate_losses(
      lambda p: torch.sum((p['w'] - 2.0) ** 2), {'w': torch.zeros(3)},
      {'w': torch.full((3,), 4.0)}, ts=[0.0, 0.5, 1.0])
  assert [o['loss'] for o in out] == [12.0, 0.0, 12.0]
  assert out[1]['t'] == 0.5
  (jp, _, jl), (tp, _, tl) = _small_net()
  jq = jax.tree.map(lambda a: a * 0.5 + 0.1, jp)
  tq = {k: v * 0.5 + 0.1 for k, v in tp.items()}
  ts = np.linspace(-0.2, 1.2, 29)
  got = tanalysis.interpolate_losses(tl, tp, tq, ts=ts)
  want = janalysis.interpolate_losses(jl, jp, jq, ts=ts)
  for g, w in zip(got, want):
    assert g['t'] == w['t']
    assert g['loss'] == pytest.approx(w['loss'], rel=1e-6)


def test_gradient_quotient_matches_jax():
  # float64: the quotient divides Hg by g + eps sign(g), so where a
  # gradient is near 0 float32's last places swing its terms.
  with jax.enable_x64(True):
    (jp, _, jl), (tp, _, tl) = _small_net(np.float64)
    want = float(janalysis.gradient_quotient(jl, jp))
  assert float(tanalysis.gradient_quotient(tl, tp)) == pytest.approx(
      want, rel=GQ_RTOL)
  gq = tanalysis.gradient_quotient(
      lambda p: torch.sum(torch.tanh(p['w'] @ p['w'].T)),
      {'w': torch.ones((3, 3)) * 0.5})
  assert np.isfinite(float(gq))


def test_meta_init_history_matches_jax():
  rs = np.random.RandomState(0)
  x = rs.randn(16, 8)
  y = rs.randint(0, 2, 16)
  k1 = rs.randn(8, 8) * 3.0
  k2 = rs.randn(8, 2) * 3.0

  def jloss(p):
    h = jnp.tanh(x @ p['l1']['kernel'])
    return optax.softmax_cross_entropy_with_integer_labels(
        h @ p['l2']['kernel'], y).mean()

  def tloss(p):
    h = torch.tanh(torch.tensor(x) @ p['l1/kernel'])
    return F.cross_entropy(h @ p['l2/kernel'], torch.tensor(y))

  with jax.enable_x64(True):
    _, jhist = janalysis.meta_init(
        jloss, {'l1': {'kernel': jnp.asarray(k1)},
                'l2': {'kernel': jnp.asarray(k2)}}, steps=5, lr=0.05)
  params = {'l1/kernel': torch.tensor(k1), 'l2/kernel': torch.tensor(k2)}
  _, thist = tanalysis.meta_init(tloss, params, steps=5, lr=0.05)
  np.testing.assert_allclose(thist, jhist, rtol=META_RTOL)
  x, k1, k2 = (a.astype(np.float32) for a in (x, k1, k2))
  params = {'l1/kernel': torch.tensor(k1), 'l2/kernel': torch.tensor(k2)}
  # The twin of test_meta_init_reduces_gq: 20 steps lower the GQ and keep
  # directions.
  tuned, hist = tanalysis.meta_init(tloss, params, steps=20, lr=0.05)
  assert hist[-1] < hist[0]
  ratio = tuned['l1/kernel'].numpy() / k1
  assert np.allclose(ratio, ratio.flat[0], rtol=1e-5)
  masks = {'l1/kernel': torch.tensor((rs.rand(8, 8) < 0.5).astype(
      np.float32))}
  tuned, _ = tanalysis.meta_init(tloss, params, masks=masks, steps=2)
  assert bool((tuned['l1/kernel'][masks['l1/kernel'] == 0] == 0).all())


def test_visualize_connection_counts():
  mask = np.zeros((16, 4))
  mask[0, :] = 1
  img = connection_counts(torch.tensor(mask))
  assert img.shape == (4, 4)
  assert img[0, 0] == 4
  assert img.sum() == 4


# ------------------------------------------------------------------ utils --
def test_compression_matches_jax():
  m1 = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 0, 0]], np.float32)
  m2 = np.array([[1, 0], [0, 0], [0, 1]], np.float32)
  sparsities, sizes = tcomp.get_compressed_fc([torch.tensor(m1), m2])
  assert sizes == [3, 1, 1]
  assert sparsities[0] == pytest.approx(1.0 / 3.0)
  assert tcomp.live_input_indices(np.array([[0, 0], [1, 0]])).tolist() == [1]
  assert tcomp.compressed_fc_from_mask_dict(
      {'l1': torch.ones((4, 3)), 'l2': torch.ones((3, 2))}) == ([0.0, 0.0],
                                                                [4, 3, 2])
  rs = np.random.RandomState(2)
  masks = {f'l{i}': (rs.rand(a, b) < 0.3).astype(np.float32)
           for i, (a, b) in enumerate(((20, 12), (12, 9), (9, 4)))}
  assert tcomp.compressed_fc_from_mask_dict(
      {k: torch.tensor(v) for k, v in masks.items()}) == \
      jcomp.compressed_fc_from_mask_dict(masks)
  np.testing.assert_array_equal(tcomp.live_input_indices(masks['l0']),
                                jcomp.live_input_indices(masks['l0']))


def test_symmetry_matches_jax():
  rs = np.random.RandomState(3)
  masks = {'conv': (rs.rand(2, 2, 2, 6) < 0.5).astype(np.float32),
           'dense': (rs.rand(4, 10) < 0.4).astype(np.float32)}
  masks['dense'][:, 3] = 0.0
  masks['dense'][:, 5] = masks['dense'][:, 6]
  got = tsym.get_mask_stats({k: torch.tensor(v) for k, v in masks.items()})
  assert got == jsym.get_mask_stats(masks)
  assert got['total_zeroed_neurons'] >= 1
  assert tsym.count_permutations_mask_layer(masks['dense']) == \
      jsym.count_permutations_mask_layer(masks['dense'])


@pytest.fixture(scope='module')
def rn50():
  jmodel = jregistry.create_model('resnet', depth=50, num_classes=1000)
  tmodel = tregistry.create_model('resnet', data_shape=(224, 224, 3),
                                  depth=50, num_classes=1000, device='cpu')
  return jmodel, tmodel


def test_resnet50_count_matches_jax(rn50):
  jmodel, tmodel = rn50
  got = tflops.count_model(tmodel, (1, 224, 224, 3))
  assert got == jflops.count_model(jmodel, (1, 224, 224, 3))
  # Published: 8.2e9 (README.md:33) and 25.5M params (102.1MB).
  assert got['dense_flops'] == pytest.approx(8.2e9, rel=0.10)
  assert got['total_params'] == pytest.approx(25.5e6, rel=0.02)


def test_resnet50_erk80_count_matches_jax(rn50):
  jmodel, tmodel = rn50
  shapes = tmasks.mask_shapes(tmasks.param_dict(tmodel))
  sparsities = tdist.get_sparsities(shapes, 'erdos_renyi_kernel', 0.8, {})
  jvars = jax.eval_shape(lambda: jmodel.init(
      jax.random.key(0), jnp.zeros((1, 224, 224, 3)), train=False))
  jshapes = jmasks.mask_shapes(jvars['params'])
  assert jshapes == shapes
  assert sparsities == jdist.get_sparsities(jshapes, 'erdos_renyi_kernel',
                                            0.8, {})
  got = tflops.count_model(tmodel, (1, 224, 224, 3), sparsities)
  assert got == jflops.count_model(jmodel, (1, 224, 224, 3), sparsities)
  # Published 0.42x (README.md:65) and 23.68MB.
  assert got['flops_ratio'] == pytest.approx(0.42, abs=0.05)
  assert got['param_bytes'] / 1e6 == pytest.approx(23.68, rel=0.05)


def test_mobilenet_v1_count_matches_jax():
  got = tflops.count_model(tregistry.create_model(
      'mobilenet_v1', data_shape=(224, 224, 3), num_classes=1000,
      device='cpu'), (1, 224, 224, 3))
  assert got == jflops.count_model(jregistry.create_model(
      'mobilenet_v1', num_classes=1000), (1, 224, 224, 3))
  # Published 1.14e9 (README.md:53).
  assert got['dense_flops'] == pytest.approx(1.14e9, rel=0.10)


def test_get_stats_reference_api():
  tmodel = tregistry.create_model('mnist_mlp', data_shape=(28, 28, 1),
                                  device='cpu')
  jmodel = jregistry.create_model('mnist_mlp')
  for s in (0.9, 0.0):
    got = tflops.get_stats(tmodel, (1, 28, 28, 1), method='random',
                           default_sparsity=s)
    assert got == jflops.get_stats(jmodel, (1, 28, 28, 1), method='random',
                                   default_sparsity=s)
  total_flops, param_bits, sparsity = tflops.get_stats(
      tmodel, (1, 28, 28, 1), method='random', default_sparsity=0.9)
  dense_flops, dense_bits, s0 = tflops.get_stats(
      tmodel, (1, 28, 28, 1), method='random', default_sparsity=0.0)
  assert sparsity == pytest.approx(0.9, abs=0.01)
  assert s0 == 0.0
  assert total_flops < dense_flops * 0.2
  assert param_bits < dense_bits


# ----------------------------------------------------------------- driver --
@pytest.fixture(scope='module')
def lenet_run(tmp_path_factory):
  """A LeNet-5 RigL run of drivers.train (narrow, a few steps, three
  checkpoints)."""
  out = tmp_path_factory.mktemp('lenet_run')
  train_driver.main([
      '--device=cpu', f'--config={REPO}/configs/lenet_rigl.json',
      '--override=model_kwargs={"hidden_sizes": [2, 4, 12, 8]}',
      '--override=train_steps=6', '--override=batch_size=16',
      '--override=n_synthetic=64', '--override=log_every=0',
      '--override=maskupdate_frequency=3', '--override=checkpoint_every=3',
      f'--output_dir={out}'])
  return str(out)


def _analysis(run_dir, *argv):
  return adriver.main(['--device=cpu', f'--run_dir={run_dir}', *argv])


def test_analysis_driver_hessian(lenet_run):
  exact = _analysis(lenet_run, f'--config={REPO}/configs/lenet_hessian.json',
                    '--batch_size=40')
  lanczos = _analysis(lenet_run, '--mode=hessian', '--batch_size=40',
                      '--lanczos_order=8', '--ckpt_steps=6')
  steps = [r['step'] for r in exact['results']]
  assert steps == adriver._manager(adriver._load_trainer(
      lenet_run, device='cpu')).all_steps()
  last = next(r for r in exact['results'] if r['step'] == 6)
  ritz = lanczos['results'][0]
  slack = 1e-4 * max(abs(last['max_eig']), abs(last['min_eig']))
  assert last['min_eig'] - slack <= ritz['min_eig']
  assert ritz['max_eig'] <= last['max_eig'] + slack
  assert last['n_active'] > ritz['n_active'] == 8


def test_analysis_driver_interpolate_ends(lenet_run):
  res = _analysis(lenet_run, f'--config={REPO}/configs/lenet_interpolate.json',
                  '--batch_size=40')
  assert len(res['points']) == 29
  assert all(np.isfinite(p['loss']) for p in res['points'])
  trainer = adriver._load_trainer(lenet_run, device='cpu')
  batch = adriver._analysis_batch(trainer, 40)
  loss = adriver._loss_fn(trainer, batch)
  mgr = adriver._manager(trainer)
  by_t = {round(p['t'], 6): p['loss'] for p in res['points']}
  for t, step in ((0.0, res['step_a']), (1.0, res['step_b'])):
    state = mgr.restore(trainer.state, step=step)
    eff = tmasks.apply_masks(state.params, state.sparse.masks)
    with torch.no_grad():
      want = float(loss(eff, state.batch_stats))
    assert by_t[t] == pytest.approx(want, rel=1e-6), (t, step)


def test_analysis_driver_metainit_and_flags(lenet_run, tmp_path):
  out = tmp_path / 'mi.json'
  res = _analysis(lenet_run, '--mode=metainit', '--metainit_steps=3',
                  '--batch_size=16', f'--output={out}')
  assert res['n_steps'] == 3 and np.isfinite(res['gq_last'])
  assert json.loads(out.read_text()) == res
  args = adriver.parse_args([f'--config={REPO}/configs/lenet_hessian.json',
                             '--run_dir=/r', '--batch_size=8'])
  assert (args.mode, args.batch_size, args.ckpt_steps,
          args.lanczos_order) == ('hessian', 8, [], 0)
  with pytest.raises(SystemExit):
    adriver.parse_args(['--mode=hessian'])
