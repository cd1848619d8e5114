"""The port's history entries (rigl_tpu_torch/ops/block_sparse.py,
block_sparse_v2.py, block_sparse_v6.py and block_sparse_v3.
pallas_dense_matmul) against the JAX package's on the CPU.

The same numpy-seeded inputs go through both; the JAX side runs its
Pallas kernels in interpret mode (the default off a TPU; it runs B11's
manual DMAs and semaphores too), the port its plain versions (CPU
tensors).  Index lists must be equal element for element.  Products and
gradients in float32 agree to 1e-5 of the output's largest value (both
sum the same blocks in f32, in another order), in bfloat16 to 2e-2 (one
rounding of the f32 sums, each side at its own points); an output block
with no active input is exactly zero on both sides.  The v6 MLP step
(scripts/bench_blocksparse_mlp.py's MLP_ENGINE=v6 arm at 3 x 128) runs
three SGD-momentum steps in both packages and holds weights and momentum
to the same tolerances, and the port's momentum exactly zero at inactive
blocks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rigl_tpu.ops.pallas import block_sparse as jv1
from rigl_tpu.ops.pallas import block_sparse_v2 as jv2
from rigl_tpu.ops.pallas import block_sparse_v3 as jv3
from rigl_tpu.ops.pallas import block_sparse_v6 as jv6
from rigl_tpu_torch.ops import block_sparse as tv1
from rigl_tpu_torch.ops import block_sparse_v2 as tv2
from rigl_tpu_torch.ops import block_sparse_v3 as tv3
from rigl_tpu_torch.ops import block_sparse_v6 as tv6
from torch_threads import one_thread  # noqa: F401


TOL = {'float32': 1e-5, 'bfloat16': 2e-2}
DTYPES = {'float32': (jnp.float32, torch.float32),
          'bfloat16': (jnp.bfloat16, torch.bfloat16)}


def _close(got, want, dtype='float32', msg=''):
  got = np.asarray(torch.as_tensor(got).detach().float())
  want = np.asarray(jnp.asarray(want, jnp.float32))
  assert got.shape == want.shape, (msg, got.shape, want.shape)
  scale = max(1.0, float(np.abs(want).max()))
  np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype] * scale,
                             err_msg=msg)


def _inputs(seed, m, k, n, dtype='float32'):
  rs = np.random.RandomState(seed)
  x = rs.randn(m, k).astype(np.float32)
  w = (rs.randn(k, n) / np.sqrt(k)).astype(np.float32)
  jdt, tdt = DTYPES[dtype]
  return (jnp.asarray(x, jdt), jnp.asarray(w, jdt),
          torch.tensor(x).to(tdt), torch.tensor(w).to(tdt), rs)


# ------------------------------------------------------------- B12 (v1) --
V1_CASES = [(32, 64, 128, (16, 64), 'random'),
            (48, 128, 128, (32, 32), 'random'),   # m no bm divides: JAX pads
            (32, 64, 64, (16, 32), 'random'),
            (16, 32, 64, (16, 32), 'off')]


@pytest.mark.parametrize('m,k,n,block,kind', V1_CASES)
def test_block_sparse_matmul_matches_jax(m, k, n, block, kind):
  """B12: forward, dx and the output-masked dw (zeros at inactive blocks)
  for one random cotangent, JAX's rows padded to bm = 16, the port's
  masked in place."""
  jx, jw, tx, tw, rs = _inputs(0, m, k, n)
  occ = (rs.rand(k // block[0], n // block[1]) > 0.5).astype(np.int32)
  if kind == 'off':
    occ[:] = 0
  ct = rs.randn(m, n).astype(np.float32)
  jy, vjp = jax.vjp(lambda x, w: jv1.block_sparse_matmul(
      x, w, jnp.asarray(occ), block, 16), jx, jw)
  jdx, jdw = vjp(jnp.asarray(ct))
  tx.requires_grad_()
  tw.requires_grad_()
  ty = tv1.block_sparse_matmul(tx, tw, torch.tensor(occ), block, 16)
  tdx, tdw = torch.autograd.grad(ty, (tx, tw), torch.tensor(ct))
  for got, want, what in ((ty, jy, 'y'), (tdx, jdx, 'dx'), (tdw, jdw, 'dw')):
    _close(got, want, msg=what)
  inactive = np.kron(1 - occ, np.ones(block, np.int32)).astype(bool)
  assert not tdw.detach().numpy()[inactive].any()
  if kind == 'off':
    assert not ty.detach().numpy().any()
  np.testing.assert_array_equal(
      tv1.dense_reference(tx.detach(), tw.detach(), torch.tensor(occ),
                          block).shape, (m, n))


def test_block_sparse_matmul_rejects_what_jax_rejects():
  x, w = torch.zeros(8, 48), torch.zeros(48, 64)
  with pytest.raises(ValueError, match='must divide block'):
    tv1.block_sparse_matmul(x, w, torch.ones(3, 2), (16, 48))
  with pytest.raises(ValueError, match='must divide block'):
    jv1.block_sparse_matmul(jnp.zeros((8, 48)), jnp.zeros((48, 64)),
                            jnp.ones((3, 2), jnp.int32), (16, 48), 8)


# ------------------------------------------------------------- B10 (v6) --
def _v6_occupancy(seed, nk, nn, sparsity):
  rs = np.random.RandomState(seed)
  occ = (rs.rand(nk, nn) >= sparsity).astype(np.int32)
  occ[0, 0] = 1
  occ[:, 2] = 0                       # force an empty output column
  return occ


@pytest.mark.parametrize('sparsity', [0.0, 0.5, 0.9])
def test_pack_columns_equals_jax(sparsity):
  occ = _v6_occupancy(3, 4, 6, sparsity)
  n_act = int(occ.sum())
  want = jv6.make_packing(jnp.asarray(occ), n_act)
  got = tv6.make_packing(torch.tensor(occ), n_act)
  for key in ('fwd', 'bwd'):
    for g, w in zip(got[key], want[key]):
      assert g.dtype == torch.int32
      np.testing.assert_array_equal(g.numpy(), np.asarray(w), key)


def test_pack_columns_shape_is_static_across_masks():
  occ1 = torch.tensor([[1, 0, 0], [0, 0, 1]])
  occ2 = torch.tensor([[0, 1, 0], [1, 0, 0]])   # the same count
  p1, p2 = tv6.pack_columns(occ1, 2), tv6.pack_columns(occ2, 2)
  assert p1[0].shape == p2[0].shape == (5,)
  assert int(p1[2].sum()) == int(p2[2].sum()) == 2


@pytest.mark.parametrize('sparsity,block', [(0.0, (32, 32)),
                                            (0.5, (32, 64)),
                                            (0.9, (32, 32))])
def test_v6_matmul_matches_jax(sparsity, block):
  """B10: forward and both gradients of sum(sin(y)) on premasked weights,
  with an empty output column (zero-filled by JAX's dummy entry, by an
  empty run here); bk != bn in one case, where a swap of dx's offsets
  would show."""
  m, k, n = 64, 128, 384
  bk, bn = block
  occ = _v6_occupancy(4, k // bk, n // bn, sparsity)
  n_act = int(occ.sum())
  jx, jw, tx, tw, _ = _inputs(5, m, k, n)
  mask = np.kron(occ, np.ones(block, np.int32)).astype(np.float32)
  jw, tw = jw * mask, tw * torch.tensor(mask)
  jpk = jv6.make_packing(jnp.asarray(occ), n_act)
  tpk = tv6.make_packing(torch.tensor(occ), n_act)

  def jloss(x, w):
    return jnp.sum(jnp.sin(jv6.block_sparse_matmul_v6(x, w, jpk, block, 32)))
  jy = jv6.block_sparse_matmul_v6(jx, jw, jpk, block, 32)
  jdx, jdw = jax.grad(jloss, (0, 1))(jx, jw)
  tx.requires_grad_()
  tw.requires_grad_()
  ty = tv6.block_sparse_matmul_v6(tx, tw, tpk, block, 32)
  tdx, tdw = torch.autograd.grad(torch.sin(ty).sum(), (tx, tw))
  for got, want, what in ((ty, jy, 'y'), (tdx, jdx, 'dx'), (tdw, jdw, 'dw')):
    _close(got, want, msg=what)
  assert not ty.detach()[:, 2 * bn:3 * bn].any()
  assert not tdw.numpy()[mask == 0].any()
  # A plain dict of JAX's lists gives the same result.
  plain = {key: tuple(torch.tensor(np.asarray(t)) for t in v)
           for key, v in jpk.items()}
  torch.testing.assert_close(
      tv6.block_sparse_matmul_v6(tx.detach(), tw.detach(), plain, block),
      ty.detach(), rtol=0, atol=0)


# ------------------------------------------------------------- B11 (v2) --
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_gather_matmul_matches_jax(dtype):
  """B11, forward only: JAX's interpret mode runs the kernel's manual
  DMAs; an empty output column is zero on both sides."""
  m, k, n, block = 32, 64, 96, (16, 32)
  jx, jw, tx, tw, rs = _inputs(6, m, k, n, dtype)
  occ = (rs.rand(k // block[0], n // block[1]) > 0.5).astype(np.int32)
  occ[:, 1] = 0
  want = jv2.block_sparse_matmul_gather(jx, jw, jnp.asarray(occ), block, 16)
  got = tv2.block_sparse_matmul_gather(tx, tw, torch.tensor(occ), block, 16)
  assert got.dtype == DTYPES[dtype][1]
  _close(got, want, dtype)
  assert not got[:, 32:64].any()
  counts, idx = tv2.pack_block_indices(torch.tensor(occ))
  jcounts, jidx = jv2.pack_block_indices(jnp.asarray(occ))
  np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
  np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


@pytest.mark.parametrize('m,k,n', [(24, 64, 96), (32, 40, 96), (32, 64, 80)])
def test_gather_matmul_rejects_what_jax_rejects(m, k, n):
  """m, K and N must divide bm = 16 and block (16, 32): ValueError in
  both packages."""
  occ = np.ones((max(k // 16, 1), max(n // 32, 1)), np.int32)
  with pytest.raises(ValueError, match='must divide tiles'):
    jv2.block_sparse_matmul_gather(jnp.zeros((m, k)), jnp.zeros((k, n)),
                                   jnp.asarray(occ), (16, 32), 16)
  with pytest.raises(ValueError, match='must divide'):
    tv2.block_sparse_matmul_gather(torch.zeros(m, k), torch.zeros(k, n),
                                   torch.tensor(occ), (16, 32), 16)


def test_forward_only_entries_refuse_backward():
  """B11 and B9' have no VJP in JAX; a backward through the port's
  entries raises NotImplementedError instead of giving no gradient."""
  x = torch.randn(16, 32, requires_grad=True)
  w = torch.randn(32, 32)
  for y in (tv2.block_sparse_matmul_gather(x, w, torch.ones(2, 1), (16, 32),
                                           16),
            tv3.pallas_dense_matmul(x, w, (16, 16, 16))):
    with pytest.raises(NotImplementedError, match='no VJP'):
      y.sum().backward()


# ------------------------------------------------------------- B9' (v3) --
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_pallas_dense_matmul_matches_jax(dtype):
  jx, jw, tx, tw, _ = _inputs(7, 32, 64, 96, dtype)
  want = jv3.pallas_dense_matmul(jx, jw, (16, 32, 32))
  got = tv3.pallas_dense_matmul(tx, tw, (16, 32, 32))
  assert got.dtype == DTYPES[dtype][1]
  _close(got, want, dtype)


def test_pallas_dense_matmul_refuses_tiles_that_do_not_divide():
  """JAX's grid drops the remainder and leaves the output's tail
  unwritten; the port raises."""
  for m, k, n in ((24, 64, 96), (32, 40, 96), (32, 64, 80)):
    with pytest.raises(ValueError, match='divide'):
      tv3.pallas_dense_matmul(torch.zeros(m, k), torch.zeros(k, n),
                              (16, 32, 32))


# ------------------------------------------------------ the v6 MLP step --
MLP_WIDTH, MLP_DEPTH, MLP_BATCH, MLP_BLOCK, MLP_STEPS = 128, 3, 64, (32, 32), 3
MLP_LR, MLP_MOMENTUM, MLP_SPARSITY = 0.1, 0.9, 0.5


def _mlp_setup(dtype):
  """x, premasked weights and occupancies of the 3 x 128 MLP."""
  rs = np.random.RandomState(8)
  nb = MLP_WIDTH // MLP_BLOCK[0]
  x = rs.randn(MLP_BATCH, MLP_WIDTH).astype(np.float32)
  occs, ws = [], []
  for _ in range(MLP_DEPTH):
    occ = (rs.rand(nb, nb) >= MLP_SPARSITY).astype(np.int32)
    occ[:, 1] = 0
    mask = np.kron(occ, np.ones(MLP_BLOCK, np.int32))
    occs.append(occ)
    ws.append((rs.randn(MLP_WIDTH, MLP_WIDTH) / np.sqrt(MLP_WIDTH)
               * mask).astype(np.float32))
  return x, ws, occs


@pytest.fixture(scope='module', params=['float32', 'bfloat16'])
def mlp_steps(request):
  """JAX's v6 train step (make_v6_train_scan's body, unrolled) for
  MLP_STEPS steps: (dtype, inputs, per-step weights and momenta)."""
  dtype = request.param
  jdt = DTYPES[dtype][0]
  x, ws, occs = _mlp_setup(dtype)
  packings = [jv6.make_packing(jnp.asarray(o), int(o.sum())) for o in occs]
  params = {f'd{i}': jnp.asarray(w, jdt) for i, w in enumerate(ws)}
  tx = optax.sgd(MLP_LR, momentum=MLP_MOMENTUM)
  opt_state = tx.init(params)

  def loss_fn(params, x):
    for i in range(MLP_DEPTH):
      x = jax.nn.relu(jv6.block_sparse_matmul_v6(
          x, params[f'd{i}'], packings[i], MLP_BLOCK, 32))
    return jnp.mean(x.astype(jnp.float32) ** 2)

  @jax.jit
  def step(params, opt_state, x):
    g = jax.grad(loss_fn)(params, x)
    updates, opt_state = tx.update(g, opt_state, params)
    return optax.apply_updates(params, updates), opt_state

  xj = jnp.asarray(x, jdt)
  trace = []
  for _ in range(MLP_STEPS):
    params, opt_state = step(params, opt_state, xj)
    trace.append(({k: np.asarray(v.astype(jnp.float32))
                   for k, v in params.items()},
                  {k: np.asarray(v.astype(jnp.float32))
                   for k, v in opt_state[0].trace.items()}))
  return dtype, (x, ws, occs), trace


def test_v6_mlp_train_steps_match_jax(mlp_steps):
  """The port's v6 step (block_sparse_matmul_v6 + torch.optim.SGD) from
  the same premasked weights: weights and momentum after each step within
  TOL of JAX's, momentum exactly zero at inactive blocks (the premask
  invariant of make_v6_train_scan)."""
  dtype, (x, ws, occs), trace = mlp_steps
  tdt = DTYPES[dtype][1]
  packings = [tv6.make_packing(torch.tensor(o), int(o.sum())) for o in occs]
  params = [torch.tensor(w).to(tdt).requires_grad_() for w in ws]
  opt = torch.optim.SGD(params, lr=MLP_LR, momentum=MLP_MOMENTUM)
  xt = torch.tensor(x).to(tdt)
  for t, (want_w, want_m) in enumerate(trace):
    opt.zero_grad(set_to_none=True)
    h = xt
    for i, w in enumerate(params):
      h = torch.relu(tv6.block_sparse_matmul_v6(h, w, packings[i],
                                                MLP_BLOCK, 32))
    (h.float() ** 2).mean().backward()
    opt.step()
    for i, w in enumerate(params):
      buf = opt.state[w]['momentum_buffer']
      _close(w, want_w[f'd{i}'], dtype, f'step {t} d{i} weights')
      _close(buf, want_m[f'd{i}'], dtype, f'step {t} d{i} momentum')
      inactive = np.kron(1 - occs[i], np.ones(MLP_BLOCK, np.int32)) > 0
      assert not buf.float().numpy()[inactive].any(), (t, i)
      assert not w.detach().float().numpy()[inactive].any(), (t, i)
