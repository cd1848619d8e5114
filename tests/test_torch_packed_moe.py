"""Port parity: the packed Switch-MoE transformer of rigl_tpu_torch
(parallel/packed_ep.py, models/packed_moe.py, the expert-stacked branches
of transforms/packed_training.py, the MoE PackedLMTrainer, its checkpoints,
drop-free decoding and the driver) against the JAX package, near the size
of tests/test_packed_moe.py (d_ff 64, 2 heads, 4 experts, block (16, 16),
s = 0.5, f32; the trainer at d_model 64, the model alone at 32).  At
d_model 32 fc1 has two block-rows, and at init, where ln2's output has
zero mean over its features, their pooled signed gradients are exact
negatives: each of SNFS's first grow scores ties its partner, so the
last bit of float32 rounding picks the grown block (measured: one expert
of four grew the other block of a pair).  Four block-rows carry no such
tie.

Routing integers (src, flat_ec, kept, the one-hot dispatch), packings,
occupancies, repack permutations and drop/grow results must be equal;
gates and the aux loss agree within 1e-6 relative.  Logits agree within
1e-5 (summation order only), as tests/test_torch_packed_transformer.py
holds them; greedy tokens are equal.  Trainer states agree as
tests/test_torch_packed_lm.py holds them: losses within 1e-5 relative,
parameters, Adam's slots and SNFS's EMA grids within 5e-5 of each tensor's
largest JAX value (Adam divides float32 summation-order noise by
sqrt(nu)), at that file's learning rate 3e-3.  At tests/test_packed_moe.py's
1e-2 one embedding element of 2048 differed by 7.6e-5 of the largest
after 3 steps (measured): its gradients, about 1e-7, are mostly rounding
noise (its sqrt(nu) 4.5e-9, below Adam's eps), and Adam turns a 7% change
of them into 0.4% of a step of 1e-2.  JAX's packed matmul runs in
interpret mode on the CPU, as its own tests run it; the port runs its
plain versions.  The JAX variables and the JAX trainers' runs are shared
by module fixtures."""

import dataclasses

import flax.traverse_util as traverse
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rigl_tpu.drivers.packed_lm import synthetic_stream as jax_stream
from rigl_tpu.models import packed_moe as jmoe
from rigl_tpu.parallel import packed_ep as jep
from rigl_tpu.serve import decode as jdec
from rigl_tpu.train import packed_lm as jlm
from rigl_tpu.transforms import packed_training as jpt
from rigl_tpu_torch import convert
from rigl_tpu_torch.drivers import packed_lm as tdriver
from rigl_tpu_torch.models import packed_moe as tmoe
from rigl_tpu_torch.parallel import packed_ep as tep
from rigl_tpu_torch.serve import decode as tdec
from rigl_tpu_torch.train import packed_lm as tlm
from rigl_tpu_torch.transforms import packed_training as tpt
from torch_threads import one_thread  # noqa: F401


CFG = dict(vocab_size=64, num_layers=1, d_model=64, d_ff=64, num_heads=2,
           seq_len=16, sparsity=0.5, block=(16, 16), bm=32,
           learning_rate=3e-3, warmup_steps=2, batch_size=4,
           maskupdate_begin_step=0, maskupdate_end_step=100,
           maskupdate_frequency=3, drop_fraction=0.5, seed=3, n_experts=4,
           capacity_factor=2.0)
E = CFG['n_experts']
# The model as a module of its own: 2 layers, so the decode twin's cache
# and every layer's drop-free routing are held across layers.
MODEL_KW = dict(num_layers=2, d_model=32, d_ff=64, num_heads=2,
                vocab_size=CFG['vocab_size'], num_experts=E)
PACKED_KW = dict(sparsity=0.5, block=(16, 16), bm=16)
STEPS = 5      # RigL's updates at steps 0 and 3, SET's / SNFS's after 1 and 4
B, T, P, L = 2, 10, 4, 16
ROUTE_RTOL, LOGIT_ATOL, LOSS_RTOL, RTOL = 1e-6, 1e-5, 1e-5, 5e-5


def _t(a):
  return torch.tensor(np.asarray(a))


def _dotted(tree):
  return {'.'.join(p): np.asarray(v)
          for p, v in traverse.flatten_dict(tree).items()}


def _close(got, want, rtol, what):
  got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
  assert got.shape == want.shape, what
  err = np.abs(got - want).max(initial=0.0)
  assert err <= rtol * max(np.abs(want).max(initial=0.0), 1e-30), (what, err)


# ------------------------------------------------------------- routing ----
def _logits(case):
  rs = np.random.RandomState(case)
  if case == 2:
    # Perfect balance (aux 1): peaked logits, equal counts per expert.
    choice = np.tile(np.arange(E), 16 // E)
    return (np.eye(E)[choice] * 20.0).astype(np.float32), 16 // E
  logits = (rs.randn(24, 3) * 2.0).astype(np.float32)
  if case == 1:
    logits[::5, 1] = logits[::5, 2] = logits[::5].max(1) + 1.0   # exact ties
  return logits, 4


@pytest.mark.parametrize('case', [0, 1, 2])
def test_routing_matches_jax(case):
  """top1_dispatch and top1_gather_dispatch on the same logits, with
  capacity drops (cases 0 and 1; case 1 with exact ties, which the first
  expert wins) and at perfect balance (case 2, aux 1)."""
  logits, cap = _logits(case)
  jd, jc, jaux = jep.top1_dispatch(jnp.asarray(logits), cap)
  td, tc, taux = tep.top1_dispatch(_t(logits), cap)
  np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
  _close(tc.numpy(), np.asarray(jc), ROUTE_RTOL, 'combine')
  _close(float(taux), float(jaux), ROUTE_RTOL, 'aux')
  want = jep.top1_gather_dispatch(jnp.asarray(logits), cap)
  got = tep.top1_gather_dispatch(_t(logits), cap)
  for name, g, w in zip(('src', 'flat_ec', 'kept'), got[:3], want[:3]):
    np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)
  _close(got[3].numpy(), np.asarray(want[3]), ROUTE_RTOL, 'gate')
  _close(float(got[4]), float(want[4]), ROUTE_RTOL, 'gather aux')
  if case == 2:
    np.testing.assert_allclose(float(taux), 1.0, atol=1e-3)
  else:
    assert float(td.sum()) < len(logits), 'no token was dropped'


def test_gather_gradients_match_jax_onehot_oracle():
  """d(loss)/d(x) and d(loss)/d(router) through the port's gather form
  equal JAX's one-hot einsum form (tests/test_packed_moe.py's oracle)."""
  rs = np.random.RandomState(3)
  tt, ee, cc, d = 16, 4, 3, 8
  x0 = rs.randn(tt, d).astype(np.float32)
  lw = (rs.randn(d, ee) * 0.5).astype(np.float32)
  we = (rs.randn(ee, d, d) * 0.3).astype(np.float32)
  tgt = rs.randn(tt, d).astype(np.float32)

  def jax_loss(x, lw):
    dispatch, combine, aux = jep.top1_dispatch(x @ lw, cc)
    xe = jnp.einsum('td,tec->ecd', x, dispatch)
    ye = jnp.einsum('ecd,edf->ecf', xe, jnp.asarray(we))
    y = jnp.einsum('ecd,tec->td', ye, combine)
    return jnp.sum((y - jnp.asarray(tgt)) ** 2) + 0.1 * aux

  jl, (jgx, jgl) = jax.value_and_grad(jax_loss, argnums=(0, 1))(
      jnp.asarray(x0), jnp.asarray(lw))
  x, w = _t(x0).requires_grad_(), _t(lw).requires_grad_()
  src, flat_ec, kept, gate, aux = tep.top1_gather_dispatch(x @ w, cc)
  xe = torch.cat([x, x.new_zeros(1, d)])[src].reshape(ee, cc, d)
  ye = torch.bmm(xe, _t(we))
  y = torch.where(kept, gate, 0.0)[:, None] * ye.reshape(ee * cc, d)[flat_ec]
  loss = ((y - _t(tgt)) ** 2).sum() + 0.1 * aux
  gx, gl = torch.autograd.grad(loss, [x, w])
  assert not bool(kept.all()), 'no token was dropped'
  np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
  np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=1e-5,
                             atol=1e-6)
  np.testing.assert_allclose(gl.numpy(), np.asarray(jgl), rtol=1e-5,
                             atol=1e-6)


# ------------------------------------------------- expert-stacked store ----
def _expert_occ(seed, cap, nk=4, nn_=4):
  rs = np.random.RandomState(seed)
  occ = np.zeros((3, nk * nn_), np.int32)
  for e in range(3):
    occ[e, rs.choice(nk * nn_, cap, replace=False)] = 1
  return occ.reshape(3, nk, nn_), rs


def test_expert_packing_round_trip_matches_jax():
  occ, rs = _expert_occ(1, 7)
  jpk = jep.expert_packing_from_occ(jnp.asarray(occ), 7)
  tpk = tep.expert_packing_from_occ(_t(occ), 7)
  assert tep.is_expert_stacked(tpk) and not tep.is_expert_stacked(
      tpk.experts[0])
  assert tep.n_experts_of(tpk) == 3 and tep.cap_of(tpk) == 7
  for side in ('fwd', 'bwd'):
    for g, w in zip(tpk[side], jpk[side]):
      np.testing.assert_array_equal(g.numpy(), np.asarray(w), side)
  np.testing.assert_array_equal(tep.expert_occupancy_grid(tpk).numpy(), occ)
  assert tep.local_expert_packing(tpk, 1) is tpk.experts[1]
  w = rs.randn(3, 64, 64).astype(np.float32)
  packed = tep.pack_dense_experts(_t(w), tpk, (16, 16))
  np.testing.assert_array_equal(
      packed.numpy(), np.asarray(jep.pack_dense_experts(jnp.asarray(w), jpk,
                                                        (16, 16))))
  np.testing.assert_array_equal(
      tep.unpack_dense_experts(packed, tpk, (16, 16)).numpy(),
      w * np.kron(occ, np.ones((16, 16), np.float32)))
  moved = tpk.to('meta')
  assert tep.is_expert_stacked(moved) and moved is tpk.to('meta')
  assert moved.experts[2].fwd[0].device.type == 'meta'


def test_expert_drop_grow_matches_jax():
  """The same packed weights, occupancy and grow grids: equal occupancy,
  permutation, grown slots and packed values, counts kept per expert."""
  occ, rs = _expert_occ(2, 6)
  packed = rs.randn(3, 6, 16, 16).astype(np.float32)
  grids = np.abs(rs.randn(3, 4, 4)).astype(np.float32)
  want = jep.expert_drop_grow(jnp.asarray(packed),
                              jep.expert_packing_from_occ(jnp.asarray(occ), 6),
                              jnp.asarray(grids), jnp.float32(0.5))
  got = tep.expert_drop_grow(_t(packed), tep.expert_packing_from_occ(
      _t(occ), 6), _t(grids), 0.5)
  for name in ('occupancy', 'perm', 'grown', 'packed'):
    np.testing.assert_array_equal(getattr(got, name).numpy(),
                                  np.asarray(getattr(want, name)), name)
  np.testing.assert_array_equal(got.occupancy.sum((1, 2)).numpy(), [6] * 3)
  assert bool(got.grown.any()) and not bool(got.packed[got.grown].any())
  for g, w in zip(got.packing['fwd'], want.packing['fwd']):
    np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------------- model parity ----
@pytest.fixture(scope='module')
def model_pair():
  """JAX variables of MODEL_KW, the port's packed model holding them, and
  the tokens."""
  tokens = np.random.RandomState(0).randint(0, MODEL_KW['vocab_size'],
                                            (B, T)).astype(np.int32)
  jm = jmoe.PackedMoETransformer(capacity_factor=1.0, **MODEL_KW,
                                 **PACKED_KW)
  variables = jax.tree.map(np.asarray, jax.jit(jm.init)(
      jax.random.key(1), jnp.asarray(tokens)))
  tm = tmoe.PackedMoETransformer(capacity_factor=1.0, **MODEL_KW,
                                 **PACKED_KW, device='cpu')
  convert.load_converted(tm, *convert.from_jax_variables(variables))
  return variables, tm, tokens


def test_forward_matches_jax_and_dense_twin(model_pair):
  """At capacity factor 1.0 (tokens drop): logits and the summed aux equal
  JAX's; the dense twin holding the unpacked kernels gives the same."""
  variables, tm, tokens = model_pair
  jm = jmoe.PackedMoETransformer(capacity_factor=1.0, **MODEL_KW,
                                 **PACKED_KW)
  want, inter = jax.jit(lambda v, x: jm.apply(v, x, mutable=[
      'intermediates']))(variables, jnp.asarray(tokens))
  want_aux = sum(jax.tree.leaves(inter['intermediates']))
  assert isinstance(tm.block1.moe.fc2.packing, tep.ExpertPacking)
  with torch.no_grad():
    got, aux = tm(_t(tokens), with_aux=True)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                             atol=LOGIT_ATOL)
  _close(float(aux), float(want_aux), ROUTE_RTOL, 'aux')
  twin = tmoe.DenseMoETransformer(capacity_factor=1.0, **MODEL_KW,
                                  device='cpu')
  twin.load_state_dict(convert.dense_twin_state(tm), strict=True)
  with torch.no_grad():
    np.testing.assert_allclose(twin(_t(tokens)).numpy(), got.numpy(),
                               rtol=0, atol=LOGIT_ATOL)


def test_decode_is_drop_free_and_matches_jax(model_pair):
  """Teacher-forced KV-cache decoding of the capacity-1.0 model routes
  drop-free: its logits equal the model's full forward at capacity factor
  E (no drop), the port's and JAX's, and JAX's decode logits; greedy
  tokens equal JAX's."""
  variables, tm, tokens = model_pair
  jm = jmoe.PackedMoETransformer(capacity_factor=1.0, **MODEL_KW,
                                 **PACKED_KW)
  dm = jdec.decode_twin(jm, L)
  cache = jax.jit(dm.init)(jax.random.key(0),
                           jnp.zeros((B, 1), jnp.int32))['cache']
  step = jax.jit(lambda c, t: dm.apply(dict(variables, cache=c), t,
                                       mutable=['cache']))
  def jax_decode(feed):
    """Prefill P tokens, then T - P steps each fed feed(t, logits)."""
    logits, mut = step(cache, jnp.asarray(tokens[:, :P]))
    outs = [logits]
    for t in range(P, T):
      logits, mut = step(mut['cache'], feed(t, logits))
      outs.append(logits)
    return np.concatenate([np.asarray(o) for o in outs], axis=1)

  want = jax_decode(lambda t, _: jnp.asarray(tokens[:, t:t + 1]))
  greedy = jax_decode(lambda t, lg: jnp.argmax(lg[:, -1:], -1).astype(
      jnp.int32))

  tdm = tdec.decode_twin(tm, L)
  tcache = tdec.init_cache(tdm, B)
  with torch.inference_mode():
    got = torch.cat([tdm(_t(tokens[:, :P]), tcache)] + [
        tdm(_t(tokens[:, t:t + 1]), tcache) for t in range(P, T)], 1).numpy()
    dropped = tm(_t(tokens)).numpy()
  assert not tm.decode and tdm.decode
  np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)
  full = tmoe.PackedMoETransformer(capacity_factor=float(E), **MODEL_KW,
                                   **PACKED_KW, device='cpu')
  convert.load_converted(full, *convert.from_jax_variables(variables))
  with torch.inference_mode():
    np.testing.assert_allclose(got, full(_t(tokens)).numpy(), rtol=0,
                               atol=LOGIT_ATOL)
  assert np.abs(dropped - got).max() > 1e-3, 'capacity 1.0 dropped nothing'
  # JAX's greedy tokens: its decode twin fed its own argmax (what
  # serve.generate does at temperature 0), with the compiled step above.
  want_tok = greedy[:, P - 1:].argmax(-1)
  for kv_chunk in (0, 4):
    got_tok = tdec.generate(tdec.decode_twin(tm, L, kv_chunk),
                            _t(tokens[:, :P]), T - P + 1)
    np.testing.assert_array_equal(got_tok.numpy(), want_tok)


# ------------------------------------------------------------ training ----
def _jax_state(jtr):
  adam, sched = jtr.opt_state

  def occ(pk):
    return np.asarray(jep.expert_occupancy_grid(pk)
                      if jep.is_expert_stacked(pk) else jpt.occupancy_grid(pk))

  state = dict(params=_dotted(jtr.params), mu=_dotted(adam.mu),
               nu=_dotted(adam.nu), count=int(adam.count),
               schedule_count=int(sched.count), step=jtr.step,
               last_update_step=jtr.last_update_step,
               batches_seen=jtr.batches_seen,
               occupancy={'.'.join(p): occ(pk) for p, pk in
                          traverse.flatten_dict(jtr.packings).items()})
  if jtr.ema_grids is not None:
    state['ema'] = {'.'.join(p): np.asarray(v)
                    for p, v in jtr.ema_grids.items()}
  return state


def _assert_same_state(want, ttr, rtol, what):
  assert (ttr.step, ttr.last_update_step, ttr.batches_seen) == (
      want['step'], want['last_update_step'], want['batches_seen']), what
  assert ttr.opt_count == want['count'] == want['schedule_count'], what
  for name, pk in ttr.packings.items():
    occ = (tep.expert_occupancy_grid(pk) if tep.is_expert_stacked(pk)
           else tpt.occupancy_grid(pk))
    np.testing.assert_array_equal(occ.numpy(), want['occupancy'][name],
                                  f'{what}: occupancy {name}')
  mu, nu = ttr.adam_slots()
  params = ttr.params
  assert set(params) == set(want['params'])
  for name, p in params.items():
    _close(p.detach().numpy(), want['params'][name], rtol, f'{what}: {name}')
    _close(mu[name].numpy(), want['mu'][name], rtol, f'{what}: mu {name}')
    _close(nu[name].numpy(), want['nu'][name], rtol, f'{what}: nu {name}')
  if 'ema' in want:
    for name, g in ttr.ema_grids.items():
      _close(g.numpy(), want['ema'][name], rtol, f'{what}: ema {name}')


@pytest.fixture(scope='module')
def tokens():
  return jax_stream(4000, seed=2)


@pytest.fixture(scope='module')
def jax_variables():
  """The JAX trainer's variables, initialised once by a jitted model.init
  (what init_state runs eagerly)."""
  model = jlm.PackedLMTrainer(jlm.PackedLMConfig(**CFG)).model
  return jax.jit(model.init)(jax.random.key(CFG['seed']),
                             jnp.zeros((1, CFG['seq_len']), jnp.int32))


def _jax_trainer(variables, algo):
  """A JAX trainer in init_state's state, from the shared variables."""
  jtr = jlm.PackedLMTrainer(jlm.PackedLMConfig(**dict(CFG, algo=algo)))
  jtr.params, jtr.packings = variables['params'], variables['packing']
  jtr.opt_state = jtr.tx.init(jtr.params)
  if algo == 'snfs':
    jtr.ema_grids = jpt.init_snfs_ema_grids(jtr.packings)
  return jtr


@pytest.fixture(scope='module')
def jax_runs(jax_variables, tokens):
  """algo -> (trainer, states): a JAX trainer from the shared variables
  and its state after each of STEPS steps (index 0 the converted start),
  each with that run's result; the trainer is left at STEPS."""
  runs = {}

  def run(algo):
    if algo not in runs:
      jtr = _jax_trainer(jax_variables, algo)
      states = [(_jax_state(jtr), None)]
      for k in range(1, STEPS + 1):
        jtr.cfg.train_steps = k
        res = jtr.train(tokens)
        states.append((_jax_state(jtr), res))
      runs[algo] = (jtr, states)
    return runs[algo]

  return run


def _port(jtr, state):
  ttr = convert.packed_lm_trainer_from_jax(dataclasses.asdict(jtr.cfg),
                                           state, device='cpu')
  assert ttr.device.type == 'cpu'
  return ttr


@pytest.mark.parametrize('algo', ['rigl', 'snfs'])
def test_trainer_matches_jax_step_for_step(algo, jax_runs, tokens):
  """PackedLMTrainer(n_experts=4) converted from JAX's start and run
  beside it: per-step losses, counters, (E, nk, nn) occupancies,
  parameters, Adam's slots and (SNFS) the EMA grids, through RigL's
  updates at steps 0 and 3 and SNFS's after steps 1 and 4.  After each update
  every expert keeps its count, and its grown blocks hold zero weights
  and zero Adam slots."""
  jtr, states = jax_runs(algo)
  ttr = _port(jtr, states[0][0])
  _assert_same_state(states[0][0], ttr, 0.0, 'converted')
  grown = []
  mask_update = ttr.mask_update

  def checked_update(x, y):
    old = ttr.packings
    occ = mask_update(x, y)
    mu, nu = ttr.adam_slots()
    for name, pk in ttr.packings.items():
      if not tep.is_expert_stacked(pk):
        continue
      cap = ttr.params[name].shape[1]
      np.testing.assert_array_equal(occ[name].sum((1, 2)), [cap] * E)
      new = torch.stack([tpt.repack_permutation(o, n) < 0 for o, n in
                         zip(old[name].experts, pk.experts)])
      grown.append(int(new.sum()))
      for t in (ttr.params[name].detach(), mu[name], nu[name]):
        assert not t[new].any(), name
    return occ

  ttr.mask_update = checked_update
  for k in range(1, STEPS + 1):
    want, jres = states[k]
    ttr.cfg.train_steps = k
    tres = ttr.train(tokens)
    assert tres['mask_updates'] == jres['mask_updates'], k
    _close(tres['final_loss'], jres['final_loss'], LOSS_RTOL,
           f'step {k} loss')
    _assert_same_state(want, ttr, RTOL, f'step {k}')
  assert len(grown) >= 4 and sum(grown) > 0, grown
  assert tres['n_params_packed'] == jres['n_params_packed']


def test_checkpoints_cross_both_ways(jax_runs, jax_variables, tokens,
                                    tmp_path):
  """JAX's packed_lm_state.npz (SNFS, after STEPS steps) restores exactly
  into a new port trainer, which then steps as JAX does; the port's
  checkpoint of that state restores exactly into a new JAX trainer."""
  jtr, states = jax_runs('snfs')
  jtr.save(str(tmp_path / 'jax'))
  cfg = tlm.PackedLMConfig(**dict(CFG, algo='snfs'))
  ttr = tlm.PackedLMTrainer(cfg, device='cpu')
  assert ttr.restore(str(tmp_path / 'jax'))
  _assert_same_state(states[STEPS][0], ttr, 0.0, 'restored from JAX')
  ttr.cfg.train_steps = jtr.cfg.train_steps = STEPS + 1
  _close(ttr.train(tokens)['final_loss'], jtr.train(tokens)['final_loss'],
         LOSS_RTOL, 'the step after restoring')
  _assert_same_state(_jax_state(jtr), ttr, RTOL, 'the step after restoring')
  ttr.save(str(tmp_path / 'port'))
  reader = _jax_trainer(jax_variables, 'snfs')
  assert reader.restore(str(tmp_path / 'port'))
  assert all(jep.is_expert_stacked(pk) for p, pk in traverse.flatten_dict(
      reader.packings).items() if p[-2].startswith('fc'))
  _assert_same_state(_jax_state(reader), ttr, 0.0, 'restored into JAX')


def test_set_keeps_every_experts_count(tokens):
  """SET (the port's own draws): updates after steps 1 and 4 grow blocks
  in the experts and keep every expert's count."""
  tr = tlm.PackedLMTrainer(tlm.PackedLMConfig(**dict(
      CFG, algo='set', train_steps=STEPS)), device='cpu')
  tr.init_state()
  occ0 = {n: tep.expert_occupancy_grid(pk) for n, pk in tr.packings.items()
          if tep.is_expert_stacked(pk)}
  res = tr.train(tokens)
  assert res['mask_updates'] == 2 and np.isfinite(res['final_loss'])
  assert tr.ema_grids is None and len(occ0) == 2
  changed = 0
  for name, before in occ0.items():
    after = tep.expert_occupancy_grid(tr.packings[name])
    np.testing.assert_array_equal(after.sum((1, 2)).numpy(),
                                  before.sum((1, 2)).numpy())
    changed += int((after != before).any())
  assert changed, 'SET changed no expert mask'
  assert tpt.grow_grid_shapes(tr.packings)['block0.moe.fc1.kernel'] == (
      E, 4, 4)


def test_driver_trains_and_generates_moe_on_cpu(tmp_path):
  args = ['--device=cpu', '--n_experts=4', '--train_steps=4',
          '--num_layers=1', '--d_model=32', '--d_ff=64', '--num_heads=2',
          '--seq_len=16', '--batch_size=2', '--packed_bm=16',
          '--maskupdate_frequency=2', '--maskupdate_end_step=3',
          '--warmup_steps=2', '--log_every=2', '--capacity_factor=1.5',
          '--aux_loss_weight=0.02', '--generate_steps=3',
          '--generate_kv_chunk=8', f'--output_dir={tmp_path}']
  res = tdriver.main(args)
  assert res['train_steps'] == 4 and res['mask_updates'] == 2
  assert res['batches'] == 6                    # RigL: updates take batches
  assert len(res['generated_tokens']) == 3
  with np.load(tmp_path / 'packed_lm_state.npz') as z:
    assert z['occ_block0/moe/fc1/kernel'].shape == (4, 2, 4)
    shape = z['param_block0/moe/fc2/kernel'].shape
    assert shape[0] == 4 and shape[2:] == (16, 16)
