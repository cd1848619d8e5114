"""Port parity: transformer LM training on packed storage in rigl_tpu_torch
(train/packed_lm.py, the tree functions of transforms/packed_training.py,
the converter, checkpoints, generation and the driver) against the JAX
package's PackedLMTrainer, at the CFG of tests/test_packed_lm.py.

A JAX trainer is initialised and converted, then both run side by side on
the same seeded batches.  Counters and occupancies must be equal at every
step, so every mask update agrees.  Losses agree within 1e-5 relative
(measured: 1.3e-6 at worst).  Parameters, Adam's slots and SNFS's EMA
grids agree within 5e-5 of each tensor's largest JAX value: the gradients
differ by float32 summation order only (about 5e-7 of their largest
value), but Adam divides each by sqrt(nu), which lifts the error of small
gradient elements to the size of the learning rate's step; the LayerNorm
biases, which start at zero, show it most (measured: 1.7e-5 at worst over
the three algorithms' 45 steps).  SET's grow scores come from JAX's keys on
both sides (torch cannot give JAX's bits).  JAX's packed matmul runs in
interpret mode on the CPU, as its own tests run it; the port runs its
plain versions.  JAX's variables are initialised once, by a jitted
`model.init` (what `init_state` runs eagerly), and shared."""

import dataclasses

import flax.traverse_util as traverse
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rigl_tpu.drivers.packed_lm import synthetic_stream as jax_stream
from rigl_tpu.train import packed_lm as jlm
from rigl_tpu.transforms import packed_training as jpt
from rigl_tpu_torch import convert
from rigl_tpu_torch.drivers import packed_lm as tdriver
from rigl_tpu_torch.train import packed_lm as tlm
from rigl_tpu_torch.transforms import packed_training as tpt
from torch_threads import one_thread  # noqa: F401


CFG = dict(vocab_size=64, num_layers=1, d_model=64, d_ff=128, num_heads=4,
           seq_len=32, sparsity=0.5, block=(16, 16), bm=32,
           learning_rate=3e-3, warmup_steps=5, batch_size=4,
           maskupdate_begin_step=0, maskupdate_end_step=40,
           maskupdate_frequency=20, seed=0)
STEPS = 45
LOSS_RTOL, RTOL = 1e-5, 5e-5


def _dotted(tree):
  return {'.'.join(p): np.asarray(v)
          for p, v in traverse.flatten_dict(tree).items()}


def _jax_state(jtr):
  adam, sched = jtr.opt_state
  occ = {'.'.join(p): np.asarray(jpt.occupancy_grid(pk))
         for p, pk in traverse.flatten_dict(jtr.packings).items()}
  state = dict(params=_dotted(jtr.params), occupancy=occ,
               mu=_dotted(adam.mu), nu=_dotted(adam.nu),
               count=int(adam.count), schedule_count=int(sched.count),
               step=jtr.step, last_update_step=jtr.last_update_step,
               batches_seen=jtr.batches_seen)
  if jtr.ema_grids is not None:
    state['ema'] = {'.'.join(p): np.asarray(v)
                    for p, v in jtr.ema_grids.items()}
  return state


def _close(got, want, rtol, what):
  got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
  assert got.shape == want.shape, what
  err = np.abs(got - want).max(initial=0.0)
  assert err <= rtol * max(np.abs(want).max(initial=0.0), 1e-30), (what, err)


def _assert_same_state(jtr, ttr, rtol, what):
  want = _jax_state(jtr)
  assert (ttr.step, ttr.last_update_step, ttr.batches_seen) == (
      want['step'], want['last_update_step'], want['batches_seen']), what
  assert ttr.opt_count == want['count'] == want['schedule_count'], what
  for name, pk in ttr.packings.items():
    np.testing.assert_array_equal(tpt.occupancy_grid(pk).numpy(),
                                  want['occupancy'][name],
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
def variables():
  model = jlm.PackedLMTrainer(jlm.PackedLMConfig(**CFG)).model
  return jax.jit(model.init)(jax.random.key(CFG['seed']),
                             jnp.zeros((1, CFG['seq_len']), jnp.int32))


def _jax_trainer(variables, **over):
  """A JAX trainer in init_state's state, from the shared variables."""
  jtr = jlm.PackedLMTrainer(jlm.PackedLMConfig(**dict(CFG, **over)))
  jtr.params, jtr.packings = variables['params'], variables['packing']
  jtr.opt_state = jtr.tx.init(jtr.params)
  if jtr.cfg.algo == 'snfs':
    jtr.ema_grids = jpt.init_snfs_ema_grids(jtr.packings)
  return jtr


def _pair(variables, **over):
  jtr = _jax_trainer(variables, **over)
  ttr = convert.packed_lm_trainer_from_jax(
      dataclasses.asdict(jtr.cfg), _jax_state(jtr), device='cpu')
  assert ttr.device.type == 'cpu'
  return jtr, ttr


def _jax_set_grids(jtr, ttr):
  """The port's SET grow grids replaced by JAX's draws at the port's
  step (fold_in(key(seed), step), one fold per layer in path order)."""
  def grids(packings, generator=None):
    key = jax.random.fold_in(jax.random.key(jtr.cfg.seed), ttr.step)
    drawn = jpt.flax_set_grow_grids(jtr.packings, key)
    out = {'.'.join(p): torch.tensor(np.asarray(v)) for p, v in drawn.items()}
    assert set(out) == set(packings)
    return out
  return grids


@pytest.fixture(scope='module')
def tokens():
  return jax_stream(4000, seed=2)


@pytest.mark.parametrize('algo', ['rigl', 'set', 'snfs'])
def test_trainer_matches_jax_step_for_step(algo, variables, tokens,
                                          monkeypatch):
  """45 steps with mask updates at steps 0, 20 and 40 (RigL's replace a
  step) or after steps 1 and 21 (SET's and SNFS's follow one): per-step
  losses, counters, occupancies, parameters, Adam's slots and (SNFS) the
  EMA grids.  Right after each update every kernel keeps its active
  count, and its grown blocks hold zero weights and zero Adam slots."""
  jtr, ttr = _pair(variables, algo=algo)
  if algo == 'set':
    monkeypatch.setattr(tpt, 'flax_set_grow_grids', _jax_set_grids(jtr, ttr))
  _assert_same_state(jtr, ttr, 0.0, 'converted')
  grown = []
  mask_update = ttr.mask_update

  def checked_update(x, y):
    old = ttr.packings
    occ = mask_update(x, y)
    mu, nu = ttr.adam_slots()
    n_grown = 0
    for name, pk in ttr.packings.items():
      assert occ[name].sum() == ttr.params[name].shape[0], name
      new = tpt.repack_permutation(old[name], pk) < 0
      n_grown += int(new.sum())
      for t in (ttr.params[name].detach(), mu[name], nu[name]):
        assert not t[new].any(), name
    grown.append(n_grown)
    return occ

  ttr.mask_update = checked_update
  for k in range(1, STEPS + 1):
    jtr.cfg.train_steps = ttr.cfg.train_steps = k
    jres, tres = jtr.train(tokens), ttr.train(tokens)
    assert tres['mask_updates'] == jres['mask_updates'], k
    _close(tres['final_loss'], jres['final_loss'], LOSS_RTOL,
           f'step {k} loss')
    _assert_same_state(jtr, ttr, RTOL, f'step {k}')
  assert len(grown) >= 2 and sum(grown) > 0, grown
  _close(ttr.evaluate(tokens[-1000:]), jtr.evaluate(tokens[-1000:]),
         LOSS_RTOL, 'evaluate')


def test_train_chunk_equals_per_step(tokens):
  """steps_per_loop > 1 (train_chunk, broken at update iterations) is
  bit-equal to the per-step loop: the same batches, updates and params."""
  a, b = (tlm.PackedLMTrainer(tlm.PackedLMConfig(train_steps=24, **CFG),
                              device='cpu') for _ in range(2))
  res_a, res_b = a.train(tokens), b.train(tokens, steps_per_loop=8)
  assert res_a['mask_updates'] == res_b['mask_updates'] == 2
  assert res_a['batches'] == res_b['batches'] == 26
  for name, p in a.params.items():
    np.testing.assert_array_equal(p.detach().numpy(),
                                  b.params[name].detach().numpy(), name)
  assert res_a['final_loss'] == res_b['final_loss']


def test_generate_matches_jax(variables, tokens):
  """Greedy tokens from a trained state, with and without kv_chunk (the
  cache length rounds up to a multiple of the chunk), equal JAX's."""
  jtr, ttr = _pair(variables, train_steps=8)
  jtr.train(tokens)
  ttr.train(tokens)
  prompt = np.asarray(tokens[:2 * 9].reshape(2, 9), np.int32)
  want = jtr.generate(prompt, 6)
  assert want.shape == (2, 6)
  for kv_chunk in (0, 4, 8):
    np.testing.assert_array_equal(ttr.generate(prompt, 6, kv_chunk=kv_chunk),
                                  want, f'kv_chunk={kv_chunk}')
  np.testing.assert_array_equal(jtr.generate(prompt, 6, kv_chunk=8), want)


@pytest.mark.parametrize('direction', ['jax_to_port', 'port_to_jax'])
def test_checkpoint_round_trip(direction, variables, tokens, tmp_path):
  """packed_lm_state.npz written by one package after 22 steps (updates at
  0 and 20) restores exactly into the other, which then trains on as the
  writer does."""
  jtr, ttr = _pair(variables, train_steps=22, algo='snfs')
  jtr.train(tokens)
  ttr.train(tokens)
  _assert_same_state(jtr, ttr, RTOL, 'before the checkpoint')
  if direction == 'jax_to_port':
    jtr.save(str(tmp_path))
    writer, reader = jtr, tlm.PackedLMTrainer(
        tlm.PackedLMConfig(**dict(CFG, algo='snfs')), device='cpu')
    assert reader.restore(str(tmp_path))
    _assert_same_state(writer, reader, 0.0, 'restored')
    jtr, ttr = writer, reader
  else:
    ttr.save(str(tmp_path))
    reader = _jax_trainer(variables, algo='snfs')
    assert reader.restore(str(tmp_path))
    _assert_same_state(reader, ttr, 0.0, 'restored')
    jtr = reader
  for k in (23, 24):
    jtr.cfg.train_steps = ttr.cfg.train_steps = k
    _close(ttr.train(tokens)['final_loss'], jtr.train(tokens)['final_loss'],
           LOSS_RTOL, f'step {k} loss')
    _assert_same_state(jtr, ttr, RTOL, f'step {k}')
  assert not tlm.PackedLMTrainer(tlm.PackedLMConfig(**CFG),
                                 device='cpu').restore(str(tmp_path / 'no'))


def test_config_checks_and_dense_twin_params():
  cfg = tlm.PackedLMConfig(**CFG)
  for over, err in ((dict(algo='prune'), ValueError),
                    (dict(block=(24, 16)), ValueError),
                    (dict(dtype='float16'), ValueError),
                    (dict(n_model=2), NotImplementedError),
                    (dict(n_expert=2), NotImplementedError),
                    (dict(n_experts=4, n_model=2), ValueError),
                    (dict(n_seq=2), NotImplementedError)):
    with pytest.raises(err):
      tlm.PackedLMTrainer(dataclasses.replace(cfg, **over), device='cpu')
  tr = tlm.PackedLMTrainer(cfg, device='cpu')
  tr.init_state()
  twin = tlm.dense_twin_params(tr.params, tr.packings, cfg.block)
  assert twin['block0.attn.qkv.d.kernel'].shape == (64, 192)
  assert 'block0.attn.qkv.kernel' not in twin
  assert twin['embed.embedding'] is tr.params['embed.embedding']
  assert tlm.PackedLMTrainer(cfg).device.type == 'cuda'


def test_synthetic_stream_and_driver(tmp_path, capsys):
  np.testing.assert_array_equal(tdriver.synthetic_stream(3000, seed=4),
                                jax_stream(3000, seed=4))
  args = ['--device=cpu', '--train_steps=4', '--num_layers=1',
          '--d_model=32', '--d_ff=64', '--num_heads=2', '--seq_len=16',
          '--batch_size=2', '--packed_bm=16', '--maskupdate_frequency=2',
          '--maskupdate_end_step=3', '--warmup_steps=2', '--log_every=2',
          '--training_method=momentum', '--mask_init_method=random',
          '--generate_steps=3', '--generate_kv_chunk=8',
          f'--output_dir={tmp_path}']
  res = tdriver.main(args)
  assert res['train_steps'] == res['batches'] == 4    # SNFS: no extra batch
  assert res['mask_updates'] == 2
  assert res['data_source'] == 'synthetic' and res['vocab_size'] == 64
  assert len(res['generated_tokens']) == 3
  assert (tmp_path / 'packed_lm_state.npz').exists()
  res = tdriver.main(args[:1] + ['--train_steps=6'] + args[2:])
  assert '# resumed at step 4' in capsys.readouterr().out
  assert res['train_steps'] == 6
  for bad in ('--training_method=prune', '--n_data=2'):
    with pytest.raises((ValueError, NotImplementedError)):
      tdriver.main(['--device=cpu', bad])
