"""Port parity: the packed-transformer serving slice of rigl_tpu_torch
against the JAX package, at the size of tests/test_decode.py (2 layers,
d_model 32, d_ff 64, 2 heads, block (16, 16), s = 0.5, f32).

Variables are initialised once in JAX and converted with
convert.from_jax_variables, so both packages hold the same occupancy and
weights.  Logits must agree within 1e-5 (f32, summation order only);
greedy and variable-length tokens must be identical.  JAX's packed
matmul runs in interpret mode on the CPU, as its own tests run it."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rigl_tpu.models import packed_transformer as jpt
from rigl_tpu.serve import decode as jdec
from rigl_tpu_torch import convert
from rigl_tpu_torch.models import packed_transformer as tpt
from rigl_tpu_torch.serve import decode as tdec
from torch_threads import one_thread  # noqa: F401


B, T, P, V, L = 2, 10, 4, 11, 16
KW = dict(num_layers=2, d_model=32, d_ff=64, num_heads=2, vocab_size=V)
PACKED_KW = dict(sparsity=0.5, block=(16, 16), bm=16)
ATOL = 1e-5
REPO = Path(__file__).resolve().parent.parent


def _build(kind):
  rs = np.random.RandomState(0)
  tokens = rs.randint(0, V, (B, T)).astype(np.int32)
  if kind == 'packed':
    jm, tm = (jpt.PackedTransformer(**KW, **PACKED_KW),
              tpt.PackedTransformer(**KW, **PACKED_KW, device='cpu'))
  else:
    jm, tm = (jpt.DenseTransformer(**KW),
              tpt.DenseTransformer(**KW, device='cpu'))
  variables = jax.jit(jm.init)(jax.random.key(1), jnp.asarray(tokens))
  variables = jax.tree.map(np.asarray, variables)
  convert.load_converted(tm, *convert.from_jax_variables(variables))
  return jm, variables, tm, tokens


@pytest.fixture(scope='module')
def packed():
  return _build('packed')


@pytest.fixture(scope='module')
def dense():
  return _build('dense')


def _t(a):
  return torch.tensor(np.asarray(a))


def _jax_teacher_forced(jm, variables, tokens, pad=None):
  """JAX decode twin: prefill tokens[:, :P], then one true token at a
  time; logits for every position."""
  dm = jdec.decode_twin(jm, L)
  cache = jax.jit(dm.init)(jax.random.key(0),
                           jnp.zeros((B, 1), jnp.int32))['cache']
  if pad is not None:
    cache = jdec._set_pad_lens(cache, jnp.asarray(pad, jnp.int32))
  step = jax.jit(lambda c, t: dm.apply(dict(variables, cache=c), t,
                                       mutable=['cache']))
  logits, mut = step(cache, jnp.asarray(tokens[:, :P]))
  outs = [logits]
  for t in range(P, tokens.shape[1]):
    logits, mut = step(mut['cache'], jnp.asarray(tokens[:, t:t + 1]))
    outs.append(logits)
  return np.concatenate([np.asarray(o) for o in outs], axis=1)


def _torch_teacher_forced(tm, tokens, pad=None):
  dm = tdec.decode_twin(tm, L)
  cache = tdec.init_cache(dm, B)
  if pad is not None:
    tdec._set_pad_lens(cache, _t(pad))
  with torch.inference_mode():
    outs = [dm(_t(tokens[:, :P]), cache)]
    for t in range(P, tokens.shape[1]):
      outs.append(dm(_t(tokens[:, t:t + 1]), cache))
  return torch.cat(outs, dim=1).numpy()


@pytest.mark.parametrize('kind', ['packed', 'dense'])
def test_full_causal_logits_match_jax(kind, request):
  jm, variables, tm, tokens = request.getfixturevalue(kind)
  want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(tokens)))
  with torch.inference_mode():
    got = tm(_t(tokens)).numpy()
  assert got.shape == (B, T, V)
  np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_prefill_and_incremental_logits_match_jax(packed):
  jm, variables, tm, tokens = packed
  want = _jax_teacher_forced(jm, variables, tokens)
  got = _torch_teacher_forced(tm, tokens)
  np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
  with torch.inference_mode():                # and the port's own full pass
    np.testing.assert_allclose(got, tm(_t(tokens)).numpy(), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize('kind', ['packed', 'dense'])
def test_greedy_generate_tokens_match_jax(kind, request):
  jm, variables, tm, tokens = request.getfixturevalue(kind)
  steps = 6
  want = np.asarray(jdec.generate(jdec.decode_twin(jm, L), variables,
                                  jnp.asarray(tokens[:, :P]), steps))
  got = tdec.generate(tdec.decode_twin(tm, L), _t(tokens[:, :P]), steps)
  assert got.dtype == torch.int32 and got.shape == (B, steps)
  np.testing.assert_array_equal(got.numpy(), want)


def test_varlen_left_padded_batch_matches_jax(packed):
  jm, variables, tm, tokens = packed
  lens = np.asarray([P, P - 2], np.int32)
  prompt = tokens[:, :P].copy()
  prompt[1, :P - lens[1]] = 0                 # left pad of the short row
  steps = 6
  want = np.asarray(jdec.generate(jdec.decode_twin(jm, L), variables,
                                  jnp.asarray(prompt), steps,
                                  prompt_lens=jnp.asarray(lens)))
  got = tdec.generate(tdec.decode_twin(tm, L), _t(prompt), steps,
                      prompt_lens=_t(lens))
  np.testing.assert_array_equal(got.numpy(), want)
  # Teacher-forced logits with the pad stamp, at non-pad positions only
  # (left-pad query rows are fully masked and never read).
  forced = np.concatenate([prompt, tokens[:, P:]], axis=1)
  want = _jax_teacher_forced(jm, variables, forced, pad=P - lens)
  got = _torch_teacher_forced(tm, forced, pad=P - lens)
  live = np.arange(T)[None, :] >= (P - lens)[:, None]
  np.testing.assert_allclose(got[live], want[live], rtol=0, atol=ATOL)
  assert np.isfinite(got).all()


SAMPLE_CONFIGS = [(0.7, 3, 1.0), (1.0, 0, 0.7), (1.3, 5, 0.8), (1.0, 0, 0.0),
                  (0.5, 1, 1.0), (1.0, V, 1.0)]


@pytest.mark.parametrize('temperature,top_k,top_p', SAMPLE_CONFIGS)
def test_sample_filters_match_jax(temperature, top_k, top_p):
  """JAX draws categorical(key, filtered) = argmax(filtered + gumbel(key));
  the port's filtered logits plus the same Gumbel noise must pick the
  same token, for every key.  Torch-generator draws stay in the support."""
  rs = np.random.RandomState(7)
  logits = rs.randn(6, V).astype(np.float32) * 2
  logits[0, :3] = logits[0].max() + 1          # tie at the top
  logits[1, 4:6] = np.sort(logits[1])[-3]      # tie at the k-th value
  filtered = tdec._filter_logits(_t(logits), temperature, top_k, top_p)
  support = filtered > torch.finfo(torch.float32).min
  for i in range(10):
    key = jax.random.key(100 + i)
    want = np.asarray(jdec._sample(jnp.asarray(logits), key, temperature,
                                   top_k, top_p))
    g = np.asarray(jax.random.gumbel(key, logits.shape, jnp.float32))
    got = torch.argmax(filtered + _t(g), dim=-1).numpy()
    np.testing.assert_array_equal(got, want)
  gen = torch.Generator().manual_seed(0)
  for _ in range(20):
    tok = tdec._sample(_t(logits), gen, temperature, top_k, top_p)
    assert tok.dtype == torch.int32
    assert support[torch.arange(6), tok.long()].all()
  greedy = tdec._sample(_t(logits), None, 0.0)
  np.testing.assert_array_equal(
      greedy.numpy(), np.asarray(jdec._sample(jnp.asarray(logits),
                                              jax.random.key(0), 0.0)))


def test_dense_twin_state_computes_the_packed_model(packed):
  """convert.dense_twin_state: the dense twin holding the unpacked
  kernels gives the packed model's logits (the plain path, end to end)."""
  _, _, tm, tokens = packed
  twin = tpt.DenseTransformer(**KW, device='cpu')
  twin.load_state_dict(convert.dense_twin_state(tm), strict=True)
  with torch.inference_mode():
    np.testing.assert_allclose(twin(_t(tokens)).numpy(),
                               tm(_t(tokens)).numpy(), rtol=0, atol=ATOL)


def test_random_init_shapes_and_active_counts():
  gen = torch.Generator().manual_seed(3)
  tm = tpt.PackedTransformer(num_layers=1, d_model=64, d_ff=128,
                             num_heads=2, vocab_size=0, sparsity=0.8,
                             block=(16, 16), generator=gen, device='cpu')
  qkv = tm.block0.attn.qkv
  assert qkv.packing.shape == (4, 12)
  assert qkv.kernel.shape == (48 - int(np.floor(0.8 * 48)), 16, 16)
  assert int(qkv.packing.fwd[3].sum()) == qkv.kernel.shape[0]
  x = torch.randn(2, 3, 64, generator=gen)
  with torch.inference_mode():
    assert tm(x).shape == (2, 3, 64)          # vocab_size == 0: embeddings


def test_decode_contract_errors():
  tm = tpt.DenseTransformer(num_layers=1, d_model=32, d_ff=64, num_heads=2,
                            vocab_size=0, device='cpu')
  with pytest.raises(ValueError, match='vocab'):
    tdec.decode_twin(tm, L)
  tm = tpt.DenseTransformer(**KW, device='cpu')
  with pytest.raises(ValueError, match='must divide'):
    tdec.decode_twin(tm, L, kv_chunk=3)
  chunked = tdec.decode_twin(tm, L, kv_chunk=4)     # ported: a working twin
  assert chunked.kv_chunk == 4 and tm.kv_chunk == 0
  assert tdec.generate(chunked, torch.zeros(1, 3, dtype=torch.int32),
                       2).shape == (1, 2)
  dm = tdec.decode_twin(tm, L)
  assert dm.decode and not tm.decode and dm.block0 is tm.block0
  with pytest.raises(ValueError, match='exceeds max_decode_len'):
    tdec.generate(dm, torch.zeros(1, 12, dtype=torch.int32), 5)
  with pytest.raises(ValueError, match='steps'):
    tdec.make_generate_fn(dm, 0)
  with pytest.raises(ValueError, match='takes a cache'):
    dm(torch.zeros(1, 2, dtype=torch.int32))
  for kw in (dict(seq_axis='s'), dict(tp_shards=2)):
    with pytest.raises(NotImplementedError, match='not ported'):
      tpt.PackedTransformer(**KW, **PACKED_KW, **kw, device='cpu')
  # Ported now: the fused core and kv_chunk build working models.
  fused = tpt.PackedTransformer(**KW, **PACKED_KW, fused_attention=True,
                                kv_chunk=8, device='cpu')
  assert fused.block0.attn.fused and fused.kv_chunk == 8
  with torch.inference_mode():
    assert fused(torch.zeros(1, 3, dtype=torch.int32)).shape == (1, 3, V)


def test_bf16_training_keeps_f32_master_weights_like_jax():
  """A bf16 PackedTransformer takes 3 Adam steps in both packages.  As in
  JAX, the packed kernels, the embedding, the head and the LayerNorms are
  float32 master weights that the optimizer updates, cast to bf16 on each
  call; the dense twin's projections alone are stored in bf16.  At lr
  1e-5 a bf16-stored parameter (about 1e-3 apart from its neighbours at
  these magnitudes) would not move at all.  The bf16 products round at
  other places in the two packages, so Adam's near-sign steps of small
  gradient elements may differ: each parameter's summed |update|
  difference must stay within 0.2 of JAX's summed |update| (measured:
  0.09 at most)."""
  lr = 1e-5
  rs = np.random.RandomState(1)
  tokens = rs.randint(0, V, (B, T + 1)).astype(np.int32)
  x, y = tokens[:, :-1], tokens[:, 1:]
  jm = jpt.PackedTransformer(**KW, **PACKED_KW, dtype=jnp.bfloat16)
  variables = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.key(2),
                                                        jnp.asarray(x)))

  def jloss(params):
    lg = jm.apply({'params': params, 'packing': variables['packing']},
                  jnp.asarray(x)).astype(jnp.float32)
    ll = jax.nn.log_softmax(lg)[jnp.arange(B)[:, None],
                                jnp.arange(T)[None, :], jnp.asarray(y)]
    return -jnp.mean(ll)

  tx = optax.adam(lr)
  params = variables['params']
  opt_state = tx.init(params)
  grad_fn = jax.jit(jax.grad(jloss))
  for _ in range(3):
    grads = grad_fn(params)
    updates, opt_state = tx.update(grads, opt_state, params)
    params = optax.apply_updates(params, updates)

  tm = tpt.PackedTransformer(**KW, **PACKED_KW, dtype=torch.bfloat16,
                             device='cpu')
  init, packings = convert.from_jax_variables(variables)
  convert.load_converted(tm, init, packings)
  opt = torch.optim.Adam(tm.parameters(), lr=lr, eps=1e-8)
  for _ in range(3):
    opt.zero_grad()
    logp = torch.log_softmax(tm(_t(x)).float(), -1)
    (-logp.gather(-1, _t(y).long()[..., None]).mean()).backward()
    opt.step()
  want, _ = convert.from_jax_variables({'params': params})
  got = dict(tm.named_parameters())
  assert set(got) == set(want)
  for name, p in got.items():
    assert p.dtype == torch.float32 and want[name].dtype == np.float32, name
    moved = np.asarray(want[name], np.float64) - init[name]
    diff = p.detach().numpy().astype(np.float64) - init[name] - moved
    assert np.abs(moved).sum() > 0, name
    assert np.abs(diff).sum() <= 0.2 * np.abs(moved).sum(), name
  twin = tpt.DenseTransformer(**KW, dtype=torch.bfloat16, device='cpu')
  jtwin = jax.eval_shape(jpt.DenseTransformer(**KW, dtype=jnp.bfloat16).init,
                         jax.random.key(0), jnp.asarray(x))
  jdtypes = {k: v.dtype for k, v in convert.from_jax_variables(
      jax.tree.map(lambda a: np.zeros((), a.dtype), jtwin))[0].items()}
  for name, p in twin.named_parameters():
    proj = name.endswith('.d.kernel')
    assert p.dtype == (torch.bfloat16 if proj else torch.float32), name
    assert jdtypes[name] == (jnp.bfloat16 if proj else np.float32), name


def test_port_imports_no_jax():
  """Every rigl_tpu_torch module imports without loading jax, flax or
  the JAX package (the card's machine has none of them)."""
  code = (
      'import importlib, pkgutil, sys\n'
      'import rigl_tpu_torch\n'
      'for m in pkgutil.walk_packages(rigl_tpu_torch.__path__,'
      ' "rigl_tpu_torch."):\n'
      '  importlib.import_module(m.name)\n'
      'bad = sorted(n for n in sys.modules if n.split(".")[0] in'
      ' ("jax", "jaxlib", "flax", "rigl_tpu"))\n'
      'assert not bad, bad\n'
      'print(len([n for n in sys.modules if n.startswith("rigl_tpu_torch")]))'
  )
  out = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                       capture_output=True, text=True, timeout=120,
                       check=False)
  assert out.returncode == 0, out.stderr
  assert int(out.stdout.strip()) >= 28
