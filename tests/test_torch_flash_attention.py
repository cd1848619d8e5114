"""Port parity: the causal flash-attention core of rigl_tpu_torch against
the JAX package.

JAX's fused core (`rigl_tpu/models/packed_transformer.py:_flash_attention`)
calls the shipped TPU kernel, which has no interpret mode; its own plain
reference, `mha_reference_no_custom_vjp(causal=True)` with `jax.vjp`,
is the JAX side here, as the model's docstring names the unfused einsum
path its numerical reference.  Inputs are made with numpy from a seed and
fed to both.  Everything is f32: outputs, the log-sum-exp and gradients
must agree within 1e-5 of the largest JAX value (summation order only).
The model check runs the port's fused PackedTransformer against JAX's
unfused one on the same converted variables."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu import flash_attention as jfa

from rigl_tpu.models import packed_transformer as jpt
from rigl_tpu_torch import convert
from rigl_tpu_torch.models import packed_transformer as tpt
from rigl_tpu_torch.ops import flash_attention as tfa
from torch_threads import one_thread  # noqa: F401


RTOL = 1e-5


def _close(got, want, what=''):
  """max |got - want| <= RTOL * max |want| (f32, summation order)."""
  got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
  assert got.shape == want.shape, what
  err = np.abs(got - want).max()
  assert err <= RTOL * max(np.abs(want).max(), 1e-30), (what, err)


def _inputs(b, h, s, hd, seed):
  rs = np.random.RandomState(seed)
  return [rs.randn(b, h, s, hd).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize('hd', [16, 32, 64])
@pytest.mark.parametrize('s', [5, 64, 130])
def test_plain_versions_match_jax_reference(s, hd):
  """flash_attention_fwd_reference (o and lse) and
  flash_attention_bwd_reference (dq, dk, dv by the kernels'
  recompute-from-lse formulas) against JAX's reference and its VJP."""
  q, k, v, do = _inputs(2, 3, s, hd, seed=s * 100 + hd)
  scale = hd ** -0.5
  ref = lambda q, k, v: jfa.mha_reference_no_custom_vjp(   # noqa: E731
      q, k, v, causal=True, sm_scale=scale)
  want_o, vjp = jax.vjp(ref, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
  want_grads = vjp(jnp.asarray(do))
  _, l, m = jfa.mha_reference_no_custom_vjp(
      jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
      sm_scale=scale, save_residuals=True)

  tq, tk, tv, tdo = (torch.tensor(a) for a in (q, k, v, do))
  o, lse = tfa.flash_attention_fwd_reference(tq, tk, tv, scale)
  assert o.dtype == torch.float32 and lse.shape == (2, 3, s)
  _close(o.numpy(), want_o, 'o')
  _close(lse.numpy(), np.asarray(m) + np.log(np.asarray(l)), 'lse')
  grads = tfa.flash_attention_bwd_reference(tq, tk, tv, o, lse, tdo, scale)
  for name, got, want in zip(('dq', 'dk', 'dv'), grads, want_grads):
    _close(got.numpy(), want, name)


@pytest.mark.parametrize('s,hd', [(5, 16), (130, 64)])
def test_autograd_function_matches_autograd_through_plain_forward(s, hd):
  """flash_attention's autograd Function (plain forward and backward on
  the CPU) against torch autograd through the plain forward; a call with
  no gradient skips the Function and gives the same output."""
  q, k, v, do = (torch.tensor(a) for a in _inputs(1, 2, s, hd, seed=s))
  scale = hd ** -0.5
  leaves = [t.clone().requires_grad_() for t in (q, k, v)]
  o = tfa.flash_attention(*leaves, scale)
  assert o.grad_fn is not None and o.dtype == torch.float32
  got = torch.autograd.grad(o, leaves, do)
  plain = [t.clone().requires_grad_() for t in (q, k, v)]
  want_o, _ = tfa.flash_attention_fwd_reference(*plain, scale)
  want = torch.autograd.grad(want_o, plain, do)
  _close(o.detach().numpy(), want_o.detach().numpy(), 'o')
  for name, a, b in zip(('dq', 'dk', 'dv'), got, want):
    _close(a.numpy(), b.numpy(), name)
  with torch.no_grad():
    np.testing.assert_array_equal(tfa.flash_attention(q, k, v, scale).numpy(),
                                  o.detach().numpy())


@pytest.mark.parametrize('hd,padded', [(16, 32), (48, 64)])
def test_pad_head_dim_around_plain_versions_is_exact(hd, padded):
  """pad_head_dim, which flash_attention runs on the card for a head dim
  below 128 that the kernels do not take, around the plain versions on the
  CPU: it hands the next head dim of HEAD_DIMS to the attention, and o,
  dq, dk and dv equal the unpadded plain path's within 1e-6 of each
  one's largest value (the zero columns change only how the products
  block their sums)."""
  q, k, v, do = (torch.tensor(a) for a in _inputs(2, 3, 70, hd, seed=hd))
  scale = hd ** -0.5
  seen = []

  def attend(*args):
    seen.append(args[0].shape[-1])
    return tfa._attend(*args)

  def run(fn):
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = fn(*leaves, scale)
    return (o.detach(), *torch.autograd.grad(o, leaves, do))

  got = run(lambda *a: tfa.pad_head_dim(attend, *a))
  want = run(tfa._attend)
  assert seen == [padded]
  for name, g, w in zip(('o', 'dq', 'dk', 'dv'), got, want):
    assert g.shape == w.shape == (2, 3, 70, hd), name
    err = float((g - w).abs().max())
    assert err <= 1e-6 * float(w.abs().max()), (name, err)


KW = dict(num_layers=2, d_model=32, d_ff=64, num_heads=2, vocab_size=11)
PACKED_KW = dict(sparsity=0.5, block=(16, 16), bm=16)


def test_fused_port_model_matches_unfused_jax_model():
  """PackedTransformer(fused_attention=True) in the port, on the CPU,
  against JAX's PackedTransformer(fused_attention=False) on the same
  variables: logits and the gradient of every parameter of a loss."""
  rs = np.random.RandomState(0)
  tokens = rs.randint(0, KW['vocab_size'], (2, 24)).astype(np.int32)
  jm = jpt.PackedTransformer(**KW, **PACKED_KW)
  variables = jax.jit(jm.init)(jax.random.key(1), jnp.asarray(tokens))
  variables = jax.tree.map(np.asarray, variables)
  tm = tpt.PackedTransformer(**KW, **PACKED_KW, fused_attention=True,
                             device='cpu')
  convert.load_converted(tm, *convert.from_jax_variables(variables))
  assert tm.block0.attn.fused

  def jloss(params):
    lg = jm.apply({'params': params, 'packing': variables['packing']},
                  jnp.asarray(tokens))
    return jnp.mean(jnp.square(lg)), lg

  (jl, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(
      variables['params'])
  tlogits = tm(torch.tensor(tokens))
  tl = tlogits.square().mean()
  tl.backward()
  _close(tlogits.detach().numpy(), jlogits, 'logits')
  _close(tl.detach().numpy(), jl, 'loss')
  flat, _ = convert.from_jax_variables({'params': jax.tree.map(np.asarray,
                                                               jgrads)})
  params = dict(tm.named_parameters())
  assert set(flat) == set(params)
  for name, want in flat.items():
    _close(params[name].grad.numpy(), want, name)
