"""The port's hand-written kernels (packed forward, dx and packed dw, and
their dense storage modes under the v3 / v4 entries and the history
entries B9'-B12; the causal flash-attention forward, dK/dV and dQ in bf16
and f32; the tap conv's forward, dx and dw) against their plain PyTorch
versions, on a CUDA card, and the paths that run them (the MoE's experts
and its trainer step among them).

Every test here needs the card (marker `cuda`) and skips without one.
The file imports neither jax nor the JAX package, so the card's machine
runs it without the repo's conftest (which imports jax):

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest -q
"""

import functools

import pytest
import torch

from rigl_tpu_torch import convert
from rigl_tpu_torch.layers.packed_conv import PackedConv
from rigl_tpu_torch.layers.packed_dense import PackedDense, random_occupancy
from rigl_tpu_torch.ops import block_sparse_conv as tbsc
from rigl_tpu_torch.models import packed_transformer as tpt
from rigl_tpu_torch.ops import block_sparse_packed as tbsp
from rigl_tpu_torch.ops import dw_split
from rigl_tpu_torch.ops import flash_attention as tfa
from rigl_tpu_torch.serve import decode as tdec

# (nk, nn, n_active): empty columns, a single active, all actives in one
# column, a full grid, and the slice's qkv grid (12 columns, 10 actives).
GRIDS = [(4, 6, 5), (3, 4, 1), (5, 1, 3), (2, 3, 6), (4, 12, 10)]


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device: the packed_mm kernels have no CPU mode')
  # f32 references run in full f32: cuBLAS and cuDNN (the 'xla' conv
  # engine) would otherwise use TF32.
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  return torch.device('cuda')


def _packing(grid, seed):
  nk, nn_, n_act = grid
  gen = torch.Generator().manual_seed(seed)
  return tbsp.make_packing(random_occupancy(gen, nk, nn_, n_act), n_act)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,tol', [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize('block', [(32, 64), (64, 32), (16, 8), (512, 512)])
@pytest.mark.parametrize('m', [1, 2, 3, 5, 8, 33, 64, 200])
@pytest.mark.parametrize('grid', GRIDS)
def test_packed_mm_kernel_matches_plain(cuda_device, grid, m, block, dtype,
                                        tol):
  """The forward kernel, in its small-m (m <= 32) and its large-m tiling.
  bf16: both sides sum in f32 and round once, so they
  differ by the order of the f32 sums plus a bf16 ulp (2^-8 relative);
  f32: the order of the sums over up to 2048 terms.  Tolerances relative
  to max(1, max |plain|)."""
  packing = _packing(grid, m)
  gen = torch.Generator().manual_seed(m)
  x = torch.randn(m, grid[0] * block[0], generator=gen).to(cuda_device,
                                                          dtype)
  w = torch.randn(grid[2], *block, generator=gen).to(cuda_device, dtype)
  before = tbsp.packed_mm_launches
  with torch.inference_mode():
    got = tbsp.packed_matmul(x, w, packing, block)
    want = tbsp.packed_matmul_reference(x, w, packing, block)
  torch.cuda.synchronize()
  assert tbsp.packed_mm_launches == before + 1
  assert got.shape == want.shape and got.dtype == dtype
  scale = max(1.0, float(want.float().abs().max()))
  err = float((got.float() - want.float()).abs().max())
  assert err <= tol * scale, err


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,tol', [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize('block', [(32, 64), (64, 32), (16, 8), (512, 512)])
@pytest.mark.parametrize('m', [1, 2, 3, 5, 8, 33, 64, 200])
@pytest.mark.parametrize('grid', GRIDS)
def test_packed_dx_and_dw_kernels_match_plain(cuda_device, grid, m, block,
                                              dtype, tol):
  """dx (the transposed mode, through the bwd packing's CSR) and the packed
  dw, at ragged m and blocks narrower than a tile.  Both sides sum in f32
  and round once: tolerances as for the forward, relative to
  max(1, max |plain|).  Empty block-rows give zero dx columns."""
  packing = _packing(grid, m)
  gen = torch.Generator().manual_seed(m + 1)
  nk, nn_, n_act = grid
  x = torch.randn(m, nk * block[0], generator=gen).to(cuda_device, dtype)
  gy = torch.randn(m, nn_ * block[1], generator=gen).to(cuda_device, dtype)
  w = torch.randn(n_act, *block, generator=gen).to(cuda_device, dtype)
  before = (tbsp.packed_mm_dx_launches, tbsp.packed_dw_launches)
  got_dx = tbsp.packed_matmul_dx_cuda(gy, w, packing, block)
  got_dw = tbsp.packed_dw_cuda(x, gy, w, packing, block)
  torch.cuda.synchronize()
  assert (tbsp.packed_mm_dx_launches, tbsp.packed_dw_launches) == (
      before[0] + 1, before[1] + 1)
  want_dx = tbsp.packed_matmul_dx_reference(gy, w, packing, block)
  want_dw = tbsp.packed_dw_reference(x, gy, packing, block, w.dtype)
  for got, want in ((got_dx, want_dx), (got_dw, want_dw)):
    assert got.shape == want.shape and got.dtype == dtype
    scale = max(1.0, float(want.float().abs().max()))
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * scale, err
  empty_rows = (packing.row_index('cpu')[0].diff() == 0).nonzero().flatten()
  for k in empty_rows.tolist():
    assert not got_dx[:, k * block[0]:(k + 1) * block[0]].any()


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,tol', [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
def test_autograd_on_card_matches_plain(cuda_device, dtype, tol):
  """torch.autograd.grad through packed_matmul on CUDA tensors launches the
  dx and dw kernels once each and gives the plain versions' gradients."""
  grid, block, m = GRIDS[4], (64, 32), 100
  packing = _packing(grid, 0)
  gen = torch.Generator().manual_seed(5)
  x = torch.randn(m, grid[0] * block[0], generator=gen).to(cuda_device,
                                                          dtype)
  w = torch.randn(grid[2], *block, generator=gen).to(cuda_device, dtype)
  g = torch.randn(m, grid[1] * block[1], generator=gen).to(cuda_device,
                                                          dtype)
  x.requires_grad_()
  w.requires_grad_()
  before = (tbsp.packed_mm_dx_launches, tbsp.packed_dw_launches)
  y = tbsp.packed_matmul(x, w, packing, block)
  dx, dw = torch.autograd.grad(y, (x, w), g)
  torch.cuda.synchronize()
  assert (tbsp.packed_mm_dx_launches, tbsp.packed_dw_launches) == (
      before[0] + 1, before[1] + 1)
  want_dx = tbsp.packed_matmul_dx_reference(g, w.detach(), packing, block)
  want_dw = tbsp.packed_dw_reference(x.detach(), g, packing, block, dtype)
  for got, want in ((dx, want_dx), (dw, want_dw)):
    assert got.dtype == dtype
    scale = max(1.0, float(want.float().abs().max()))
    assert float((got.float() - want.float()).abs().max()) <= tol * scale
  # Only the gradients asked for are computed.
  before = (tbsp.packed_mm_dx_launches, tbsp.packed_dw_launches)
  (dw_only,) = torch.autograd.grad(
      tbsp.packed_matmul(x.detach(), w, packing, block), (w,), g)
  assert (tbsp.packed_mm_dx_launches, tbsp.packed_dw_launches) == (
      before[0], before[1] + 1)
  assert torch.equal(dw_only, dw)


@pytest.mark.cuda
def test_packed_dense_trains_on_card(cuda_device):
  """Two PackedDense layers take SGD steps on the card through the
  kernels: the loss falls and every step launches fwd 2, dx 1, dw 2."""
  gen = torch.Generator().manual_seed(0)
  l0 = PackedDense(256, 256, sparsity=0.5, block=(64, 64), generator=gen,
                   device=cuda_device)
  l1 = PackedDense(256, 128, sparsity=0.5, block=(64, 64), generator=gen,
                   device=cuda_device)
  x = torch.randn(64, 256, generator=gen).to(cuda_device)
  t = torch.randn(64, 128, generator=gen).to(cuda_device)
  params = [*l0.parameters(), *l1.parameters()]
  opt = torch.optim.SGD(params, lr=0.05, momentum=0.9)
  losses = []
  for _ in range(30):
    before = (tbsp.packed_mm_launches, tbsp.packed_mm_dx_launches,
              tbsp.packed_dw_launches)
    opt.zero_grad()
    loss = ((l1(torch.relu(l0(x))) - t) ** 2).mean()
    loss.backward()
    opt.step()
    losses.append(float(loss.detach()))
    assert (tbsp.packed_mm_launches - before[0],
            tbsp.packed_mm_dx_launches - before[1],
            tbsp.packed_dw_launches - before[2]) == (2, 1, 2)
  assert losses[-1] < losses[0] * 0.8


@pytest.mark.cuda
def test_packed_mm_wrapper_raises_on_what_it_does_not_take(cuda_device):
  packing = _packing(GRIDS[0], 0)
  block = (8, 8)
  x = torch.randn(4, GRIDS[0][0] * 8, device=cuda_device)
  w = torch.randn(GRIDS[0][2], 8, 8, device=cuda_device)
  with pytest.raises(TypeError):
    tbsp.packed_matmul(x.half(), w.half(), packing, block)
  with pytest.raises(ValueError, match='contiguous'):
    tbsp.packed_matmul(x.t().contiguous().t(), w, packing, block)
  with pytest.raises(ValueError, match='one CUDA device'):
    tbsp.packed_matmul(x, w.cpu(), packing, block)
  with pytest.raises(ValueError, match='x must be'):
    tbsp.packed_matmul(x[:, :8].contiguous(), w, packing, block)
  gy = torch.randn(4, GRIDS[0][1] * 8, device=cuda_device)
  with pytest.raises(ValueError, match='gy must be'):
    tbsp.packed_matmul_dx_cuda(x, w, packing, block)
  with pytest.raises(TypeError):
    tbsp.packed_dw_cuda(x, gy.half(), w, packing, block)
  with pytest.raises(ValueError, match='gy must be'):
    tbsp.packed_dw_cuda(x, gy[:3].contiguous(), w, packing, block)
  small = (4, 4)                    # bf16 needs multiples of 8 elements
  bf = lambda t: t.bfloat16().contiguous()  # noqa: E731
  with pytest.raises(ValueError, match='multiple of 8'):
    tbsp.packed_matmul_dx_cuda(bf(gy[:, :GRIDS[0][1] * 4]),
                               bf(w[:, :4, :4]), packing, small)
  with pytest.raises(ValueError, match='multiple of 8'):
    tbsp.packed_dw_cuda(bf(x[:, :GRIDS[0][0] * 4]),
                        bf(gy[:, :GRIDS[0][1] * 4]), bf(w[:, :4, :4]),
                        packing, small)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,rtol', [(torch.float32, 1e-4),
                                        (torch.bfloat16, 5e-2)])
def test_serving_on_card_goes_through_the_kernel(cuda_device, dtype, rtol):
  """Every projection launches the kernel (2 layers x 4 per forward
  pass); logits agree with the plain path (the dense twin holding the
  unpacked kernels) within the dtype's rounding, relative to max |logit|;
  in f32 the greedy tokens are the plain path's."""
  kw = dict(num_layers=2, d_model=128, d_ff=256, num_heads=4,
            vocab_size=50, dtype=dtype)
  gen = torch.Generator().manual_seed(0)
  tm = tpt.PackedTransformer(**kw, sparsity=0.5, block=(32, 64),
                             generator=gen, device=cuda_device)
  twin = tpt.DenseTransformer(**kw, device=cuda_device)
  twin.load_state_dict(convert.dense_twin_state(tm), strict=True)
  prompt = torch.randint(0, 50, (3, 7), generator=gen).to(cuda_device)
  steps = 5
  before = tbsp.packed_mm_launches
  out = tdec.generate(tdec.decode_twin(tm, 16), prompt, steps)
  assert tbsp.packed_mm_launches - before == 2 * 4 * steps
  with torch.inference_mode():
    got, want = tm(prompt).float(), twin(prompt).float()
  assert torch.isfinite(got).all()
  scale = float(want.abs().max())
  assert float((got - want).abs().max()) <= rtol * scale
  if dtype == torch.float32:
    plain = tdec.generate(tdec.decode_twin(twin, 16), prompt, steps)
    assert torch.equal(out, plain)


# ------------------------------------------------------ flash attention ----
def _qkvo(shape, seed, device):
  gen = torch.Generator().manual_seed(seed)
  return [torch.randn(shape, generator=gen).to(device, torch.bfloat16)
          for _ in range(4)]


def _rel_err(got, want):
  """max |got - want| over max |want| (no floor: gradients can be small)."""
  want = want.float()
  return float((got.float() - want).abs().max()) / max(
      float(want.abs().max()), 1e-30)


# bf16 outputs and gradients: the kernels round P (for P v and Pᵀ do) and
# dS to bf16 before their products, where the plain versions keep f32;
# each error is relative to the largest plain value.  lse is f32 from f32
# sums of exact bf16 products, so it differs by summation order only.
FLASH_TOL, LSE_TOL = 2e-2, 1e-4


# (B, H, S): S below, at and across the 64-row tiles (dQ; the dK/dV ring)
# and the 128-row tiles (forward; dK/dV blocks), b * h from 1 to 64.
FLASH_EDGES = [(1, 1, 1), (1, 1, 5), (2, 3, 64), (1, 1, 127), (1, 2, 128),
               (2, 1, 129), (1, 2, 130), (3, 1, 255), (1, 4, 256),
               (4, 16, 512), (2, 2, 1000)]


@pytest.mark.cuda
@pytest.mark.parametrize('hd', [32, 64, 128])
@pytest.mark.parametrize('b,h,s', FLASH_EDGES)
def test_flash_kernels_match_plain(cuda_device, b, h, s, hd):
  """Forward, dK/dV and dQ kernels at S below, at and across their tiles
  (ragged S masked in the kernels), each launched once, against the plain
  versions on the same inputs (the backward fed the kernel's o and lse,
  so it checks the backward kernels alone)."""
  q, k, v, do = _qkvo((b, h, s, hd), s * 7 + hd, cuda_device)
  scale = hd ** -0.5
  before = (tfa.flash_fwd_launches, tfa.flash_bwd_dkv_launches,
            tfa.flash_bwd_dq_launches)
  o, lse = tfa.flash_fwd_cuda(q, k, v, scale)
  dq, dk, dv = tfa.flash_attention_bwd_cuda(q, k, v, o, lse, do, scale)
  torch.cuda.synchronize()
  assert (tfa.flash_fwd_launches, tfa.flash_bwd_dkv_launches,
          tfa.flash_bwd_dq_launches) == tuple(n + 1 for n in before)
  want_o, want_lse = tfa.flash_attention_fwd_reference(q, k, v, scale)
  assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
  assert _rel_err(o, want_o) <= FLASH_TOL
  assert float((lse - want_lse).abs().max()) <= LSE_TOL * max(
      1.0, float(want_lse.abs().max()))
  want = tfa.flash_attention_bwd_reference(q, k, v, o, lse, do, scale)
  for name, got, ref in zip(('dq', 'dk', 'dv'), (dq, dk, dv), want):
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    assert torch.isfinite(got).all(), name
    if s == 1 and name != 'dv':
      # One key: P = 1 and dS = P (dP - D) scale is 0 up to the rounding of
      # dP and D, so dq and dk are rounding noise, held against dv's scale.
      assert float(got.float().abs().max()) <= FLASH_TOL * float(
          want[2].float().abs().max()), name
    else:
      assert _rel_err(got, ref) <= FLASH_TOL, name


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('b,h,s,hd', [(4, 16, 512, 128), (2, 2, 1000, 64),
                                      (1, 3, 129, 32), (1, 2, 130, 128),
                                      (1, 1, 5, 64)])
def test_flash_wgmma_kernels_are_deterministic(cuda_device, b, h, s, hd,
                                               dtype):
  """Two launches of the forward, of dK/dV and of dQ on the same inputs
  give the same bits, in bf16 (wgmma) and f32 (the forward on FFMA, dK/dV
  and dQ on 3xTF32 wgmma): each output is one thread block's, its sums in
  a fixed order, with no atomics."""
  q, k, v, do = (t.to(dtype) for t in
                 _qkvo((b, h, s, hd), s + hd, cuda_device))
  scale = hd ** -0.5
  o, lse = tfa.flash_fwd_cuda(q, k, v, scale)
  o2, lse2 = tfa.flash_fwd_cuda(q, k, v, scale)
  assert torch.equal(o, o2) and torch.equal(lse, lse2)
  d = tfa._rowsum_do_o(do, o)
  dk, dv = tfa.flash_bwd_dkv_cuda(q, k, v, do, lse, d, scale)
  dk2, dv2 = tfa.flash_bwd_dkv_cuda(q, k, v, do, lse, d, scale)
  assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
  dq = tfa.flash_bwd_dq_cuda(q, k, v, do, lse, d, scale)
  dq2 = tfa.flash_bwd_dq_cuda(q, k, v, do, lse, d, scale)
  assert torch.equal(dq, dq2)


@pytest.mark.cuda
@pytest.mark.parametrize('hd', [32, 64, 128])
def test_flash_attention_autograd_on_card(cuda_device, hd):
  """torch.autograd.grad through flash_attention launches the forward once
  and each backward kernel once, and agrees with autograd through the
  plain forward."""
  q, k, v, do = _qkvo((2, 4, 200, hd), hd, cuda_device)
  q, k, v = (t.requires_grad_() for t in (q, k, v))
  before = (tfa.flash_fwd_launches, tfa.flash_bwd_dkv_launches,
            tfa.flash_bwd_dq_launches)
  o = tfa.flash_attention(q, k, v, hd ** -0.5)
  grads = torch.autograd.grad(o, (q, k, v), do)
  torch.cuda.synchronize()
  assert (tfa.flash_fwd_launches, tfa.flash_bwd_dkv_launches,
          tfa.flash_bwd_dq_launches) == tuple(n + 1 for n in before)
  qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
  want_o, _ = tfa.flash_attention_fwd_reference(qf, kf, vf, hd ** -0.5)
  want = torch.autograd.grad(want_o, (qf, kf, vf), do.float())
  assert _rel_err(o.detach(), want_o.detach()) <= FLASH_TOL
  for got, ref in zip(grads, want):
    assert got.dtype == torch.bfloat16
    assert _rel_err(got, ref) <= FLASH_TOL
  with torch.inference_mode():
    before = tfa.flash_fwd_launches
    o2 = tfa.flash_attention(q, k, v, hd ** -0.5)
    assert tfa.flash_fwd_launches == before + 1
  assert torch.equal(o2, o.detach())


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('hd', [16, 48, 96])
def test_flash_attention_pads_head_dims_below_128(cuda_device, hd, dtype):
  """A head dim below 128 that the kernels do not take runs through
  flash_attention zero-padded to the next of 32 / 64 / 128: one launch of
  each kernel, and o and the gradients of q, k and v agree with autograd
  through the plain forward (in f32) at the kernels' own tolerance."""
  tol = FLASH_TOL if dtype == torch.bfloat16 else FLASH_F32_TOL
  gen = torch.Generator().manual_seed(hd)
  q, k, v, do = (torch.randn(2, 4, 200, hd, generator=gen).to(cuda_device,
                                                              dtype)
                 for _ in range(4))
  q, k, v = (t.requires_grad_() for t in (q, k, v))
  counts = _f32_counts if dtype == torch.float32 else lambda: (
      tfa.flash_fwd_launches, tfa.flash_bwd_dkv_launches,
      tfa.flash_bwd_dq_launches)
  before = counts()
  o = tfa.flash_attention(q, k, v, hd ** -0.5)
  grads = torch.autograd.grad(o, (q, k, v), do)
  torch.cuda.synchronize()
  assert counts() == tuple(n + 1 for n in before)
  assert o.shape == q.shape and o.dtype == dtype
  qf, kf, vf = (t.detach().float().clone().requires_grad_()
                for t in (q, k, v))
  want_o, _ = tfa.flash_attention_fwd_reference(qf, kf, vf, hd ** -0.5)
  want = torch.autograd.grad(want_o, (qf, kf, vf), do.float())
  assert _rel_err(o.detach(), want_o.detach()) <= tol
  for name, got, ref in zip(('dq', 'dk', 'dv'), grads, want):
    assert got.dtype == dtype and got.shape == ref.shape, name
    assert _rel_err(got, ref) <= tol, (name, _rel_err(got, ref))


@pytest.mark.cuda
def test_flash_attention_raises_on_what_it_does_not_take(cuda_device):
  """float32 runs its own kernel; float16 and mixed dtypes raise, as do a
  head dim above 128 (256), shapes and devices the kernels do not take."""
  q = torch.randn(1, 2, 16, 64, device=cuda_device)
  before = tfa.flash_fwd_f32_launches, tfa.flash_fwd_launches
  o = tfa.flash_attention(q, q, q, 0.125)
  assert o.dtype == torch.float32
  assert (tfa.flash_fwd_f32_launches, tfa.flash_fwd_launches) == (
      before[0] + 1, before[1])
  with pytest.raises(NotImplementedError, match='bfloat16 or float32'):
    tfa.flash_attention(q.half(), q.half(), q.half(), 0.125)
  with pytest.raises(NotImplementedError, match='one dtype'):
    tfa.flash_fwd_cuda(q, q.bfloat16(), q, 0.125)
  q256 = torch.randn(1, 2, 16, 256, device=cuda_device,
                     dtype=torch.bfloat16)
  with pytest.raises(NotImplementedError, match='head dims'):
    tfa.flash_attention(q256, q256, q256, 0.0625)
  qb = q.bfloat16()
  with pytest.raises(ValueError, match='one shape'):
    tfa.flash_fwd_cuda(qb, qb[:, :, :8].contiguous(), qb, 0.125)
  with pytest.raises(ValueError, match='one CUDA device'):
    tfa.flash_fwd_cuda(qb, qb.cpu(), qb, 0.125)


@pytest.mark.cuda
def test_lm_trainer_bf16_step_on_card_matches_plain(cuda_device):
  """One bf16 PackedLMTrainer step on the card: the packed projections
  launch fwd, dx and dw once each per layer, and the loss and every
  parameter's gradient agree with the plain path (the dense twin holding
  the unpacked kernels) on the same state and batch.  bf16 products round
  at other places in the two paths; each gradient's error is relative to
  its own largest plain value."""
  from torch.func import functional_call
  from rigl_tpu_torch.drivers.packed_lm import synthetic_stream
  from rigl_tpu_torch.train import packed_lm as tlm
  cfg = tlm.PackedLMConfig(vocab_size=64, num_layers=2, d_model=256,
                           d_ff=512, num_heads=2, seq_len=128,
                           sparsity=0.5, block=(128, 128), bm=128,
                           dtype='bfloat16', batch_size=2, seed=3)
  tr = tlm.PackedLMTrainer(cfg, device=cuda_device)
  tr.init_state()
  x, y = tr.sample_batch(synthetic_stream(5000, seed=3))
  params = tr.params
  assert all(p.dtype == torch.float32 for p in params.values())
  before = (tbsp.packed_mm_launches, tbsp.packed_mm_dx_launches,
            tbsp.packed_dw_launches)
  loss = tlm._lm_loss(tr.model(x), y)
  grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
  torch.cuda.synchronize()
  moved = tuple(a - b for a, b in zip(
      (tbsp.packed_mm_launches, tbsp.packed_mm_dx_launches,
       tbsp.packed_dw_launches), before))
  assert moved == (8, 8, 8)
  views = {n: v.detach().clone().requires_grad_() for n, v in
           tlm.dense_twin_params({n: p.detach() for n, p in params.items()},
                                 tr.packings, cfg.block).items()}
  twin = tpt.DenseTransformer(device=cuda_device, **cfg.model_kwargs())
  plain_loss = tlm._lm_loss(functional_call(twin, views, (x,)), y)
  plain = dict(zip(views, torch.autograd.grad(plain_loss,
                                              list(views.values()))))
  loss, plain_loss = float(loss.detach()), float(plain_loss.detach())
  assert abs(loss - plain_loss) <= 2e-2 * abs(plain_loss)
  packings = tr.packings
  for name, g in grads.items():
    if name in packings:
      got = tbsp.unpack_dense(g, packings[name], cfg.block)
      want = plain[f'{name.rsplit(".", 1)[0]}.d.kernel']
      occ = tbsp.unpack_dense(torch.ones_like(g), packings[name], cfg.block)
      want = want * occ            # the plain dense grad at active blocks
    else:
      got, want = g, plain[name]
    assert torch.isfinite(got).all(), name
    assert _rel_err(got, want) <= 5e-2, name


# -------------------------------------------------------------------- MoE --
# The MoE arm's experts (scripts/bench_packed_moe.py): 8 a layer, block
# (256, 256), s = 0.8, bf16; m = 512 rows an expert in training, 4 at a
# batch-4 decode step, and a ragged 200.
MOE_EXPERTS, MOE_BLOCK = 8, (256, 256)


@pytest.mark.cuda
@pytest.mark.parametrize('m', [4, 200, 512])
@pytest.mark.parametrize('k,n', [(1024, 4096), (4096, 1024)])
def test_moe_experts_match_plain(cuda_device, k, n, m):
  """_PackedExperts forward and backward at the MoE arm's shapes: one
  forward, dx and dw launch an expert (the decode branch at m = 4, in
  the forward and dx), and each expert's output, dx and dw against the
  plain versions on its own packing (bf16 rounding: 2e-2 of
  max(1, max |plain|))."""
  from rigl_tpu_torch.models import packed_moe as tmoe
  gen = torch.Generator().manual_seed(m + k)
  ex = tmoe._PackedExperts(k, n, MOE_EXPERTS, sparsity=0.8, block=MOE_BLOCK,
                           bm=512, dtype=torch.bfloat16, generator=gen,
                           device=cuda_device)
  xe = torch.randn(MOE_EXPERTS, m, k, generator=gen).to(
      cuda_device, torch.bfloat16).requires_grad_()
  gy = torch.randn(MOE_EXPERTS, m, n, generator=gen).to(cuda_device,
                                                         torch.bfloat16)
  counters = ('packed_mm_launches', 'packed_mm_dx_launches',
              'packed_dw_launches', 'mm_decode_launches')
  before = [getattr(tbsp, c) for c in counters]
  y = ex(xe)
  dx, dw = torch.autograd.grad(y, [xe, ex.kernel], gy)
  torch.cuda.synchronize()
  moved = [getattr(tbsp, c) - b for c, b in zip(counters, before)]
  assert moved == [MOE_EXPERTS] * 3 + [2 * MOE_EXPERTS * (m <= 32)]
  assert dw.dtype == torch.float32              # the master weights' grad
  w = ex.kernel.detach().to(torch.bfloat16)
  x = xe.detach()
  for e, pk in enumerate(ex.packing.experts):
    for name, got, want in (
        ('y', y[e].detach(), tbsp.packed_matmul_reference(x[e], w[e], pk,
                                                          MOE_BLOCK)),
        ('dx', dx[e], tbsp.packed_matmul_dx_reference(gy[e], w[e], pk,
                                                      MOE_BLOCK)),
        ('dw', dw[e], tbsp.packed_dw_reference(x[e], gy[e], pk, MOE_BLOCK,
                                               torch.bfloat16))):
      assert _rel(got, want) <= MM_TOL[torch.bfloat16], (name, e)


@pytest.mark.cuda
def test_moe_lm_step_on_card_matches_plain(cuda_device, monkeypatch):
  """One bf16 MoE PackedLMTrainer step on the card: per layer the two
  attention projections and the 2 x E expert matmuls launch forward, dx
  and dw once each; the loss (aux included) and every gradient agree with
  the plain path (the dense MoE twin holding the unpacked kernels) on the
  same state, batch and routing (the kernel path's expert choices replayed
  in the plain path, which bf16 rounding could otherwise flip)."""
  from torch.func import functional_call
  from rigl_tpu_torch.drivers.packed_lm import synthetic_stream
  from rigl_tpu_torch.models import packed_moe as tmoe
  from rigl_tpu_torch.parallel import packed_ep as tep
  from rigl_tpu_torch.train import packed_lm as tlm
  cfg = tlm.PackedLMConfig(vocab_size=64, num_layers=2, d_model=256,
                           d_ff=512, num_heads=2, seq_len=128,
                           sparsity=0.5, block=(128, 128), bm=128,
                           dtype='bfloat16', batch_size=2, seed=3,
                           n_experts=4)
  tr = tlm.PackedLMTrainer(cfg, device=cuda_device)
  tr.init_state()
  x, y = tr.sample_batch(synthetic_stream(5000, seed=3))
  params = tr.params
  real, routes = tep.top1_gather_dispatch, []

  def record(logits, capacity, token_axes=()):
    out = real(logits, capacity, token_axes)
    routes.append(out[:3])
    return out

  monkeypatch.setattr(tep, 'top1_gather_dispatch', record)
  before = (tbsp.packed_mm_launches, tbsp.packed_mm_dx_launches,
            tbsp.packed_dw_launches)
  loss = tr._loss(x, y)
  grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
  torch.cuda.synchronize()
  moved = tuple(a - b for a, b in zip(
      (tbsp.packed_mm_launches, tbsp.packed_mm_dx_launches,
       tbsp.packed_dw_launches), before))
  assert moved == (2 * (2 + 2 * 4),) * 3
  replay = iter(routes)

  def replayed(logits, capacity, token_axes=()):
    src, flat_ec, kept = next(replay)
    choice = flat_ec // capacity
    probs = torch.softmax(logits.float(), -1)
    aux = logits.shape[1] * torch.sum(torch.nn.functional.one_hot(
        choice, logits.shape[1]).float().mean(0) * probs.mean(0))
    return src, flat_ec, kept, probs.gather(1, choice[:, None])[:, 0], aux

  monkeypatch.setattr(tep, 'top1_gather_dispatch', replayed)
  views = {n: v.detach().clone().requires_grad_() for n, v in
           tlm.dense_twin_params({n: p.detach() for n, p in params.items()},
                                 tr.packings, cfg.block).items()}
  twin = tmoe.DenseMoETransformer(device=cuda_device, **cfg.model_kwargs())
  logits, aux = functional_call(twin, views, (x,), {'with_aux': True})
  plain_loss = tlm._lm_loss(logits, y) + cfg.aux_loss_weight * aux
  plain = dict(zip(views, torch.autograd.grad(plain_loss,
                                              list(views.values()))))
  loss, plain_loss = float(loss.detach()), float(plain_loss.detach())
  assert abs(loss - plain_loss) <= 2e-2 * abs(plain_loss)
  for name, g in grads.items():
    pk = tr.packings.get(name)
    if pk is not None:
      unpack = (tep.unpack_dense_experts if tep.is_expert_stacked(pk)
                else tbsp.unpack_dense)
      got = unpack(g, pk, cfg.block)
      want = plain[f'{name.rsplit(".", 1)[0]}.d.kernel'] * unpack(
          torch.ones_like(g), pk, cfg.block)
    else:
      got, want = g, plain[name]
    assert torch.isfinite(got).all(), name
    assert _rel_err(got, want) <= 5e-2, name


# --------------------------------------------------------------- tap conv --
# Kernel vs plain: both sum in f32 and round once, so they differ by the
# order of the f32 sums (f32) plus a bf16 ulp (bf16), relative to
# max(1, max |plain|).
TAP_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _tap_case(ksize, cin, cout, block, seed, empty=True):
  """A tap packing over a (kh, kw, cin, cout) kernel at density 0.4 with
  (when `empty`) cout-block 0 and tap 0 empty."""
  kh, kw = ksize
  t_dim, nk, nn_ = kh * kw, cin // block[0], cout // block[1]
  gen = torch.Generator().manual_seed(seed)
  occ = (torch.rand(t_dim, nk, nn_, generator=gen) < 0.4).to(torch.int32)
  if empty and nn_ > 1:
    occ[:, :, 0] = 0
  if empty and t_dim > 1:
    occ[0] = 0
  cols, rows, taps = tbsc.pack_tap_active(occ, int(occ.sum()))
  return {'cols': cols, 'rows': rows, 'taps': taps}, occ


def _tap_counts():
  return (tbsc.tap_conv_fwd_launches, tbsc.tap_conv_dx_launches,
          tbsc.tap_dw_launches)


# (block, cin, cout): blocks of 16s and 8s at narrow widths, then the
# wgmma branch's other output tiles (N = 32, 64, 128 and 128 over a 192-wide
# column) and RN50's block of 128.
TAP_BLOCKS = ([(b, ci, co) for b in ((16, 16), (16, 32), (32, 16), (8, 8))
               for ci, co in ((32, 32), (64, 32), (32, 96))]
              + [((32, 32), 64, 96), ((64, 64), 128, 192),
                 ((128, 128), 256, 256), ((128, 64), 256, 192),
                 ((64, 192), 128, 384), ((48, 80), 96, 160)])


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('block,cin,cout', TAP_BLOCKS)
@pytest.mark.parametrize('n,h,w', [(1, 5, 7), (3, 8, 8), (16, 4, 4),
                                   (1, 7, 7), (1, 1, 1), (2, 17, 19)])
@pytest.mark.parametrize('ksize', [(3, 3), (5, 5), (1, 1), (3, 5)])
def test_tap_kernels_match_plain(cuda_device, ksize, n, h, w, block, cin,
                                 cout, dtype):
  """Forward, dx and dw, each launched once, against their plain versions
  on the same index, in every branch of tap_branch (1x1: mm; f32: tf32;
  bf16: wgmma with blocks of 16s, tf32 with 8s), at ragged pixel counts
  (M = 35, 49, 1, 646: not multiples of the 128-pixel tile), 7x7 and 1x1
  images and batch 1, with an empty cout-block (zero output columns) and
  an empty tap."""
  packing, occ = _tap_case(ksize, cin, cout, block, n * 31 + cin + h)
  gen = torch.Generator().manual_seed(n + cin)
  x = torch.randn(n, h, w, cin, generator=gen).to(cuda_device, dtype)
  gy = torch.randn(n, h, w, cout, generator=gen).to(cuda_device, dtype)
  w4 = (torch.randn(*ksize, cin, cout, generator=gen) / 8).to(cuda_device,
                                                               dtype)
  index = tbsc.tap_index(packing, w4.shape, block)
  before = _tap_counts()
  got = (tbsc.tap_conv_cuda(x, w4, index), tbsc.tap_conv_cuda(gy, w4, index,
                                                              'dx'),
         tbsc.tap_dw_cuda(x, gy, w4, index))
  torch.cuda.synchronize()
  # dw of a packing with no active entry is zeros without a launch.
  assert _tap_counts() == (before[0] + 1, before[1] + 1,
                           before[2] + (index.n_entries > 0))
  want = (tbsc.tap_conv_reference(x, w4, index),
          tbsc.tap_conv_reference(gy, w4, index, 'dx'),
          tbsc.tap_dw_reference(x, gy, index, dtype))
  for name, g, r in zip(('fwd', 'dx', 'dw'), got, want):
    assert g.shape == r.shape and g.dtype == dtype, name
    scale = max(1.0, float(r.float().abs().max()))
    err = float((g.float() - r.float()).abs().max())
    assert err <= TAP_TOL[dtype] * scale, (name, err)
  for j in (occ.sum((0, 1)) == 0).nonzero().flatten().tolist():
    assert not got[0][..., j * block[1]:(j + 1) * block[1]].any()


@pytest.mark.cuda
@pytest.mark.parametrize('wide', [True, False])
@pytest.mark.parametrize('block,cin,cout', [((16, 16), 128, 128),
                                            ((16, 16), 48, 80),
                                            ((32, 16), 64, 96),
                                            ((16, 32), 96, 64),
                                            ((48, 48), 96, 144),
                                            ((64, 64), 128, 192)])
@pytest.mark.parametrize('n,h,w', [(1, 7, 7), (3, 9, 11), (2, 17, 19)])
@pytest.mark.parametrize('ksize', [(3, 3), (5, 5)])
def test_tap_wgmma_group_widths_match_plain(cuda_device, monkeypatch,
                                            ksize, n, h, w, block, cin,
                                            cout, wide):
  """The wgmma branch at both group widths tap_wgmma_gcols chooses from,
  forced: the widest groups (several block-columns a thread block, the
  union of their entries, each product only into the columns that hold
  the entry; a last group of fewer columns) and one column a group;
  forward and dx against the plain versions, an empty cout-block exactly
  zero, and a second launch bitwise equal."""
  packing, occ = _tap_case(ksize, cin, cout, block, n + h + cin)
  _force_gcols(monkeypatch, wide)
  gen = torch.Generator().manual_seed(h * cin)
  x = torch.randn(n, h, w, cin, generator=gen).to(cuda_device,
                                                  torch.bfloat16)
  gy = torch.randn(n, h, w, cout, generator=gen).to(cuda_device,
                                                    torch.bfloat16)
  w4 = (torch.randn(*ksize, cin, cout, generator=gen) / 8).to(
      cuda_device, torch.bfloat16)
  index = tbsc.tap_index(packing, w4.shape, block)
  for a, mode in ((x, 'fwd'), (gy, 'dx')):
    got = tbsc.tap_conv_cuda(a, w4, index, mode)
    again = tbsc.tap_conv_cuda(a, w4, index, mode)
    want = tbsc.tap_conv_reference(a, w4, index, mode)
    torch.cuda.synchronize()
    assert torch.equal(got, again), mode
    assert _rel(got, want) <= TAP_TOL[torch.bfloat16], (mode,
                                                        _rel(got, want))
  y = tbsc.tap_conv_cuda(x, w4, index)
  for j in (occ.sum((0, 1)) == 0).nonzero().flatten().tolist():
    assert not y[..., j * block[1]:(j + 1) * block[1]].any()


def _force_gcols(monkeypatch, wide):
  """tap_conv_cuda's group width forced: the widest (tap_group_cols) or
  one column a group."""
  monkeypatch.setattr(
      tbsc, 'tap_wgmma_gcols',
      lambda index, mode, *a: tbsc.tap_group_cols(
          index.bn if mode == 'fwd' else index.bk,
          (index.cout // index.bn) if mode == 'fwd'
          else (index.cin // index.bk)) if wide else 1)


@pytest.mark.cuda
@pytest.mark.parametrize('wide', [True, False])
@pytest.mark.parametrize('block', [(16, 16), (32, 16), (16, 32), (48, 48),
                                   (64, 64)])
def test_tap_wgmma_keeps_nonfinite_inputs_in_their_columns(cuda_device,
                                                           monkeypatch,
                                                           block, wide):
  """A non-finite input reaches only the output columns whose entries
  read it, as in the plain version, at both group widths: x's input block
  3 (NaN) is read by output column 0 alone and gy's block 3 (inf) by dx
  column 0 alone; output column 2 and dx column 2 have no entry and come
  out zeros; every other output is finite and matches the plain
  version."""
  bk, bn = block
  gen = torch.Generator().manual_seed(bk + 3 * bn)
  occ = (torch.rand(9, 4, 4, generator=gen) < 0.5).to(torch.int32)
  occ[:, 3, :] = 0
  occ[4, 3, 0] = 1        # x block 3: output column 0 only
  occ[:, :, 3] = 0
  occ[4, 0, 3] = 1        # gy block 3: dx column 0 only
  occ[:, :, 2] = 0        # an empty output column
  occ[:, 2, :] = 0        # an empty dx column
  occ[4, 1, 1] = 1
  cols, rows, taps = tbsc.pack_tap_active(occ, int(occ.sum()))
  _force_gcols(monkeypatch, wide)
  x = torch.randn(2, 9, 11, 4 * bk, generator=gen)
  gy = torch.randn(2, 9, 11, 4 * bn, generator=gen)
  x[..., 3 * bk:] = float('nan')
  gy[..., 3 * bn:] = float('inf')
  w4 = torch.randn(3, 3, 4 * bk, 4 * bn, generator=gen) / 8
  x, gy, w4 = (t.to(cuda_device, torch.bfloat16) for t in (x, gy, w4))
  index = tbsc.tap_index({'cols': cols, 'rows': rows, 'taps': taps},
                         w4.shape, block)
  for a, mode, out_w in ((x, 'fwd', bn), (gy, 'dx', bk)):
    got = tbsc.tap_conv_cuda(a, w4, index, mode)
    want = tbsc.tap_conv_reference(a, w4, index, mode)
    torch.cuda.synchronize()
    finite = torch.isfinite(want)
    assert not finite[..., :out_w].any() and finite[..., out_w:].all()
    assert torch.equal(torch.isfinite(got), finite), mode
    assert not got[..., 2 * out_w:3 * out_w].any(), mode
    assert _rel(got[..., out_w:], want[..., out_w:]) <= TAP_TOL[
        torch.bfloat16], mode


@pytest.mark.cuda
@pytest.mark.parametrize('block,cin,cout,hw', [((16, 16), 64, 64, 16),
                                               ((32, 32), 64, 96, 9),
                                               ((128, 128), 256, 256, 14),
                                               ((64, 64), 128, 192, 7)])
def test_tap_wgmma_branch_is_deterministic(cuda_device, block, cin, cout,
                                           hw):
  """The wgmma branch, forward and dx: a second launch gives the same bits
  (each output tile is one thread block's, summed in a fixed order, with
  no atomics)."""
  packing, _ = _tap_case((3, 3), cin, cout, block, hw)
  gen = torch.Generator().manual_seed(hw)
  x = torch.randn(8, hw, hw, cin, generator=gen).to(cuda_device,
                                                    torch.bfloat16)
  gy = torch.randn(8, hw, hw, cout, generator=gen).to(cuda_device,
                                                      torch.bfloat16)
  w4 = (torch.randn(3, 3, cin, cout, generator=gen) / 8).to(cuda_device,
                                                            torch.bfloat16)
  index = tbsc.tap_index(packing, w4.shape, block)
  assert tbsc.tap_branch(3, 3, *block, torch.bfloat16) == 'wgmma'
  for a, mode in ((x, 'fwd'), (gy, 'dx')):
    first = tbsc.tap_conv_cuda(a, w4, index, mode)
    second = tbsc.tap_conv_cuda(a, w4, index, mode)
    torch.cuda.synchronize()
    assert torch.equal(first, second), mode


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('block', [(128, 128), (64, 32), (16, 16)])
def test_tap_1x1_takes_the_mm_branch(cuda_device, dtype, block):
  """A 1x1 call takes the 'mm' branch: its forward and dx are bitwise
  equal to dense_mm_cuda (csrc/packed_mm.cu) on the index's DenseLists
  over w's (cin, cout) view, and tap_conv_fwd_launches /
  tap_conv_dx_launches still count the call.  A packed-storage 1x1 index
  is refused, launching nothing (PackedConv runs its 1x1s on
  packed_matmul)."""
  from rigl_tpu_torch.ops import block_sparse_v3 as tv3
  cin, cout = 2 * block[0], 3 * block[1]
  packing, occ = _tap_case((1, 1), cin, cout, block, block[1])
  gen = torch.Generator().manual_seed(block[0])
  x = torch.randn(3, 15, 17, cin, generator=gen).to(cuda_device, dtype)
  gy = torch.randn(3, 15, 17, cout, generator=gen).to(cuda_device, dtype)
  w4 = (torch.randn(1, 1, cin, cout, generator=gen) / 8).to(cuda_device,
                                                            dtype)
  index = tbsc.tap_index(packing, w4.shape, block)
  assert tbsc.tap_branch(1, 1, *block, dtype) == 'mm'
  for a, mode, width in ((x, 'fwd', cin), (gy, 'dx', cout)):
    before = _tap_counts()
    got = tbsc.tap_conv_cuda(a, w4, index, mode)
    after = _tap_counts()
    want = tv3.dense_mm_cuda(a.view(-1, width), w4.view(cin, cout),
                             index.mm_lists(mode, cuda_device), block, mode)
    torch.cuda.synchronize()
    assert after == (before[0] + (mode == 'fwd'),
                     before[1] + (mode == 'dx'), before[2])
    assert torch.equal(got.view(want.shape), want), mode
  wp = tbsp.pack_dense(w4.view(cin, cout), tbsp.make_packing(
      occ[0], int(occ.sum())), block).contiguous()
  pindex = tbsc.packed_tap_index(tbsp.make_packing(occ[0], int(occ.sum())),
                                 (1, 1), cin, block)
  for a, mode in ((x, 'fwd'), (gy, 'dx')):
    before = _tap_counts()
    with pytest.raises(ValueError, match='packed'):
      tbsc.tap_conv_cuda(a, wp, pindex, mode)
    assert _tap_counts() == before, mode


def _force_tf32(monkeypatch, wide):
  """tap_conv_cuda's tf32 (gcols, tile) forced: groups of TAP_TF32_GROUP
  16-channel block-columns (tile 32) wherever blocks are 16 wide, or one
  column a tile."""
  _force_tf32_groups(monkeypatch, tbsc.TAP_TF32_GROUP if wide else 1)


def _force_tf32_groups(monkeypatch, gcols):
  """tap_conv_cuda's tf32 (gcols, tile) forced: groups of `gcols` (halved
  down to what the kernel has: two 16-wide columns in tile 32; in bf16 two
  or four 8-wide ones in tile 16 or 32) where blocks are 16 (bf16: 8 or
  16) wide, else one column a tile."""
  def tile(index, mode, pixels, sms, dtype=torch.float32):
    out_w = index.bn if mode == 'fwd' else index.bk
    widths = (8, 16) if dtype == torch.bfloat16 else (16,)
    g = gcols if out_w in widths else 1
    while g > 1 and g * out_w > 32:
      g //= 2
    return (g, g * out_w) if g > 1 else (1, 16 if out_w <= 16 else 64)
  monkeypatch.setattr(tbsc, 'tap_tf32_tile', tile)


@pytest.mark.cuda
@pytest.mark.parametrize('wide', [True, False])
@pytest.mark.parametrize('ksize,block,cin,cout', [
    ((3, 3), (16, 16), 32, 32), ((5, 5), (32, 16), 64, 48),
    ((3, 5), (16, 32), 48, 64), ((3, 3), (128, 128), 256, 256)])
def test_tap_f32_kxk_takes_the_tf32_branch_and_repeats_bitwise(
    cuda_device, monkeypatch, ksize, block, cin, cout, wide):
  """f32 KxK takes the 'tf32' branch (tap_conv_3xtf32_kernel), forward and
  dx at both group widths: within TAP_TF32 of the plain version, and a
  second launch gives the same bits (each output tile is one thread
  block's, its products in a fixed order, with no atomics)."""
  assert tbsc.tap_branch(*ksize, *block, torch.float32) == 'tf32'
  _force_tf32(monkeypatch, wide)
  packing, _ = _tap_case(ksize, cin, cout, block, cin + cout)
  gen = torch.Generator().manual_seed(cout)
  x = torch.randn(3, 9, 11, cin, generator=gen).to(cuda_device)
  gy = torch.randn(3, 9, 11, cout, generator=gen).to(cuda_device)
  w4 = (torch.randn(*ksize, cin, cout, generator=gen) / 8).to(cuda_device)
  index = tbsc.tap_index(packing, w4.shape, block)
  for a, mode in ((x, 'fwd'), (gy, 'dx')):
    first = tbsc.tap_conv_cuda(a, w4, index, mode)
    second = tbsc.tap_conv_cuda(a, w4, index, mode)
    want = tbsc.tap_conv_reference(a, w4, index, mode)
    torch.cuda.synchronize()
    assert torch.equal(first, second), mode
    assert _rel(first, want) <= TAP_TOL[torch.float32], mode


@pytest.mark.cuda
@pytest.mark.parametrize('wide', [True, False])
@pytest.mark.parametrize('block', [(16, 16), (32, 16), (16, 32), (48, 48),
                                   (64, 64)])
def test_tap_tf32_keeps_nonfinite_inputs_in_their_columns(cuda_device,
                                                          monkeypatch,
                                                          block, wide):
  """The f32 twin of test_tap_wgmma_keeps_nonfinite_inputs_in_their_
  columns, at both group widths: x's input block 3 (NaN) is read by output
  column 0 alone and gy's block 3 (inf) by dx column 0 alone; output
  column 2 and dx column 2 have no entry and come out zeros; every other
  output is finite and matches the plain version (a group multiplies every
  column by every entry, so it must keep a non-finite x out of the columns
  that do not read it)."""
  bk, bn = block
  gen = torch.Generator().manual_seed(bk + 3 * bn)
  occ = (torch.rand(9, 4, 4, generator=gen) < 0.5).to(torch.int32)
  occ[:, 3, :] = 0
  occ[4, 3, 0] = 1        # x block 3: output column 0 only
  occ[:, :, 3] = 0
  occ[4, 0, 3] = 1        # gy block 3: dx column 0 only
  occ[:, :, 2] = 0        # an empty output column
  occ[:, 2, :] = 0        # an empty dx column
  occ[4, 1, 1] = 1
  cols, rows, taps = tbsc.pack_tap_active(occ, int(occ.sum()))
  _force_tf32(monkeypatch, wide)
  x = torch.randn(2, 9, 11, 4 * bk, generator=gen)
  gy = torch.randn(2, 9, 11, 4 * bn, generator=gen)
  x[..., 3 * bk:] = float('nan')
  gy[..., 3 * bn:] = float('inf')
  w4 = torch.randn(3, 3, 4 * bk, 4 * bn, generator=gen) / 8
  x, gy, w4 = (t.to(cuda_device) for t in (x, gy, w4))
  index = tbsc.tap_index({'cols': cols, 'rows': rows, 'taps': taps},
                         w4.shape, block)
  for a, mode, out_w in ((x, 'fwd', bn), (gy, 'dx', bk)):
    got = tbsc.tap_conv_cuda(a, w4, index, mode)
    want = tbsc.tap_conv_reference(a, w4, index, mode)
    torch.cuda.synchronize()
    finite = torch.isfinite(want)
    assert not finite[..., :out_w].any() and finite[..., out_w:].all()
    assert torch.equal(torch.isfinite(got), finite), mode
    assert not got[..., 2 * out_w:3 * out_w].any(), mode
    assert _rel(got[..., out_w:], want[..., out_w:]) <= TAP_TOL[
        torch.float32], mode


# The bf16 instance of the tf32 branch: blocks of 8s (a chunk of 8
# channels at (8, 8); at (16, 8) a full chunk forward, a chunk of 8 dx; at
# (24, 16) a full chunk and one of 8).
TAP_BF16_BLOCKS = [((8, 8), 32, 40), ((16, 8), 48, 32), ((24, 16), 48, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize('gcols', [1, 2, 4])
@pytest.mark.parametrize('ksize', [(3, 3), (5, 5)])
@pytest.mark.parametrize('block,cin,cout', TAP_BF16_BLOCKS)
def test_tap_bf16_blocks_of_8_match_plain(cuda_device, monkeypatch, block,
                                          cin, cout, ksize, gcols):
  """bf16 KxK at blocks of 8s takes the 'tf32' branch (tap_conv_tf32_
  kernel's bf16 instance, one tf32 product a k-step), forward and dx at
  every group width (one column a tile; groups of two 8- or 16-wide
  columns; of four 8-wide ones, a last group of fewer): within TAP_TOL of
  the plain version, a second launch bitwise equal, an empty output
  column exactly zero; and with x and gy scaled
  into bf16's subnormals (2^-130: every input below the smallest normal,
  2^-126), within the same tolerance of the plain version's own largest
  value or two of bf16's subnormal steps (2^-133), whichever is larger (a
  tf32 product that flushed subnormal inputs would give zeros, about 32
  steps off)."""
  assert tbsc.tap_branch(*ksize, *block, torch.bfloat16) == 'tf32'
  _force_tf32_groups(monkeypatch, gcols)
  packing, occ = _tap_case(ksize, cin, cout, block, cin + 3 * cout)
  gen = torch.Generator().manual_seed(cin * cout)
  x = torch.randn(3, 9, 11, cin, generator=gen)
  gy = torch.randn(3, 9, 11, cout, generator=gen)
  w4 = (torch.randn(*ksize, cin, cout, generator=gen) / 8).to(
      cuda_device, torch.bfloat16)
  index = tbsc.tap_index(packing, w4.shape, block)
  for a, mode in ((x, 'fwd'), (gy, 'dx')):
    for scale in (1.0, 2.0 ** -130):
      ab = (a * scale).to(cuda_device, torch.bfloat16)
      if scale < 1:
        assert bool((ab.float().abs() < 2.0 ** -126).all())
      first = tbsc.tap_conv_cuda(ab, w4, index, mode)
      second = tbsc.tap_conv_cuda(ab, w4, index, mode)
      want = tbsc.tap_conv_reference(ab, w4, index, mode)
      torch.cuda.synchronize()
      assert torch.equal(first, second), (mode, scale)
      top = float(want.float().abs().max())
      err = float((first.float() - want.float()).abs().max())
      floor = 1.0 if scale == 1 else 2.0 ** -132 / TAP_TOL[torch.bfloat16]
      assert top > 0 and err <= TAP_TOL[torch.bfloat16] * max(
          top, floor), (mode, scale, err, top)
  y = tbsc.tap_conv_cuda(x.to(cuda_device, torch.bfloat16), w4, index)
  for j in (occ.sum((0, 1)) == 0).nonzero().flatten().tolist():
    assert not y[..., j * block[1]:(j + 1) * block[1]].any()


@pytest.mark.cuda
@pytest.mark.parametrize('gcols', [1, 2, 4])
@pytest.mark.parametrize('block', [b for b, _, _ in TAP_BF16_BLOCKS])
def test_tap_bf16_tf32_keeps_nonfinite_inputs_in_their_columns(
    cuda_device, monkeypatch, block, gcols):
  """The bf16 twin of test_tap_tf32_keeps_nonfinite_inputs_in_their_
  columns at blocks of 8s, every group width: x's input block 3 (NaN) is
  read by output column 0 alone and gy's block 3 (inf) by dx column 0
  alone -- at a block of 8 its channels share a 16-channel x tile with
  block 2's, which column 0's neighbours read; output column 2 and dx
  column 2 have no entry and come out zeros; every other output is finite
  and matches the plain version."""
  bk, bn = block
  gen = torch.Generator().manual_seed(bk + 3 * bn)
  occ = (torch.rand(9, 4, 4, generator=gen) < 0.5).to(torch.int32)
  occ[:, 3, :] = 0
  occ[4, 3, 0] = 1        # x block 3: output column 0 only
  occ[:, :, 3] = 0
  occ[4, 0, 3] = 1        # gy block 3: dx column 0 only
  occ[:, :, 2] = 0        # an empty output column
  occ[:, 2, :] = 0        # an empty dx column
  occ[4, 1, 1] = 1
  cols, rows, taps = tbsc.pack_tap_active(occ, int(occ.sum()))
  _force_tf32_groups(monkeypatch, gcols)
  x = torch.randn(2, 9, 11, 4 * bk, generator=gen)
  gy = torch.randn(2, 9, 11, 4 * bn, generator=gen)
  x[..., 3 * bk:] = float('nan')
  gy[..., 3 * bn:] = float('inf')
  w4 = torch.randn(3, 3, 4 * bk, 4 * bn, generator=gen) / 8
  x, gy, w4 = (t.to(cuda_device, torch.bfloat16) for t in (x, gy, w4))
  index = tbsc.tap_index({'cols': cols, 'rows': rows, 'taps': taps},
                         w4.shape, block)
  for a, mode, out_w in ((x, 'fwd', bn), (gy, 'dx', bk)):
    got = tbsc.tap_conv_cuda(a, w4, index, mode)
    want = tbsc.tap_conv_reference(a, w4, index, mode)
    torch.cuda.synchronize()
    finite = torch.isfinite(want)
    assert not finite[..., :out_w].any() and finite[..., out_w:].all()
    assert torch.equal(torch.isfinite(got), finite), mode
    assert not got[..., 2 * out_w:3 * out_w].any(), mode
    assert _rel(got[..., out_w:], want[..., out_w:]) <= TAP_TOL[
        torch.bfloat16], mode


@pytest.mark.cuda
@pytest.mark.parametrize('ksize,h,w', [((5, 5), 12, 224), ((3, 3), 9, 224),
                                       ((5, 5), 20, 56), ((3, 5), 7, 112)])
def test_tap_tf32_halo_at_the_widest_image(cuda_device, ksize, h, w):
  """The tf32 branch at the widest image the repo's models take (224) and
  a 5x5 kernel, forward and dx against the plain version: where an input
  block's x tile (128 pixel rows plus the halo, W (kh / 2) + kw / 2 a
  side) would pass TAP_TF32_XROWS rows, its taps are split by tap row;
  below that one tile serves every tap of the block."""
  kh, kw = ksize
  packing, occ = _tap_case(ksize, 32, 48, (16, 16), w + kh)
  gen = torch.Generator().manual_seed(w)
  x = torch.randn(2, h, w, 32, generator=gen).to(cuda_device)
  gy = torch.randn(2, h, w, 48, generator=gen).to(cuda_device)
  w4 = (torch.randn(kh, kw, 32, 48, generator=gen) / 8).to(cuda_device)
  index = tbsc.tap_index(packing, w4.shape, (16, 16))
  halo = w * (kh // 2) + kw // 2
  split = tbsc.TAP_TF32_ROWS + 2 * halo > tbsc.TAP_TF32_XROWS
  for a, mode in ((x, 'fwd'), (gy, 'dx')):
    gcols, _ = tbsc.tap_tf32_tile(index, mode, 2 * h * w, 132)
    xrows = index.panel_lists(mode, 'cpu', gcols, w).xrows
    assert (xrows <= tbsc.TAP_TF32_ROWS + kw - 1) == split, (mode, xrows)
    got = tbsc.tap_conv_cuda(a, w4, index, mode)
    want = tbsc.tap_conv_reference(a, w4, index, mode)
    torch.cuda.synchronize()
    assert _rel(got, want) <= TAP_TOL[torch.float32], mode
  for j in (occ.sum((0, 1)) == 0).nonzero().flatten().tolist():
    assert not tbsc.tap_conv_cuda(x, w4, index)[..., 16 * j:16 * (j + 1)].any()


@pytest.mark.cuda
@pytest.mark.parametrize('ksize,h,w', [((3, 3), 5, 160), ((5, 5), 7, 80)])
def test_tap_tf32_block_128_at_a_wide_image(cuda_device, ksize, h, w):
  """The tf32 branch at block (128, 128), one column in tiles of 64, where
  an input block's x tile (128 pixel rows plus the span of its taps'
  shifts, up to W (kh / 2) + kw / 2 a side) holds more than 384 rows:
  forward and dx against the plain version, an empty column zeros."""
  kh, kw = ksize
  block = (128, 128)
  packing, occ = _tap_case(ksize, 256, 384, block, w + kh)
  gen = torch.Generator().manual_seed(w)
  x = torch.randn(2, h, w, 256, generator=gen).to(cuda_device)
  gy = torch.randn(2, h, w, 384, generator=gen).to(cuda_device)
  w4 = (torch.randn(kh, kw, 256, 384, generator=gen) / 16).to(cuda_device)
  index = tbsc.tap_index(packing, w4.shape, block)
  for a, mode in ((x, 'fwd'), (gy, 'dx')):
    assert tbsc.tap_tf32_tile(index, mode, 2 * h * w, 132) == (1, 64)
    xrows = index.panel_lists(mode, 'cpu', 1, w).xrows
    assert 384 < xrows <= tbsc.TAP_TF32_XROWS, (mode, xrows)
    got = tbsc.tap_conv_cuda(a, w4, index, mode)
    want = tbsc.tap_conv_reference(a, w4, index, mode)
    torch.cuda.synchronize()
    assert _rel(got, want) <= TAP_TOL[torch.float32], mode
  assert not tbsc.tap_conv_cuda(x, w4, index)[..., :128].any()


@pytest.mark.cuda
@pytest.mark.parametrize('wide', [True, False])
def test_tap_tf32_more_than_65535_pixel_tiles(cuda_device, monkeypatch,
                                              wide):
  """A call of more than 65535 x 128 pixels, which takes the tf32 branch in
  more than one launch (a grid's y holds at most 65535 pixel tiles):
  forward and dx against the plain version at both group widths."""
  _force_tf32(monkeypatch, wide)
  packing, _ = _tap_case((3, 3), 32, 32, (16, 16), 5, empty=False)
  gen = torch.Generator(device=cuda_device).manual_seed(5)
  x = torch.randn(1, 2900, 2900, 32, generator=gen, device=cuda_device)
  w4 = torch.randn(3, 3, 32, 32, generator=gen, device=cuda_device) / 8
  assert x[0, ..., 0].numel() > 65535 * tbsc.TAP_TF32_ROWS
  index = tbsc.tap_index(packing, w4.shape, (16, 16))
  for mode in ('fwd', 'dx'):
    got = tbsc.tap_conv_cuda(x, w4, index, mode)
    want = tbsc.tap_conv_reference(x, w4, index, mode)
    torch.cuda.synchronize()
    assert _rel(got, want) <= TAP_TOL[torch.float32], mode


@pytest.mark.cuda
def test_tap_branch_that_cannot_take_the_call_is_refused(cuda_device,
                                                        monkeypatch):
  """A branch named for what it cannot take raises and runs nothing else:
  wgmma for a block of 8s and for f32, mm for a 3x3, and tf32 for a group
  of two 8-wide columns in f32 (only its bf16 instance has that tile).
  tf32 takes a bf16 block of 8s (test_tap_bf16_blocks_of_8_match_plain)."""
  packing, _ = _tap_case((3, 3), 32, 32, (8, 8), 3)
  x = torch.randn(2, 6, 6, 32, device=cuda_device)
  w4 = torch.randn(3, 3, 32, 32, device=cuda_device)
  index = tbsc.tap_index(packing, w4.shape, (8, 8))
  for branch, dtype, err in (('wgmma', torch.bfloat16, RuntimeError),
                             ('wgmma', torch.float32, RuntimeError),
                             ('tf32', torch.float32, RuntimeError),
                             ('mm', torch.bfloat16, ValueError)):
    monkeypatch.setattr(tbsc, 'tap_branch', lambda *a, b=branch: b)
    if branch == 'tf32':   # two 8-wide columns a tile of 16
      monkeypatch.setattr(tbsc, 'tap_tf32_tile', lambda *a: (2, 16))
    before = _tap_counts()
    with pytest.raises(err):
      tbsc.tap_conv_cuda(x.to(dtype), w4.to(dtype), index)
    assert _tap_counts() == before, branch


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_tap_conv_autograd_on_card(cuda_device, dtype):
  """torch.autograd.grad through block_sparse_conv_tap (dense kernel, dense
  dw zero outside the active blocks) and packed_conv_tap (packed storage,
  packed dw) launches each kernel once and agrees with the plain
  versions; a call that needs no gradient skips the Function."""
  block = (16, 16)
  packing, occ = _tap_case((3, 3), 32, 48, block, 7)
  gen = torch.Generator().manual_seed(1)
  x = torch.randn(5, 6, 6, 32, generator=gen).to(cuda_device, dtype)
  g = torch.randn(5, 6, 6, 48, generator=gen).to(cuda_device, dtype)
  w4 = torch.randn(3, 3, 32, 48, generator=gen).to(cuda_device, dtype)
  xr, wr = x.clone().requires_grad_(), w4.clone().requires_grad_()
  before = _tap_counts()
  y = tbsc.block_sparse_conv_tap(xr, wr, packing, block)
  dx, dw = torch.autograd.grad(y, (xr, wr), g)
  torch.cuda.synchronize()
  assert _tap_counts() == tuple(c + 1 for c in before)
  index = tbsc.tap_index(packing, w4.shape, block)
  mask = torch.zeros(3, 3, 32, 48, device=cuda_device, dtype=dtype)
  for t, r, j in occ.nonzero().tolist():
    mask[t // 3, t % 3, r * 16:(r + 1) * 16, j * 16:(j + 1) * 16] = 1
  assert not (dw * (1 - mask)).any()
  for got, want in ((y.detach(), tbsc.tap_conv_reference(x, w4, index)),
                    (dx, tbsc.tap_conv_reference(g, w4, index, 'dx')),
                    (dw, tbsc.tap_dw_reference(x, g, index, dtype))):
    scale = max(1.0, float(want.float().abs().max()))
    assert float((got.float() - want.float()).abs().max()) <= (
        TAP_TOL[dtype] * scale)
  conv = PackedConv(32, 48, (3, 3), sparsity=0.6, block=block, dtype=dtype,
                    engine='tap', generator=gen, device=cuda_device)
  xr = x.clone().requires_grad_()
  before = _tap_counts()
  y = conv(xr)
  dx, dk = torch.autograd.grad(y, (xr, conv.kernel), g)
  torch.cuda.synchronize()
  assert _tap_counts() == tuple(c + 1 for c in before)
  assert dk.shape == conv.kernel.shape and dk.dtype == torch.float32
  ref = PackedConv(32, 48, (3, 3), sparsity=0.6, block=block, dtype=dtype,
                   engine='xla', generator=gen, device=cuda_device)
  ref.set_packing(conv.packing)
  with torch.no_grad():
    ref.kernel.copy_(conv.kernel)
  xr = x.clone().requires_grad_()
  y_ref = ref(xr)
  dx_ref, dk_ref = torch.autograd.grad(y_ref, (xr, ref.kernel), g)
  for got, want in ((y, y_ref), (dx, dx_ref), (dk, dk_ref)):
    assert _rel_err(got.detach(), want.detach()) <= TAP_TOL[dtype]
  with torch.no_grad():
    before = _tap_counts()
    conv(x)
    assert _tap_counts() == (before[0] + 1, before[1], before[2])


@pytest.mark.cuda
def test_tap_kernels_raise_on_what_they_do_not_take(cuda_device):
  """No silent plain path on the card: a block the 16-byte copies cannot
  tile, a dtype the kernels lack, mixed devices and wrong widths raise."""
  packing, _ = _tap_case((3, 3), 12, 12, (6, 6), 0, empty=False)
  x = torch.randn(2, 4, 4, 12, device=cuda_device)
  w4 = torch.randn(3, 3, 12, 12, device=cuda_device)
  with pytest.raises(ValueError, match='multiple of 4'):
    tbsc.block_sparse_conv_tap(x, w4, packing, (6, 6))
  packing, _ = _tap_case((3, 3), 16, 16, (16, 16), 0, empty=False)
  x = torch.randn(2, 4, 4, 16, device=cuda_device)
  w4 = torch.randn(3, 3, 16, 16, device=cuda_device)
  with pytest.raises(TypeError):
    tbsc.block_sparse_conv_tap(x.half(), w4.half(), packing, (16, 16))
  with pytest.raises(ValueError, match='one CUDA device'):
    tbsc.block_sparse_conv_tap(x, w4.cpu(), packing, (16, 16))
  index = tbsc.tap_index(packing, w4.shape, (16, 16))
  with pytest.raises(ValueError, match='channels'):
    tbsc.tap_conv_cuda(x[..., :8].contiguous(), w4, index)
  with pytest.raises(ValueError, match='even'):
    tbsc.tap_index(packing, (2, 2, 16, 16), (16, 16))


# ------------------------------------------- dense-storage modes (B7-B9) --
def _dense_case(nk, nn_, block, m, dtype, device, seed, kind):
  """An occupancy with an empty block-row and column ('edges'), none
  ('none') or neither, and x, W (K, N), gy on the card."""
  from rigl_tpu_torch.ops import block_sparse_v4 as tv4
  gen = torch.Generator().manual_seed(seed)
  occ = (torch.rand(nk, nn_, generator=gen) < 0.5).to(torch.int32)
  occ[0, 0] = 1
  if kind == 'edges':
    occ[nk - 1, :] = 0
    occ[:, nn_ - 1] = 0
    occ[0, 0] = 1
  elif kind == 'none':
    occ[:] = 0
  bk, bn = block
  x = torch.randn(m, nk * bk, generator=gen).to(device, dtype)
  w = torch.randn(nk * bk, nn_ * bn, generator=gen).to(device, dtype)
  gy = torch.randn(m, nn_ * bn, generator=gen).to(device, dtype)
  occ = occ.to(device)
  cols, rows = tv4.pack_flat_active(occ, int(occ.sum()))
  return occ, cols, rows, x, w, gy


def _rel(got, want):
  scale = max(1.0, float(want.float().abs().max()))
  return float((got.float() - want.float()).abs().max()) / scale


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,tol', [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize('block', [(128, 128), (16, 32), (64, 16)])
@pytest.mark.parametrize('m', [1, 7, 33, 200])
@pytest.mark.parametrize('kind', ['random', 'edges', 'none'])
def test_dense_modes_match_plain(cuda_device, kind, m, block, dtype, tol):
  """packed_mm_kernel's dense forward and dx and packed_dw_kernel's dense
  dw, from the flat packing (v4) and from the occupancy (v3), against
  their plain versions (one torch.matmul per active block, f32 sums, one
  rounding): ragged m, an empty block-row and column, no active block.
  Tolerances relative to max(1, max |plain|), as for the packed modes."""
  from rigl_tpu_torch.ops import block_sparse_v3 as tv3
  from rigl_tpu_torch.ops import block_sparse_v4 as tv4
  occ, cols, rows, x, w, gy = _dense_case(5, 4, block, m, dtype,
                                          cuda_device, m, kind)
  shape = tuple(w.shape)
  forms = {
      'v4': (tv4.flat_lists(cols, rows, block, shape),
             tv4.flat_lists(cols, rows, block, shape, 'dx'),
             tv4.flat_dw_entries(cols, rows), tv4.v4_matmul_cuda, tv4,
             ('v4_fwd_launches', 'v4_dx_launches')),
      'v3': (tv3.occupancy_lists(occ, block, shape[1]),
             tv3.occupancy_lists(occ, block, shape[1], 'dx'),
             tv3.occupancy_dw_entries(occ), tv3.v3_matmul_cuda, tv3,
             ('v3_fwd_launches', 'v3_dx_launches'))}
  for name, (fl, dl, ent, kern, mod, counters) in forms.items():
    before = [getattr(mod, c) for c in counters] + [tv3.dw_gather_launches]
    y = kern(x, w, fl, block)
    dx = kern(gy, w, dl, block, 'dx')
    dw = tv3.dense_dw_cuda(x, gy, w, ent, block)
    torch.cuda.synchronize()
    after = [getattr(mod, c) for c in counters] + [tv3.dw_gather_launches]
    # The flat form lists only active blocks: with none, dw launches
    # nothing and is all zeros.
    n_dw = int(ent.rows.numel() > 0)
    assert after == [before[0] + 1, before[1] + 1, before[2] + n_dw], name
    want = (tv3.dense_mm_reference(x, w, fl, block),
            tv3.dense_mm_reference(gy, w, dl, block, 'dx'),
            tv3.dense_dw_reference(x, gy, ent, block, dtype))
    for got, ref in zip((y, dx, dw), want):
      assert got.shape == ref.shape and got.dtype == dtype, name
      assert _rel(got, ref) <= tol, (name, _rel(got, ref))
    occ_c = occ.cpu()
    for j in (occ_c.sum(0) == 0).nonzero().flatten().tolist():
      assert not y[:, j * block[1]:(j + 1) * block[1]].any(), name
    for k in (occ_c.sum(1) == 0).nonzero().flatten().tolist():
      assert not dx[:, k * block[0]:(k + 1) * block[0]].any(), name
    mask = occ_c.repeat_interleave(block[0], 0).repeat_interleave(block[1], 1)
    assert not dw.cpu()[mask == 0].any(), name


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,tol', [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize('dw_mode', ['dense', 'gather'])
def test_dense_block_matmul_autograd_on_card(cuda_device, dw_mode, dtype,
                                             tol):
  """block_sparse_matmul_v4 / _v3 and block_sparse_conv1x1 on CUDA tensors:
  the forward, dx and (gather) dw kernels each launch once and give the
  plain versions' outputs and gradients."""
  from rigl_tpu_torch.ops import block_sparse_v3 as tv3
  from rigl_tpu_torch.ops import block_sparse_v4 as tv4
  from rigl_tpu_torch.ops import conv as tconv
  block = (32, 32)
  occ, cols, rows, x, w, gy = _dense_case(4, 6, block, 96, dtype,
                                          cuda_device, 3, 'edges')

  def grads(fn, device):
    xx = x.to(device).clone().requires_grad_()
    ww = w.to(device).clone().requires_grad_()
    y = fn(xx, ww, device)
    return (y.detach(),) + torch.autograd.grad(y, (xx, ww), gy.to(device))

  fns = {
      'v4': lambda a, b, d: tv4.block_sparse_matmul_v4(
          a, b, cols.to(d), rows.to(d), block, dw_mode=dw_mode),
      'v3': lambda a, b, d: tv3.block_sparse_matmul_v3(
          a, b, occ.to(d), block, dw_mode=dw_mode),
      'conv1x1 v4': lambda a, b, d: tconv.block_sparse_conv1x1(
          a.reshape(2, 6, 8, -1), b, {'cols': cols.to(d),
                                      'rows': rows.to(d)},
          1, block).reshape(96, -1)}
  for name, fn in fns.items():
    before = (tv4.v4_fwd_launches, tv4.v4_dx_launches, tv3.v3_fwd_launches,
              tv3.v3_dx_launches, tv3.dw_gather_launches)
    got = grads(fn, cuda_device)
    torch.cuda.synchronize()
    after = (tv4.v4_fwd_launches, tv4.v4_dx_launches, tv3.v3_fwd_launches,
             tv3.v3_dx_launches, tv3.dw_gather_launches)
    moved = [a - b for a, b in zip(after, before)]
    gather = int(dw_mode == 'gather' and name != 'conv1x1 v4')
    want_moved = ([1, 1, 0, 0, gather] if name != 'v3'
                  else [0, 0, 1, 1, gather])
    assert moved == want_moved, (name, moved)
    want = [t.to(cuda_device) for t in grads(fn, 'cpu')]
    for g, r in zip(got, want):
      assert _rel(g, r) <= tol, (name, _rel(g, r))


@pytest.mark.cuda
def test_dense_modes_raise_on_what_they_do_not_take(cuda_device):
  """No silent plain path on the card: mixed devices, a dtype the kernels
  lack, a block the 16-byte copies cannot tile, index lists off the
  card."""
  from rigl_tpu_torch.ops import block_sparse_v4 as tv4
  occ, cols, rows, x, w, gy = _dense_case(2, 2, (16, 16), 8, torch.float32,
                                          cuda_device, 0, 'random')
  with pytest.raises(ValueError, match='one CUDA device'):
    tv4.block_sparse_matmul_v4(x, w.cpu(), cols, rows, (16, 16))
  with pytest.raises(TypeError):
    tv4.block_sparse_matmul_v4(x.half(), w.half(), cols, rows, (16, 16))
  lists = tv4.flat_lists(cols, rows, (16, 16), tuple(w.shape))
  with pytest.raises(ValueError, match='int32'):
    tv4.v4_matmul_cuda(x, w, lists._replace(seg=lists.seg.cpu()), (16, 16))
  occ2, cols2, rows2, x2, w2, _ = _dense_case(2, 2, (6, 6), 8, torch.float32,
                                              cuda_device, 0, 'random')
  with pytest.raises(ValueError, match='multiple of 4'):
    tv4.block_sparse_matmul_v4(x2, w2, cols2, rows2, (6, 6))


# ------------------------------------------------------ flash in f32 ----
# f32 kernels: every product and P and dS in f32 on the CUDA cores, as the
# plain versions; outputs differ by f32 summation order over S and hd
# terms, relative to the largest plain value.
FLASH_F32_TOL = 1e-4


def _f32_counts():
  return (tfa.flash_fwd_f32_launches, tfa.flash_bwd_dkv_f32_launches,
          tfa.flash_bwd_dq_f32_launches)


@pytest.mark.cuda
@pytest.mark.parametrize('hd', [32, 64, 128])
@pytest.mark.parametrize('b,h,s', [(1, 1, 5), (2, 3, 64), (1, 2, 130),
                                   (2, 2, 1000), (4, 16, 512)])
def test_flash_f32_kernels_match_plain(cuda_device, b, h, s, hd):
  """The f32 forward, dK/dV and dQ kernels at S below, at and across the
  32-row tile, each launched once, against the plain versions (the
  backward fed the kernel's o and lse)."""
  gen = torch.Generator().manual_seed(s * 5 + hd)
  q, k, v, do = (torch.randn(b, h, s, hd, generator=gen).to(cuda_device)
                 for _ in range(4))
  scale = hd ** -0.5
  before = _f32_counts()
  o, lse = tfa.flash_fwd_cuda(q, k, v, scale)
  dq, dk, dv = tfa.flash_attention_bwd_cuda(q, k, v, o, lse, do, scale)
  torch.cuda.synchronize()
  assert _f32_counts() == tuple(n + 1 for n in before)
  want_o, want_lse = tfa.flash_attention_fwd_reference(q, k, v, scale)
  assert o.dtype == torch.float32
  assert _rel_err(o, want_o) <= FLASH_F32_TOL
  assert float((lse - want_lse).abs().max()) <= LSE_TOL * max(
      1.0, float(want_lse.abs().max()))
  want = tfa.flash_attention_bwd_reference(q, k, v, o, lse, do, scale)
  for name, got, ref in zip(('dq', 'dk', 'dv'), (dq, dk, dv), want):
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert torch.isfinite(got).all(), name
    assert _rel_err(got, ref) <= FLASH_F32_TOL, (name, _rel_err(got, ref))


@pytest.mark.cuda
@pytest.mark.parametrize('hd', [32, 64, 128])
def test_flash_attention_f32_autograd_on_card(cuda_device, hd):
  """torch.autograd.grad through flash_attention in f32 launches the f32
  kernels once each and agrees with autograd through the plain forward."""
  gen = torch.Generator().manual_seed(hd)
  q, k, v, do = (torch.randn(2, 4, 200, hd, generator=gen).to(cuda_device)
                 for _ in range(4))
  q, k, v = (t.requires_grad_() for t in (q, k, v))
  before = _f32_counts()
  o = tfa.flash_attention(q, k, v, hd ** -0.5)
  grads = torch.autograd.grad(o, (q, k, v), do)
  torch.cuda.synchronize()
  assert _f32_counts() == tuple(n + 1 for n in before)
  want_o, _ = tfa.flash_attention_fwd_reference(q, k, v, hd ** -0.5)
  want = torch.autograd.grad(want_o, (q, k, v), do)
  assert _rel_err(o.detach(), want_o.detach()) <= FLASH_F32_TOL
  for got, ref in zip(grads, want):
    assert _rel_err(got, ref) <= FLASH_F32_TOL


@pytest.mark.cuda
@pytest.mark.parametrize('where', ['q', 'do', 'lse'])
@pytest.mark.parametrize('hd', [32, 64, 128])
@pytest.mark.parametrize('s', [130, 512])
def test_flash_f32_backward_keeps_nan(cuda_device, s, hd, where):
  """A NaN made on the card (0 / 0) in one element of q, dO or lse at q
  row i0 of head 0 reaches dK / dV and dQ as in the plain versions: what
  depends on it (dK and dV rows <= i0, only dO's column of dV for a NaN in
  dO; dQ row i0) is NaN from both, and the kernels put NaN nowhere the
  plain versions do not.  The
  plain versions also take 0 x NaN over the masked half, which the
  kernels skip, so their NaN may reach further; where both are finite
  they agree within FLASH_F32_TOL.  The 3xTF32 split must keep NaN: a
  rounding that carried it into the sign bit would give finite
  gradients."""
  gen = torch.Generator().manual_seed(s + hd)
  q, k, v, do = (torch.randn(1, 2, s, hd, generator=gen).to(cuda_device)
                 for _ in range(4))
  scale = hd ** -0.5
  o, lse = tfa.flash_fwd_cuda(q, k, v, scale)
  d = tfa._rowsum_do_o(do, o)
  i0 = s * 5 // 9
  nan = torch.zeros((), device=cuda_device) / 0.
  if where == 'lse':
    lse[0, 0, i0] = nan
  else:
    {'q': q, 'do': do}[where][0, 0, i0, 3] = nan
  before = _f32_counts()
  dk, dv = tfa.flash_bwd_dkv_cuda(q, k, v, do, lse, d, scale)
  dq = tfa.flash_bwd_dq_cuda(q, k, v, do, lse, d, scale)
  torch.cuda.synchronize()
  assert _f32_counts()[1:] == tuple(n + 1 for n in before[1:])
  want_dk, want_dv = tfa.flash_bwd_dkv_reference(q, k, v, do, lse, d, scale)
  want_dq = tfa.flash_bwd_dq_reference(q, k, v, do, lse, d, scale)
  rows = torch.arange(s, device=cuda_device)[:, None]
  cols = torch.arange(hd, device=cuda_device)
  dv_cols = cols == 3 if where == 'do' else cols >= 0
  for name, got, ref, reached in (('dk', dk, want_dk, rows <= i0),
                                  ('dv', dv, want_dv, (rows <= i0) & dv_cols),
                                  ('dq', dq, want_dq, rows == i0)):
    must = torch.zeros_like(got, dtype=torch.bool)
    must[0, 0] = reached
    assert bool(torch.isnan(ref)[must].all()), name
    assert bool(torch.isnan(got)[must].all()), name
    assert not bool((torch.isnan(got) & ~torch.isnan(ref)).any()), name
    both = torch.isfinite(got) & torch.isfinite(ref)
    assert bool(both[:, 1].all()), name   # head 1 holds no NaN
    assert _rel_err(got[both], ref[both]) <= FLASH_F32_TOL, name


# ------------------------------------ history entries (B9', B10-B12) ----
def _history_counts():
  from rigl_tpu_torch.ops import block_sparse as tv1
  from rigl_tpu_torch.ops import block_sparse_v2 as tv2
  from rigl_tpu_torch.ops import block_sparse_v3 as tv3
  from rigl_tpu_torch.ops import block_sparse_v6 as tv6
  return dict(v1_fwd=tv1.v1_fwd_launches, v1_dx=tv1.v1_dx_launches,
              v1_dw=tv1.v1_dw_launches, v6_fwd=tv6.v6_fwd_launches,
              v6_dx=tv6.v6_dx_launches, gather=tv2.gather_launches,
              control=tv3.dense_control_launches,
              dw_gather=tv3.dw_gather_launches)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,tol', [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize('block', [(32, 64), (64, 32)])
@pytest.mark.parametrize('m', [1, 33, 200])
@pytest.mark.parametrize('kind', ['random', 'edges'])
def test_history_entries_match_plain(cuda_device, kind, m, block, dtype,
                                     tol):
  """block_sparse_matmul (B12: forward, dx, dw), block_sparse_matmul_v6
  (B10: forward and dx; dw a matmul), block_sparse_matmul_gather (B11)
  and pallas_dense_matmul (B9') on CUDA tensors: each launches its
  kernel once per product, under its own counter, and gives the plain
  versions' outputs and gradients (the same calls on CPU tensors), at a
  ragged m, bk != bn, and an empty block-row and block-column ('edges')
  that come out exactly zero."""
  from rigl_tpu_torch.ops import block_sparse as tv1
  from rigl_tpu_torch.ops import block_sparse_v2 as tv2
  from rigl_tpu_torch.ops import block_sparse_v3 as tv3
  from rigl_tpu_torch.ops import block_sparse_v6 as tv6
  occ, _, _, x, w, gy = _dense_case(4, 6, block, m, dtype, cuda_device,
                                    m + block[0], kind)
  bk, bn = block
  mask = occ.repeat_interleave(bk, 0).repeat_interleave(bn, 1).to(dtype)
  w = w * mask
  n_act = int(occ.sum())
  packings = {d: tv6.make_packing(occ.to(d), n_act)
              for d in (cuda_device, 'cpu')}

  def grads(fn, device):
    xx = x.to(device).clone().requires_grad_()
    ww = w.to(device).clone().requires_grad_()
    y = fn(xx, ww, device)
    return (y.detach(),) + torch.autograd.grad(y, (xx, ww), gy.to(device))

  fns = {
      'v1': (lambda a, b, d: tv1.block_sparse_matmul(a, b, occ.to(d), block),
             dict(v1_fwd=1, v1_dx=1, v1_dw=1)),
      'v6': (lambda a, b, d: tv6.block_sparse_matmul_v6(a, b, packings[d],
                                                        block),
             dict(v6_fwd=1, v6_dx=1))}
  for name, (fn, want_moved) in fns.items():
    before = _history_counts()
    got = grads(fn, cuda_device)
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in _history_counts().items() if
             v != before[k]}
    assert moved == want_moved, (name, moved)
    want = [t.to(cuda_device) for t in grads(fn, 'cpu')]
    for what, g, r in zip(('y', 'dx', 'dw'), got, want):
      assert g.dtype == dtype and g.shape == r.shape, (name, what)
      assert _rel(g, r) <= tol, (name, what, _rel(g, r))
    y, dx, dw = got
    occ_c = occ.cpu()
    for j in (occ_c.sum(0) == 0).nonzero().flatten().tolist():
      assert not y[:, j * bn:(j + 1) * bn].any(), name
    for k in (occ_c.sum(1) == 0).nonzero().flatten().tolist():
      assert not dx[:, k * bk:(k + 1) * bk].any(), name
    assert not dw[mask == 0].any(), name
  forward = {
      'gather': lambda a, b, d: tv2.block_sparse_matmul_gather(
          a, b, occ.to(d), block, 1),
      'control': lambda a, b, d: tv3.pallas_dense_matmul(a, b, (1,) + block)}
  for name, fn in forward.items():
    before = _history_counts()
    y = fn(x, w, cuda_device)
    torch.cuda.synchronize()
    assert _history_counts()[name] == before[name] + 1, name
    want = fn(x.cpu(), w.cpu(), 'cpu').to(cuda_device)
    assert y.dtype == dtype and _rel(y, want) <= tol, (name, _rel(y, want))


@pytest.mark.cuda
def test_v6_empty_column_is_zero_in_a_reused_nan_buffer(cuda_device):
  """An output column with no active block comes out exactly zero from
  torch.empty's memory, where the caching allocator has just taken back
  a NaN-filled buffer of the output's size."""
  from rigl_tpu_torch.ops import block_sparse_v6 as tv6
  occ, _, _, x, w, _ = _dense_case(4, 6, (32, 32), 64, torch.bfloat16,
                                   cuda_device, 5, 'edges')
  packing = tv6.make_packing(occ, int(occ.sum()))
  nan = torch.full((64, 6 * 32), float('nan'), dtype=torch.bfloat16,
                   device=cuda_device)
  del nan
  y = tv6.block_sparse_matmul_v6(x, w, packing, (32, 32))
  torch.cuda.synchronize()
  assert torch.isfinite(y).all()
  assert not y[:, 5 * 32:].any()


@pytest.mark.cuda
def test_history_entries_raise_on_what_they_do_not_take(cuda_device):
  """No silent plain path on the card: B11 and B9' refuse shapes that do
  not divide their tiles and a backward; float16 raises."""
  from rigl_tpu_torch.ops import block_sparse as tv1
  from rigl_tpu_torch.ops import block_sparse_v2 as tv2
  from rigl_tpu_torch.ops import block_sparse_v3 as tv3
  occ, _, _, x, w, _ = _dense_case(2, 2, (32, 32), 24, torch.float32,
                                   cuda_device, 0, 'random')
  with pytest.raises(ValueError, match='must divide tiles'):
    tv2.block_sparse_matmul_gather(x, w, occ, (32, 32), 16)
  with pytest.raises(ValueError, match='divide'):
    tv3.pallas_dense_matmul(x, w, (16, 32, 32))
  xg = x.clone().requires_grad_()
  with pytest.raises(NotImplementedError, match='no VJP'):
    tv2.block_sparse_matmul_gather(xg, w, occ, (32, 32), 8).sum().backward()
  with pytest.raises(TypeError):
    tv1.block_sparse_matmul(x.half(), w.half(), occ, (32, 32))


# ------------------------------------ the dw kernels' split of the m-sum --
# The split (ops/dw_split.py) adds the same f32 products in another order,
# so S = 1 and S > 1 agree to the order of f32 sums (1e-5 of the largest
# value) in f32, and in bf16 to one rounding of nearly equal sums (2^-7 of
# the largest value).  The same call twice gives the same bits: the
# partials are added in slice order, with no atomics.
SPLIT_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}
PLANNER = dw_split.split_plan


def _plan_slices(monkeypatch, slices):
  """Every dw plan from here on takes `slices` slices (within
  dw_split.fit) in place of the planned count; None, the planner's."""
  monkeypatch.setattr(dw_split, 'split_plan', PLANNER if slices is None else
                      lambda tiles, length, chunk, *_: dw_split.fit(
                          length, chunk, slices))


def _split_agree(a, b, dtype):
  return _rel(a, b) <= SPLIT_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,tol', [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize('block', [(128, 128), (64, 32), (32, 64), (16, 8),
                                   (192, 64), (256, 128)])
@pytest.mark.parametrize('m', [1, 50, 64, 200, 1000, 4099])
def test_packed_dw_split_matches_unsplit_and_plain(cuda_device, monkeypatch,
                                                   m, block, dtype, tol):
  """The packed dw at its planned split, at S = 1 and at S = 3 (or as
  many slices as m has chunks): each within the kernel tolerance of the
  plain version, the split and unsplit results within SPLIT_TOL, and each
  call bit-identical to a second one.  m below one chunk, ragged m,
  blocks narrower than a 128 tile, bk != bn, and blocks 128 does not
  divide."""
  grid = (3, 2, 4)
  packing = _packing(grid, m)
  gen = torch.Generator().manual_seed(m + block[0])
  x = torch.randn(m, grid[0] * block[0], generator=gen).to(cuda_device,
                                                          dtype)
  gy = torch.randn(m, grid[1] * block[1], generator=gen).to(cuda_device,
                                                           dtype)
  w = torch.zeros(grid[2], *block, device=cuda_device, dtype=dtype)
  want = tbsp.packed_dw_reference(x, gy, packing, block, dtype)
  got = {}
  for slices in (None, 1, 3):
    _plan_slices(monkeypatch, slices)
    before = tbsp.packed_dw_launches
    a = tbsp.packed_dw_cuda(x, gy, w, packing, block)
    b = tbsp.packed_dw_cuda(x, gy, w, packing, block)
    torch.cuda.synchronize()
    assert tbsp.packed_dw_launches == before + 2
    assert torch.equal(a, b), slices
    assert a.dtype == dtype and _rel(a, want) <= tol, (slices, _rel(a, want))
    got[slices] = a
  assert _split_agree(got[1], got[3], dtype), _rel(got[1], got[3])


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,tol', [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize('block', [(128, 128), (64, 32), (32, 64)])
@pytest.mark.parametrize('m', [7, 300, 2049])
def test_dense_dw_split_keeps_flagged_off_blocks_zero(cuda_device,
                                                      monkeypatch, m, block,
                                                      dtype, tol):
  """The dense-storage dw over every block with its occupancy flag (B12's
  entries) and over the active blocks alone (B9's), at S = 1 and S = 4:
  flagged-off and inactive blocks stay exactly zero, active ones match
  the plain version, split and unsplit agree, calls repeat bit for bit."""
  from rigl_tpu_torch.ops import block_sparse_v3 as tv3
  occ, _, _, x, w, gy = _dense_case(4, 3, block, m, dtype, cuda_device,
                                    m + 3, 'edges')
  mask = occ.cpu().repeat_interleave(block[0], 0).repeat_interleave(
      block[1], 1).to(cuda_device)
  nz = occ.cpu().nonzero()
  for entries in (tv3.occupancy_dw_entries(occ),
                  tv3.DwEntries(nz[:, 0].to(cuda_device, torch.int32),
                                nz[:, 1].to(cuda_device, torch.int32), None)):
    want = tv3.dense_dw_reference(x, gy, entries, block, dtype)
    got = {}
    for slices in (1, 4):
      _plan_slices(monkeypatch, slices)
      a, launched = tv3.dense_dw_launch(x, gy, w, entries, block)
      b, _ = tv3.dense_dw_launch(x, gy, w, entries, block)
      torch.cuda.synchronize()
      assert launched and torch.equal(a, b)
      assert not a[mask == 0].any()
      assert _rel(a, want) <= tol, (slices, _rel(a, want))
      got[slices] = a
    assert _split_agree(got[1], got[4], dtype)


@pytest.mark.cuda
def test_dense_dw_split_at_the_largest_rn50_shape(cuda_device, monkeypatch):
  """ResNet-50's largest 1x1 dw call, group2_block0/conv1 (401408 rows,
  256 -> 128, block (128, 128), both blocks active), in bf16: the planned
  split against the plain version and against S = 1, and bit-identical
  on repeat."""
  from rigl_tpu_torch.ops import block_sparse_v3 as tv3
  gen = torch.Generator(device=cuda_device).manual_seed(0)
  m, block = 401408, (128, 128)
  x = torch.randn(m, 256, generator=gen, device=cuda_device).to(
      torch.bfloat16)
  gy = torch.randn(m, 128, generator=gen, device=cuda_device).to(
      torch.bfloat16)
  w = torch.zeros(256, 128, device=cuda_device, dtype=torch.bfloat16)
  entries = tv3.DwEntries(
      torch.tensor([0, 1], dtype=torch.int32, device=cuda_device),
      torch.tensor([0, 0], dtype=torch.int32, device=cuda_device), None)
  plan = tbsp.dw_plan(m, 2, block, torch.bfloat16,
                      torch.cuda.get_device_properties(
                          cuda_device).multi_processor_count)
  assert plan.slices > 1
  a, _ = tv3.dense_dw_launch(x, gy, w, entries, block)
  b, _ = tv3.dense_dw_launch(x, gy, w, entries, block)
  _plan_slices(monkeypatch, 1)
  one, _ = tv3.dense_dw_launch(x, gy, w, entries, block)
  torch.cuda.synchronize()
  assert torch.equal(a, b)
  want = tv3.dense_dw_reference(x, gy, entries, block, torch.bfloat16)
  assert _rel(a, want) <= 2e-2
  assert _split_agree(a, one, torch.bfloat16)


# ----------------------------------- the f32 dw's tiles (3xTF32 wgmma) --
# (block, f32 tile of dw_tile): both tiles the rule names, each at blocks
# it covers whole, covers in part (masked rows and columns) and splits into
# several tiles.
F32_DW_TILES = [((512, 512), (128, 128)), ((192, 64), (128, 128)),
                ((128, 32), (128, 128)), ((128, 16), (64, 16)),
                ((64, 128), (128, 128)), ((32, 64), (128, 128)),
                ((64, 32), (128, 128)), ((16, 16), (64, 16))]


@pytest.mark.cuda
@pytest.mark.parametrize('block,tile', F32_DW_TILES)
@pytest.mark.parametrize('m', [5, 200, 4099])
def test_f32_dw_tiles_match_plain_and_repeat_bitwise(cuda_device, monkeypatch,
                                                    m, block, tile):
  """packed_dw_3xtf32_kernel at each tile dw_tile names, unsplit and at S
  = 3 (or as many slices as m has chunks): within the f32 tolerance of
  the plain version, split within SPLIT_TOL of unsplit, and each call
  bit-identical to a second; ragged m and m below one chunk."""
  assert tbsp.DW_TILES[tbsp.dw_tile(block, torch.float32)][:2] == tile
  grid = (3, 2, 4)
  packing = _packing(grid, m + block[1])
  gen = torch.Generator().manual_seed(m + block[0])
  x = torch.randn(m, grid[0] * block[0], generator=gen).to(cuda_device)
  gy = torch.randn(m, grid[1] * block[1], generator=gen).to(cuda_device)
  w = torch.zeros(grid[2], *block, device=cuda_device)
  want = tbsp.packed_dw_reference(x, gy, packing, block)
  got = {}
  for slices in (1, 3):
    _plan_slices(monkeypatch, slices)
    before = tbsp.packed_dw_launches
    a = tbsp.packed_dw_cuda(x, gy, w, packing, block)
    b = tbsp.packed_dw_cuda(x, gy, w, packing, block)
    torch.cuda.synchronize()
    assert tbsp.packed_dw_launches == before + 2
    assert torch.equal(a, b), slices
    assert _rel(a, want) <= 1e-4, (slices, _rel(a, want))
    got[slices] = a
  assert _split_agree(got[1], got[3], torch.float32), _rel(got[1], got[3])


@pytest.mark.cuda
@pytest.mark.parametrize('m,cin,cout', [(131072, 16, 32), (32768, 32, 64),
                                        (8192, 64, 128)])
def test_f32_dw_at_wrn_1x1_shapes(cuda_device, m, cin, cout):
  """Long-m 1x1 convs at block (16, 16): WRN-22-2's widths at batch 128
  (32 x 32, 16 x 16 and 8 x 8 pixels; its own shortcuts are dense convs,
  but a PackedConv1x1 there calls the packed dw so), half the blocks
  active: the 64 x 16 tile at three blocks an SM, the planned split,
  within the f32 tolerance of the plain version, bit-identical on
  repeat."""
  block = (16, 16)
  assert tbsp.DW_TILES[tbsp.dw_tile(block, torch.float32)] == (64, 16, 32, 3)
  nk, nn_ = cin // 16, cout // 16
  packing = _packing((nk, nn_, max(1, nk * nn_ // 2)), m)
  gen = torch.Generator(device=cuda_device).manual_seed(cin)
  x = torch.randn(m, cin, generator=gen, device=cuda_device)
  gy = torch.randn(m, cout, generator=gen, device=cuda_device)
  w = torch.zeros(packing.n_active, *block, device=cuda_device)
  a = tbsp.packed_dw_cuda(x, gy, w, packing, block)
  b = tbsp.packed_dw_cuda(x, gy, w, packing, block)
  torch.cuda.synchronize()
  assert torch.equal(a, b)
  assert _rel(a, tbsp.packed_dw_reference(x, gy, packing, block)) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize('slices', [1, 3])
@pytest.mark.parametrize('where', ['x', 'gy'])
@pytest.mark.parametrize('block', [(512, 512), (192, 64), (16, 16)])
def test_f32_dw_keeps_nan(cuda_device, monkeypatch, block, where, slices):
  """A NaN made on the card (0 / 0) in one element of x (row i0, column
  k0 of the last active block's block-row) or of gy (row i0, column n0 of
  its block-column) reaches exactly the dw entries the plain version puts
  it in (column k0 of every entry in that block-row, or column n0 of every
  entry in that block-column), unsplit and split, and no other: a box
  that reads the NaN's columns for a neighbouring block feeds only outputs
  the store masks.  Elsewhere the two agree within the f32 tolerance."""
  _plan_slices(monkeypatch, slices)
  grid, m = (3, 2, 4), 300
  packing = _packing(grid, block[0] + slices)
  gen = torch.Generator().manual_seed(block[1])
  x = torch.randn(m, grid[0] * block[0], generator=gen).to(cuda_device)
  gy = torch.randn(m, grid[1] * block[1], generator=gen).to(cuda_device)
  nan = torch.zeros((), device=cuda_device) / 0.
  i0 = m * 5 // 9
  rows, cols = (int(t[-1]) for t in packing.dw_index('cpu'))
  if where == 'x':
    x[i0, rows * block[0] + block[0] // 3] = nan
  else:
    gy[i0, cols * block[1] + block[1] // 2 + 4] = nan
  w = torch.zeros(grid[2], *block, device=cuda_device)
  got = tbsp.packed_dw_cuda(x, gy, w, packing, block)
  torch.cuda.synchronize()
  want = tbsp.packed_dw_reference(x, gy, packing, block)
  assert bool(torch.isnan(want).any())
  assert torch.equal(torch.isnan(got), torch.isnan(want))
  both = ~torch.isnan(want)
  assert _rel(got[both], want[both]) <= 1e-4


def _tap_groups_case(ksize, cin, cout, seed):
  """A tap packing, block (16, 16), whose first (cin-block, cout-block)
  pair holds every tap (groups of 9, and 25 taps in 9 + 9 + 7 at 5x5),
  whose second pair holds one tap, and whose last cout-block is empty."""
  kh, kw = ksize
  t_dim, nk, nn_ = kh * kw, cin // 16, cout // 16
  gen = torch.Generator().manual_seed(seed)
  occ = (torch.rand(t_dim, nk, nn_, generator=gen) < 0.4).to(torch.int32)
  occ[:, 0, 0] = 1
  occ[:, min(1, nk - 1), 1] = 0
  occ[t_dim // 2, min(1, nk - 1), 1] = 1
  occ[:, :, nn_ - 1] = 0
  cols, rows, taps = tbsc.pack_tap_active(occ, int(occ.sum()))
  return {'cols': cols, 'rows': rows, 'taps': taps}, occ


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('n,h,w', [(5, 9, 11), (3, 16, 16), (2, 32, 32)])
@pytest.mark.parametrize('ksize', [(3, 3), (5, 5), (1, 1)])
def test_tap_dw_groups_and_split_match_plain(cuda_device, monkeypatch, ksize,
                                             n, h, w, dtype):
  """tap_dw_kernel over groups of 9 taps (4 in f32) and of 1, a 5x5
  kernel, an empty output column and batches that are not multiples of
  16 (a 1x1 kernel takes the block dw of packed_mm.cu), at its planned
  split, at S = 1 and at S = 3 (or as many slices as the pixels have
  chunks): each within the kernel tolerance of the plain version, split
  and unsplit within SPLIT_TOL, each call bit-identical to a second."""
  packing, occ = _tap_groups_case(ksize, 32, 48, n + h)
  gen = torch.Generator().manual_seed(h * w)
  x = torch.randn(n, h, w, 32, generator=gen).to(cuda_device, dtype)
  gy = torch.randn(n, h, w, 48, generator=gen).to(cuda_device, dtype)
  w4 = torch.zeros(*ksize, 32, 48, device=cuda_device, dtype=dtype)
  index = tbsc.tap_index(packing, w4.shape, (16, 16))
  max_taps = tbsc.tap_dw_taps(index, dtype)
  sizes = index.dw_groups(max_taps).ptr.diff().tolist()
  assert 1 in sizes and (ksize == (1, 1) or max_taps in sizes)
  want = tbsc.tap_dw_reference(x, gy, index, dtype)
  got = {}
  for slices in (None, 1, 3):
    _plan_slices(monkeypatch, slices)
    before = tbsc.tap_dw_launches
    a = tbsc.tap_dw_cuda(x, gy, w4, index)
    b = tbsc.tap_dw_cuda(x, gy, w4, index)
    torch.cuda.synchronize()
    assert tbsc.tap_dw_launches == before + 2
    assert torch.equal(a, b), slices
    assert _rel(a, want) <= TAP_TOL[dtype], (slices, _rel(a, want))
    assert not a[..., 32:].any()            # the empty cout-block
    got[slices] = a
  assert _split_agree(got[1], got[3], dtype), _rel(got[1], got[3])


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('n,h,w', [(5, 9, 11), (2, 32, 32)])
@pytest.mark.parametrize('ksize', [(3, 3), (5, 5)])
def test_tap_dw_sparse_groups_match_plain(cuda_device, monkeypatch, ksize, n,
                                          h, w, dtype):
  """An index of about one tap a pair takes groups of TAP_SPARSE_TAPS
  taps (the kernel's 4-blocks-an-SM variant): at its planned split, S =
  1 and S = 3, within the kernel tolerance of the plain version, split
  and unsplit within SPLIT_TOL, each call bit-identical to a second, an
  empty output column exactly zero."""
  kh, kw = ksize
  gen = torch.Generator().manual_seed(h + kh)
  occ = (torch.rand(kh * kw, 4, 4, generator=gen)
         < 0.9 / (kh * kw)).to(torch.int32)
  occ[kh * kw // 2, 0, 0] = occ[0, 0, 0] = 1     # a pair of two taps
  occ[:, :, 3] = 0                               # an empty cout-block
  cols, rows, taps = tbsc.pack_tap_active(occ, int(occ.sum()))
  index = tbsc.tap_index({'cols': cols, 'rows': rows, 'taps': taps},
                         (kh, kw, 64, 64), (16, 16))
  assert tbsc.tap_dw_taps(index, dtype) == tbsc.TAP_SPARSE_TAPS
  x = torch.randn(n, h, w, 64, generator=gen).to(cuda_device, dtype)
  gy = torch.randn(n, h, w, 64, generator=gen).to(cuda_device, dtype)
  w4 = torch.zeros(kh, kw, 64, 64, device=cuda_device, dtype=dtype)
  want = tbsc.tap_dw_reference(x, gy, index, dtype)
  got = {}
  for slices in (None, 1, 3):
    _plan_slices(monkeypatch, slices)
    a = tbsc.tap_dw_cuda(x, gy, w4, index)
    b = tbsc.tap_dw_cuda(x, gy, w4, index)
    torch.cuda.synchronize()
    assert torch.equal(a, b), slices
    assert _rel(a, want) <= TAP_TOL[dtype], (slices, _rel(a, want))
    assert not a[..., 48:].any()
    got[slices] = a
  assert _split_agree(got[1], got[3], dtype), _rel(got[1], got[3])


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('block', [(16, 16), (64, 32), (128, 128)])
def test_tap_dw_of_a_packed_1x1_kernel_matches_plain(cuda_device, dtype,
                                                     block):
  """A 1x1 kernel in packed storage: its dw runs on packed_mm.cu's block
  dw kernels, slot e for entry e of the index, and matches the plain
  version; the packed dw has no element outside an entry."""
  gen = torch.Generator().manual_seed(block[0])
  cin, cout = 2 * block[0], 3 * block[1]
  occ = (torch.rand(2, 3, generator=gen) < 0.6).to(torch.int32)
  occ[0, 0] = 1
  packing = tbsp.make_packing(occ, int(occ.sum()))
  index = tbsc.packed_tap_index(packing, (1, 1), cin, block)
  x = torch.randn(3, 5, 7, cin, generator=gen).to(cuda_device, dtype)
  gy = torch.randn(3, 5, 7, cout, generator=gen).to(cuda_device, dtype)
  w = torch.zeros(index.w_shape, device=cuda_device, dtype=dtype)
  before = tbsc.tap_dw_launches
  got = tbsc.tap_dw_cuda(x, gy, w, index)
  torch.cuda.synchronize()
  assert tbsc.tap_dw_launches == before + 1
  want = tbsc.tap_dw_reference(x, gy, index, dtype)
  assert got.shape == want.shape and _rel(got, want) <= TAP_TOL[dtype]


@pytest.mark.cuda
def test_tap_dw_packed_storage_split_matches_plain(cuda_device, monkeypatch):
  """The packed-storage tap dw (every element of dw is some entry's) at
  the WRN-22-2 first-group shape, batch 128 of 32 x 32, 32 -> 32, in bf16
  and f32, planned split against the plain version and S = 1."""
  gen = torch.Generator().manual_seed(2)
  for dtype in (torch.bfloat16, torch.float32):
    conv = PackedConv(32, 32, (3, 3), sparsity=0.4, block=(16, 16),
                      dtype=dtype, engine='tap', generator=gen,
                      device=cuda_device)
    index = tbsc.packed_tap_index(conv.packing, (3, 3), 32, (16, 16))
    x = torch.randn(128, 32, 32, 32, generator=gen).to(cuda_device, dtype)
    gy = torch.randn(128, 32, 32, 32, generator=gen).to(cuda_device, dtype)
    w = torch.zeros(index.w_shape, device=cuda_device, dtype=dtype)
    a = tbsc.tap_dw_cuda(x, gy, w, index)
    _plan_slices(monkeypatch, 1)
    one = tbsc.tap_dw_cuda(x, gy, w, index)
    _plan_slices(monkeypatch, None)
    torch.cuda.synchronize()
    want = tbsc.tap_dw_reference(x, gy, index, dtype)
    assert _rel(a, want) <= TAP_TOL[dtype]
    assert _split_agree(a, one, dtype)


# ----------------------------- the forward / dx kernels' branches --------
# block_sparse_packed.mm_branch names the branch of each forward / dx call
# (csrc/packed_mm.cu dispatch_mm): decode at m <= 32, ffma in f32, wgmma in
# bf16 at the tile mm_tile names (any contraction of whole 16-byte copies).
MM_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def _mm_forms(occ, block, w, device):
  """{form: (fwd call, dx call, plain fwd, plain dx)} of one occupancy
  over the dense W (K, N): packed storage (w's active blocks, packed) and
  the dense list forms v4, v3, v6 and B12, each through its own wrapper."""
  from rigl_tpu_torch.ops import block_sparse as tv1
  from rigl_tpu_torch.ops import block_sparse_v3 as tv3
  from rigl_tpu_torch.ops import block_sparse_v4 as tv4
  from rigl_tpu_torch.ops import block_sparse_v6 as tv6
  nk, nn_ = occ.shape
  n = w.shape[1]
  n_act = int(occ.sum())
  occ_c = occ.cpu()
  packing = tbsp.make_packing(occ_c, n_act)
  wp = tbsp.pack_dense(w, packing, block).contiguous()
  cols, rows = tv4.pack_flat_active(occ, n_act)
  p6 = tv6.make_packing(occ, n_act)
  lists = {
      'v4': (tv4.v4_matmul_cuda,
             tv4.flat_lists(cols, rows, block, tuple(w.shape)),
             tv4.flat_lists(cols, rows, block, tuple(w.shape), 'dx')),
      'v3': (tv3.v3_matmul_cuda, tv3.occupancy_lists(occ, block, n),
             tv3.occupancy_lists(occ, block, n, 'dx')),
      'v6': (tv6.v6_matmul_cuda,
             tv6.entry_lists(*p6['fwd'], block, n, nn_),
             tv6.entry_lists(*p6['bwd'], block, n, nk, 'dx')),
      'v1': (tv1.v1_matmul_cuda, tv3.occupancy_lists(occ, block, n),
             tv3.occupancy_lists(occ, block, n, 'dx'))}
  cpu = lambda ls: type(ls)(*(t.cpu() for t in ls))  # noqa: E731
  forms = {'packed': (
      lambda x: tbsp.packed_matmul_cuda(x, wp, packing, block),
      lambda gy: tbsp.packed_matmul_dx_cuda(gy, wp, packing, block),
      lambda x: tbsp.packed_matmul_reference(x, wp, packing, block),
      lambda gy: tbsp.packed_matmul_dx_reference(gy, wp, packing, block))}
  for name, (kern, fl, dl) in lists.items():
    forms[name] = (
        lambda x, kern=kern, fl=fl: kern(x, w, fl, block),
        lambda gy, kern=kern, dl=dl: kern(gy, w, dl, block, 'dx'),
        lambda x, fl=cpu(fl): tv3.dense_mm_reference(x, w, fl, block),
        lambda gy, dl=cpu(dl): tv3.dense_mm_reference(gy, w, dl, block,
                                                      'dx'))
  return forms


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('block', [(128, 128), (64, 192), (192, 64)])
@pytest.mark.parametrize('m', [33, 64, 1000, 1024])
def test_mm_branches_match_plain(cuda_device, m, block, dtype):
  """The wgmma (bf16) and ffma (f32) branches, forward and dx, in packed
  storage and through the v4, v3, v6 and B12 lists: ragged m, bn = 64, an
  out_w (192) that 128 does not divide, an empty block-row and column
  (exactly zero); against the plain versions, relative to max(1,
  max |plain|)."""
  bk, bn = block
  occ, _, _, x, w, gy = _dense_case(3, 4, block, m, dtype, cuda_device,
                                    m + bk, 'edges')
  want_branch = 'wgmma' if dtype == torch.bfloat16 else 'ffma'
  assert tbsp.mm_branch(m, bk, dtype) == want_branch
  assert tbsp.mm_branch(m, bn, dtype) == want_branch
  occ_c = occ.cpu()
  for name, (fwd, dx, pfwd, pdx) in _mm_forms(occ, block, w,
                                              cuda_device).items():
    y, g = fwd(x), dx(gy)
    torch.cuda.synchronize()
    for got, want in ((y, pfwd(x)), (g, pdx(gy))):
      assert got.shape == want.shape and got.dtype == dtype, name
      assert _rel(got, want) <= MM_TOL[dtype], (name, _rel(got, want))
    for j in (occ_c.sum(0) == 0).nonzero().flatten().tolist():
      assert not y[:, j * bn:(j + 1) * bn].any(), name
    for k in (occ_c.sum(1) == 0).nonzero().flatten().tolist():
      assert not g[:, k * bk:(k + 1) * bk].any(), name


@pytest.mark.cuda
@pytest.mark.parametrize('block', [(96, 96), (32, 64), (64, 32)])
def test_mm_ragged_contraction_takes_the_wgmma_branch(cuda_device,
                                                     monkeypatch, block):
  """A bf16 contraction per active that 64 does not divide takes the
  wgmma branch, at its tile, and matches the plain versions; a tile code
  the kernel does not have, named for it, is refused: the wrapper raises,
  nothing falls back."""
  bk, bn = block
  m = 1000
  occ, _, _, x, w, gy = _dense_case(3, 4, block, m, torch.bfloat16,
                                    cuda_device, bk, 'edges')
  for seg in (bk, bn):
    assert tbsp.mm_branch(m, seg, torch.bfloat16) == 'wgmma'
  for name, (fwd, dx, pfwd, pdx) in _mm_forms(occ, block, w,
                                              cuda_device).items():
    assert _rel(fwd(x), pfwd(x)) <= 2e-2, name
    assert _rel(dx(gy), pdx(gy)) <= 2e-2, name
  monkeypatch.setattr(tbsp, 'mm_tile', lambda *a: len(tbsp.MM_TILES))
  for name, (fwd, dx, _, _) in _mm_forms(occ, block, w,
                                         cuda_device).items():
    for call, a in ((fwd, x), (dx, gy)):
      with pytest.raises(RuntimeError, match='launch failed'):
        call(a)


# Ragged segments of whole 16-byte copies (8-200 bf16), each with a
# column width of another remainder, at every tile of the wgmma branch.
MM_RAGGED_BLOCKS = [(8, 24), (16, 40), (24, 8), (40, 16), (96, 200),
                    (200, 96)]


@pytest.mark.cuda
@pytest.mark.parametrize('tile', range(len(tbsp.MM_TILES)))
@pytest.mark.parametrize('block', MM_RAGGED_BLOCKS)
def test_mm_wgmma_tiles_match_plain_and_repeat_bitwise(cuda_device,
                                                      monkeypatch, block,
                                                      tile):
  """Every tile of the wgmma branch (TN x KC, forced), forward and dx, in
  packed storage and through the v4, v3, v6 and B12 lists, at ragged
  segments: against the plain versions, a second call bitwise equal, an
  empty block-row and column exactly zero."""
  bk, bn = block
  monkeypatch.setattr(tbsp, 'mm_tile', lambda *a: tile)
  occ, _, _, x, w, gy = _dense_case(3, 4, block, 200, torch.bfloat16,
                                    cuda_device, bk + bn, 'edges')
  occ_c = occ.cpu()
  for name, (fwd, dx, pfwd, pdx) in _mm_forms(occ, block, w,
                                              cuda_device).items():
    y, g = fwd(x), dx(gy)
    y2, g2 = fwd(x), dx(gy)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(g, g2), name
    assert _rel(y, pfwd(x)) <= MM_TOL[torch.bfloat16], name
    assert _rel(g, pdx(gy)) <= MM_TOL[torch.bfloat16], name
    for j in (occ_c.sum(0) == 0).nonzero().flatten().tolist():
      assert not y[:, j * bn:(j + 1) * bn].any(), name
    for k in (occ_c.sum(1) == 0).nonzero().flatten().tolist():
      assert not g[:, k * bk:(k + 1) * bk].any(), name


@pytest.mark.cuda
@pytest.mark.parametrize('tile', range(len(tbsp.MM_TILES)))
@pytest.mark.parametrize('block', [(8, 24), (40, 16), (96, 200)])
def test_mm_wgmma_keeps_nonfinite_in_its_segment_and_block(cuda_device,
                                                          monkeypatch,
                                                          block, tile):
  """At every tile, forced: a NaN segment of x (inf of gy for dx) reaches
  only the output block-columns whose actives read it, and an inf in one
  W block only the outputs that read that block; every other output has
  the bits of the call with those values zeroed, which matches the plain
  version: no box reads past its segment or its block, so nothing
  multiplies a neighbour's non-finite value, even by zeros."""
  bk, bn = block
  monkeypatch.setattr(tbsp, 'mm_tile', lambda *a: tile)
  occ = torch.tensor([[1, 1, 0], [0, 1, 1], [1, 0, 1]], dtype=torch.int32)
  n_act = int(occ.sum())
  packing = tbsp.make_packing(occ, n_act)
  gen = torch.Generator().manual_seed(bk + tile)
  w = (torch.randn(n_act, bk, bn, generator=gen) / 8).to(cuda_device,
                                                         torch.bfloat16)
  calls = {'fwd': (tbsp.packed_matmul_cuda, tbsp.packed_matmul_reference,
                   3 * bk, bn, occ[1]),     # x segment 1: block-row 1
           'dx': (tbsp.packed_matmul_dx_cuda,
                  tbsp.packed_matmul_dx_reference, 3 * bn, bk,
                  occ[:, 2])}               # gy segment 2: block-column 2
  for mode, (call, plain, width, out_w, reads) in calls.items():
    seg = 1 if mode == 'fwd' else 2
    seg_w = width // 3
    clean = torch.randn(150, width, generator=gen).to(cuda_device,
                                                      torch.bfloat16)
    bad, zeroed = clean.clone(), clean.clone()
    bad[:, seg * seg_w:(seg + 1) * seg_w] = float(
        'nan' if mode == 'fwd' else 'inf')
    zeroed[:, seg * seg_w:(seg + 1) * seg_w] = 0
    got, ref = call(bad, w, packing, block), call(zeroed, w, packing, block)
    torch.cuda.synchronize()
    for j in range(3):
      span = slice(j * out_w, (j + 1) * out_w)
      if reads[j]:
        assert not bool(torch.isfinite(got[:, span]).any()), (mode, j)
      else:
        assert torch.equal(got[:, span], ref[:, span]), (mode, j)
    assert _rel(ref, plain(zeroed, w, packing, block)) <= MM_TOL[
        torch.bfloat16], mode
    # An inf in W's slot 0, block (0, 0): only the outputs that read it,
    # output block-column 0 (dx: block-row 0).
    w_inf = w.clone()
    w_inf[0] = float('inf')
    got = call(clean, w_inf, packing, block)
    ref = call(clean, w, packing, block)
    torch.cuda.synchronize()
    assert not bool(torch.isfinite(got[:, :out_w]).any()), mode
    assert torch.equal(got[:, out_w:], ref[:, out_w:]), mode


@pytest.mark.cuda
@pytest.mark.parametrize('block', [(8, 24), (64, 64)])
def test_mm_wgmma_more_than_65535_m_tiles(cuda_device, block):
  """A bf16 call of more than 65535 x 128 rows runs the wgmma branch in
  more than one launch (a grid's y holds at most 65535 m-tiles), each
  over its own rows: forward and dx against the plain versions."""
  bk, bn = block
  m = 65535 * tbsp.MM_TILE_ROWS + 300
  occ = torch.tensor([[1, 0], [1, 1]], dtype=torch.int32)
  packing = tbsp.make_packing(occ, int(occ.sum()))
  gen = torch.Generator(device=cuda_device).manual_seed(bk)
  w = (torch.randn(3, bk, bn, generator=gen, device=cuda_device) / 8).to(
      torch.bfloat16)
  for call, plain, width in (
      (tbsp.packed_matmul_cuda, tbsp.packed_matmul_reference, 2 * bk),
      (tbsp.packed_matmul_dx_cuda, tbsp.packed_matmul_dx_reference,
       2 * bn)):
    a = torch.randn(m, width, generator=gen, device=cuda_device).to(
        torch.bfloat16)
    assert tbsp.mm_branch(m, width // 2, torch.bfloat16) == 'wgmma'
    got = call(a, w, packing, block)
    want = plain(a, w, packing, block)
    torch.cuda.synchronize()
    assert _rel(got, want) <= MM_TOL[torch.bfloat16], call.__name__
    del a, got, want


@pytest.mark.cuda
def test_mm_branch_of_another_dtype_is_refused(cuda_device, monkeypatch):
  """A branch named for another dtype (wgmma for f32, ffma for bf16) is
  refused, not run."""
  occ, _, _, x, w, _ = _dense_case(2, 2, (64, 64), 64, torch.float32,
                                   cuda_device, 0, 'edges')
  for branch, dtype in (('wgmma', torch.float32), ('ffma', torch.bfloat16)):
    fwd = _mm_forms(occ, (64, 64), w.to(dtype), cuda_device)['v3'][0]
    monkeypatch.setattr(tbsp, 'mm_branch', lambda *a, b=branch: b)
    with pytest.raises(RuntimeError, match='launch failed'):
      fwd(x.to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_mm_empty_column_is_zero_in_a_reused_nan_buffer(cuda_device, dtype):
  """wgmma and ffma: an output column with no active block comes out
  exactly zero from torch.empty's memory, where the caching allocator has
  just taken back a NaN-filled buffer of the output's size; packed and
  dense storage."""
  occ, _, _, x, w, gy = _dense_case(4, 6, (64, 64), 1024, dtype,
                                    cuda_device, 5, 'edges')
  for name, (fwd, dx, _, _) in _mm_forms(occ, (64, 64), w,
                                         cuda_device).items():
    for call, a, width in ((fwd, x, 6 * 64), (dx, gy, 4 * 64)):
      nan = torch.full((1024, width), float('nan'), dtype=dtype,
                       device=cuda_device)
      del nan
      got = call(a)
      torch.cuda.synchronize()
      assert torch.isfinite(got).all(), name
      assert not got[:, width - 64:].any(), name


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_mm_repeated_calls_are_bitwise_equal(cuda_device, dtype):
  """The same call twice gives the same bits: each output tile is one
  thread block's, summed in a fixed order, with no atomics."""
  occ, _, _, x, w, gy = _dense_case(4, 4, (128, 128), 1000, dtype,
                                    cuda_device, 9, 'edges')
  for name, (fwd, dx, _, _) in _mm_forms(occ, (128, 128), w,
                                         cuda_device).items():
    assert torch.equal(fwd(x), fwd(x)), name
    assert torch.equal(dx(gy), dx(gy)), name


@pytest.mark.cuda
def test_mm_ffma_is_bitwise_equal_to_the_decode_kernel(cuda_device,
                                                      monkeypatch):
  """f32 at the MLP training shape (m = 1024, 4096 x 4096, block (512,
  512), s = 0.8): packed_mm_ffma_kernel gives the same bits as
  packed_mm_decode_kernel's f32 instance, forced onto m = 1024 (its
  tiles of 32 rows, its contraction in 128-byte chunks, S = 1 there),
  forward and dx, packed and dense: each output is one fmaf chain over
  the actives in list order and k ascending in both."""
  from rigl_tpu_torch.sparsity.distributions import get_n_zeros
  gen = torch.Generator().manual_seed(4)
  nb, block = 8, (512, 512)
  n_act = nb * nb - get_n_zeros(nb * nb, 0.8)
  occ = random_occupancy(gen, nb, nb, n_act).to(cuda_device)
  w = (torch.randn(4096, 4096, generator=gen) / 64).to(cuda_device)
  x = torch.randn(1024, 4096, generator=gen).to(cuda_device)
  gy = torch.randn(1024, 4096, generator=gen).to(cuda_device)
  forms = _mm_forms(occ, block, w, cuda_device)
  assert tbsp.mm_branch(1024, 512, torch.float32) == 'ffma'
  new = {name: (f[0](x), f[1](gy)) for name, f in forms.items()
         if name in ('packed', 'v3')}
  monkeypatch.setattr(tbsp, 'mm_branch', lambda *a: 'decode')
  old = {name: (forms[name][0](x), forms[name][1](gy)) for name in new}
  for name in new:
    assert torch.equal(new[name][0], old[name][0]), name
    assert torch.equal(new[name][1], old[name][1]), name


@pytest.mark.cuda
def test_mm_unaligned_operand_is_refused(cuda_device):
  """An x that does not start on a 16-byte boundary is refused by the
  wrapper, before any branch (TMA takes 16-byte-aligned bases and row
  strides)."""
  occ, _, _, x, w, _ = _dense_case(2, 2, (64, 64), 64, torch.bfloat16,
                                   cuda_device, 1, 'edges')
  flat = torch.empty(x.numel() + 8, dtype=x.dtype, device=cuda_device)
  shifted = flat[4:4 + x.numel()].view_as(x)
  shifted.copy_(x)
  for name, (fwd, _, _, _) in _mm_forms(occ, (64, 64), w,
                                        cuda_device).items():
    with pytest.raises(ValueError, match='16-byte'):
      fwd(shifted)


# ----------------------------- the decode branch -------------------------
# packed_mm_decode_kernel (m <= 32, either dtype): each tile's contraction
# split over a cluster of S blocks (ops/mm_split.py decode_plan), the f32
# partials added in rank order.  At serving's four shapes (block 512, s =
# 0.8): every S the plan can choose, forced.
DECODE_SHAPES = {'qkv': (2048, 6144), 'out': (2048, 2048),
                 'fc1': (2048, 8192), 'fc2': (8192, 2048)}
_DECODE_CASES = {}


def _force_slices(monkeypatch, slices):
  """Every decode plan from here on takes `slices` (None: the planner's)."""
  from rigl_tpu_torch.ops import mm_split
  plan = mm_split.decode_plan
  while isinstance(plan, functools.partial):
    plan = plan.func
  monkeypatch.setattr(mm_split, 'decode_plan', plan if slices is None else
                      functools.partial(plan, slices=slices))


def _decode_case(layer, dtype, device):
  """The serving projection `layer` at s = 0.8, block (512, 512): packing,
  packed w, the dense W, the v3 lists (forward, dx); cached per (layer,
  dtype)."""
  from rigl_tpu_torch.ops import block_sparse_v3 as tv3
  from rigl_tpu_torch.sparsity.distributions import get_n_zeros
  key = (layer, dtype)
  if key not in _DECODE_CASES:
    kdim, ndim = DECODE_SHAPES[layer]
    nk, nn_ = kdim // 512, ndim // 512
    n_act = nk * nn_ - get_n_zeros(nk * nn_, 0.8)
    gen = torch.Generator().manual_seed(nk * nn_)
    occ = random_occupancy(gen, nk, nn_, n_act)
    packing = tbsp.make_packing(occ, n_act)
    dgen = torch.Generator(device=device).manual_seed(nk * nn_)
    wp = (torch.randn(n_act, 512, 512, generator=dgen, device=device)
          / kdim ** 0.5).to(dtype)
    wd = tbsp.unpack_dense(wp, packing, (512, 512)).contiguous()
    occ_d = occ.to(device)
    _DECODE_CASES[key] = (packing, wp, wd,
                          tv3.occupancy_lists(occ_d, (512, 512), ndim),
                          tv3.occupancy_lists(occ_d, (512, 512), ndim, 'dx'))
  return _DECODE_CASES[key]


def _decode_calls(case, block):
  """(name, call, plain, mode) of the forward and dx in packed storage and
  through the v3 lists (dense storage)."""
  from rigl_tpu_torch.ops import block_sparse_v3 as tv3
  packing, wp, wd, fl, dl = case
  cpu = lambda ls: type(ls)(*(t.cpu() for t in ls))  # noqa: E731
  return (
      ('packed fwd', lambda a: tbsp.packed_matmul_cuda(a, wp, packing, block),
       lambda a: tbsp.packed_matmul_reference(a, wp, packing, block), 'fwd'),
      ('packed dx',
       lambda a: tbsp.packed_matmul_dx_cuda(a, wp, packing, block),
       lambda a: tbsp.packed_matmul_dx_reference(a, wp, packing, block),
       'dx'),
      ('dense fwd', lambda a: tv3.dense_mm_cuda(a, wd, fl, block),
       lambda a, fl=cpu(fl): tv3.dense_mm_reference(a, wd, fl, block),
       'fwd'),
      ('dense dx', lambda a: tv3.dense_mm_cuda(a, wd, dl, block, 'dx'),
       lambda a, dl=cpu(dl): tv3.dense_mm_reference(a, wd, dl, block, 'dx'),
       'dx'))


@pytest.mark.cuda
@pytest.mark.parametrize('m', [1, 5, 8, 31])
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('slices', [1, 2, 4, 8])
@pytest.mark.parametrize('layer', sorted(DECODE_SHAPES))
def test_mm_decode_matches_plain_at_serving_shapes(cuda_device, monkeypatch,
                                                   layer, slices, dtype, m):
  """The decode kernel at S forced to 1, 2, 4 and 8, forward and dx, in
  packed and dense storage, m = 1, 5, 8, 31, against the plain versions
  (tolerances of the other branches, relative to max(1, max |plain|));
  each call one decode launch."""
  kdim, ndim = DECODE_SHAPES[layer]
  case = _decode_case(layer, dtype, cuda_device)
  _force_slices(monkeypatch, slices)
  gen = torch.Generator(device=cuda_device).manual_seed(m + slices)
  acts = {'fwd': torch.randn(m, kdim, generator=gen, device=cuda_device),
          'dx': torch.randn(m, ndim, generator=gen, device=cuda_device)}
  for name, call, plain, mode in _decode_calls(case, (512, 512)):
    a = acts[mode].to(dtype)
    assert tbsp.mm_branch(m, 512, dtype) == 'decode'
    before = tbsp.mm_decode_launches
    got = call(a)
    torch.cuda.synchronize()
    assert tbsp.mm_decode_launches == before + 1, name
    want = plain(a)
    assert got.shape == want.shape and got.dtype == dtype, name
    assert _rel(got, want) <= MM_TOL[dtype], (name, _rel(got, want))
  _force_slices(monkeypatch, None)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('slices', [1, 2, 4, 8])
def test_mm_decode_edges_and_a_nonfinite_segment(cuda_device, monkeypatch,
                                                 slices, dtype):
  """Block (64, 64), m = 5: a column with no active (exactly zero), a
  column of one active (one chunk in bf16, two in f32: fewer than S, so
  ranks with no work join the sum), and a NaN in one segment of x (gy for
  dx), which reaches only the outputs of the columns that read that
  segment, in its own row; every other output has the bits of the call
  with that value zeroed and matches the plain version.  Forward and dx,
  packed and dense storage."""
  from rigl_tpu_torch.ops import block_sparse_v3 as tv3
  block = (64, 64)
  occ = torch.tensor([[1, 0, 1, 1], [0, 0, 1, 0], [0, 0, 1, 1],
                      [0, 0, 1, 0]], dtype=torch.int32)
  n_act = int(occ.sum())
  packing = tbsp.make_packing(occ, n_act)
  gen = torch.Generator(device=cuda_device).manual_seed(slices)
  wp = torch.randn(n_act, *block, generator=gen,
                   device=cuda_device).to(dtype)
  wd = tbsp.unpack_dense(wp, packing, block).contiguous()
  occ_d = occ.to(cuda_device)
  case = (packing, wp, wd, tv3.occupancy_lists(occ_d, block, 256),
          tv3.occupancy_lists(occ_d, block, 256, 'dx'))
  _force_slices(monkeypatch, slices)
  for name, call, plain, mode in _decode_calls(case, block):
    clean = torch.randn(5, 256, generator=gen, device=cuda_device).to(dtype)
    bad = clean.clone()
    bad[3, 2 * 64 + 10] = float('nan')          # segment 2, row 3
    zeroed = clean.clone()
    zeroed[3, 2 * 64 + 10] = 0
    got, ref = call(bad), call(zeroed)
    torch.cuda.synchronize()
    reads = (occ[:, 2] if mode == 'dx' else occ[2]).tolist()
    empty = (occ.sum(1) if mode == 'dx' else occ.sum(0)).tolist()
    for g in range(4):
      cols = slice(64 * g, 64 * (g + 1))
      if reads[g]:
        assert bool(torch.isnan(got[3, cols]).all()), (name, g)
      else:
        assert torch.equal(got[3, cols], ref[3, cols]), (name, g)
      rows = [0, 1, 2, 4]
      assert torch.equal(got[rows, cols], ref[rows, cols]), (name, g)
      if not empty[g]:
        assert not ref[:, cols].any(), (name, g)
    assert _rel(ref, plain(zeroed)) <= MM_TOL[dtype], name
  _force_slices(monkeypatch, None)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('slices', [1, 2, 4, 8])
def test_mm_decode_repeats_bitwise_with_one_allocation(cuda_device,
                                                       monkeypatch, slices,
                                                       dtype):
  """At serving's fc2 (the largest S) and m = 8, forward and dx, packed
  and dense: a second call gives the same bits, and a call allocates one
  block, its output (no workspace)."""
  case = _decode_case('fc2', dtype, cuda_device)
  _force_slices(monkeypatch, slices)
  gen = torch.Generator(device=cuda_device).manual_seed(slices)
  acts = {'fwd': torch.randn(8, 8192, generator=gen, device=cuda_device),
          'dx': torch.randn(8, 2048, generator=gen, device=cuda_device)}
  for name, call, _, mode in _decode_calls(case, (512, 512)):
    a = acts[mode].to(dtype)
    first = call(a)
    torch.cuda.synchronize()
    count = torch.cuda.memory_stats(cuda_device)['allocation.all.allocated']
    second = call(a)
    torch.cuda.synchronize()
    assert torch.cuda.memory_stats(cuda_device)[
        'allocation.all.allocated'] == count + 1, name
    assert torch.equal(first, second), name
  _force_slices(monkeypatch, None)


# ------------------------------------------------------------- sparse RL --
# The RL path (rigl_tpu_torch/rl) runs no hand-written kernel; these hold
# its device code against the CPU: env transitions (grid envs bit for
# bit, CartPole / Pendulum within RL_ENV_TOL: the card's cos / sin /
# atan2 differ from the CPU's in the last place), a DQN and a SAC learn
# step from one state in float64 (in float32 a ReLU or Huber boundary
# that the devices' sums put on either side moves a gradient entry by
# 2e-3 of its value; in float64 the devices differ by the order of their
# sums, 1e-15: RL_F64_RTOL on the loss and gradients, and after Adam,
# which moves a weight whose gradient is near 0 by lr * m / (sqrt(v) +
# eps), the params within RL_F64_RTOL of the layer's largest plus
# RL_F64_ATOL), host syncs, and the learning checks of tests/test_rl.py's
# slow tests.
RL_ENV_TOL = 1e-5
RL_F64_RTOL, RL_F64_ATOL = 1e-9, 1e-9


def _rl_envs():
  from rigl_tpu_torch.rl import envs
  return envs


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['Breakout', 'Freeway', 'Asterix',
                                  'SpaceInvaders', 'CartPole', 'Pendulum'])
def test_rl_env_transition_card_vs_cpu(cuda_device, name):
  envs = _rl_envs()
  cpu, card = getattr(envs, name)(device='cpu'), getattr(envs, name)(
      device=cuda_device)
  gen = torch.Generator().manual_seed(3)
  state = cpu.reset(gen)
  continuous = name in ('CartPole', 'Pendulum')
  for i in range(300):
    if hasattr(cpu, 'num_actions'):
      action = torch.randint(0, cpu.num_actions, (), generator=gen)
    else:
      action = torch.rand((1,), generator=gen) * 5 - 2.5
    draws = cpu.step_draws(gen)
    want = cpu.transition(state.obs, state.t, action, draws)
    got = card.transition(state.obs.to(cuda_device), state.t.to(cuda_device),
                          action.to(cuda_device),
                          {k: v.to(cuda_device) for k, v in draws.items()})
    for g, w in zip(got, want):
      g = g.cpu()
      if continuous and g.is_floating_point():
        scale = max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= RL_ENV_TOL * scale, (name, i)
      else:
        assert torch.equal(g, w), (name, i)
    state = envs.EnvState(obs=want[0], done=want[3], t=want[1], gen=gen)


def _as_f64(*nets):
  for net in nets:
    net.to(torch.float64)
    for m in net.modules():
      if hasattr(m, 'dtype'):
        m.dtype = torch.float64


def _rl_pair(kind, cuda_device):
  """(CPU agent and state, card agent and state) from one seed, in
  float64: equal weights and masks (drawn on the CPU), the CPU's replay
  copied to the card."""
  from rigl_tpu_torch.rl import dqn, networks, sac
  envs = _rl_envs()
  out = []
  for dev in ('cpu', cuda_device):
    if kind == 'dqn':
      env = envs.Breakout(device=dev)
      agent = dqn.SparseDQN(
          networks.NatureDQN(3, width=0.5, device=dev), env,
          dqn.DQNConfig(training_method='rigl', sparsity=0.9, batch_size=32,
                        buffer_capacity=256, min_replay=64,
                        maskupdate_begin_step=1000, learning_rate=2.5e-4))
    else:
      env = envs.Pendulum(device=dev)
      agent = sac.SparseSAC(env, sac.SACConfig(
          training_method='rigl', sparsity=0.8, batch_size=64,
          buffer_capacity=256, min_replay=64, maskupdate_begin_step=1000))
    _as_f64(*([agent.net] if kind == 'dqn' else [agent.actor, agent.critic]))
    out.append((agent, agent.init(0)))
  (ca, cs), (ga, gs) = out
  for _ in range(96):
    cs = ca._env_step(cs)
  for f in ('obs', 'action', 'reward', 'next_obs', 'done'):
    getattr(gs.buffer, f).copy_(getattr(cs.buffer, f))
  gs.buffer.ptr, gs.buffer.size = cs.buffer.ptr, cs.buffer.size
  return (ca, cs), (ga, gs)


def _rl_close(got, want, what):
  for p, w in want.items():
    g = got[p].detach().cpu()
    excess = float((g - w).abs().max() - RL_F64_RTOL * w.abs().max())
    assert excess <= RL_F64_ATOL, (what, p, excess)


@pytest.mark.cuda
def test_rl_dqn_learn_step_card_vs_cpu(cuda_device):
  from rigl_tpu_torch.rl import dqn, replay
  (ca, cs), (ga, gs) = _rl_pair('dqn', cuda_device)
  gen = torch.Generator().manual_seed(1)
  for i in range(2):
    idx = replay.sample_indices(cs.buffer, gen, ca.config.batch_size)
    grads = []
    for a, s, ix in ((ca, cs, idx), (ga, gs, idx.to(cuda_device))):
      eff = dqn.effective(s.params, s.sparse.masks, False, grad=True)
      loss = a._loss(eff, s.target_params, s.target_masks,
                     replay.gather(s.buffer, ix))
      grads.append((float(loss.detach()), dqn.grads_of(loss, eff)))
    (lc, gc), (lg, gg) = grads
    assert abs(lg - lc) <= RL_F64_RTOL * abs(lc), (i, lg, lc)
    for p, g in gg.items():
      w = gc[p]
      assert float((g.cpu() - w).abs().max()) <= RL_F64_RTOL * max(
          float(w.abs().max()), 1e-300), (i, p)
    cs = ca._learn(cs, idx=idx)
    gs = ga._learn(gs, idx=idx.to(cuda_device))
    assert gs.sparse.step == cs.sparse.step
    _rl_close(gs.params, {p: t.detach() for p, t in cs.params.items()},
              f'dqn learn {i}')
    for p, m in cs.sparse.masks.items():
      assert torch.equal(gs.sparse.masks[p].cpu(), m)


@pytest.mark.cuda
def test_rl_sac_learn_step_card_vs_cpu(cuda_device):
  (ca, cs), (ga, gs) = _rl_pair('sac', cuda_device)
  gen = torch.Generator().manual_seed(2)
  shape = (ca.config.batch_size, 1)
  for i in range(2):
    draws = {'idx': torch.randint(0, cs.buffer.size, (shape[0],),
                                  generator=gen),
             'eps_next': torch.randn(shape, generator=gen),
             'eps_pi': torch.randn(shape, generator=gen)}
    cs = ca._learn(cs, draws)
    gs = ga._learn(gs, {k: v.to(cuda_device) for k, v in draws.items()})
    for net in ('actor', 'critic'):
      _rl_close(getattr(gs, f'{net}_params'),
                {p: t.detach() for p, t in getattr(cs,
                                                   f'{net}_params').items()},
                f'sac {net} learn {i}')
    _rl_close(gs.target_critic_params, cs.target_critic_params,
              f'sac target learn {i}')
    assert abs(float(gs.log_alpha.detach()) - float(cs.log_alpha.detach())
               ) <= RL_F64_ATOL


@pytest.mark.cuda
def test_rl_env_and_learn_steps_make_no_host_sync(cuda_device):
  """An env step of each agent, DQN's learn step and PPO's rollout run
  under torch.cuda.set_sync_debug_mode('error')."""
  from rigl_tpu_torch.rl import ppo
  envs = _rl_envs()
  (_, _), (ga, gs) = _rl_pair('dqn', cuda_device)
  (_, _), (sa, ss) = _rl_pair('sac', cuda_device)
  pa = ppo.SparsePPO(envs.CartPole(device=cuda_device),
                     ppo.PPOConfig(rollout_length=16))
  ps = pa.init(0)
  torch.cuda.synchronize()
  torch.cuda.set_sync_debug_mode('error')
  try:
    for _ in range(8):
      gs = ga._env_step(gs)
      ss = sa._env_step(ss)
    gs = ga._learn(gs)
    pa._rollout(ps)
  finally:
    torch.cuda.set_sync_debug_mode('default')


@pytest.mark.cuda
@pytest.mark.parametrize('agent', ['dqn', 'ppo', 'sac'])
def test_rl_learns_on_card(cuda_device, agent):
  """tests/test_rl.py's slow learning checks at their settings, on the
  card: sparse DQN on CartPole above 35 (random play about 20), PPO
  above 40, SAC on Pendulum above -900 (random about -1200)."""
  from rigl_tpu_torch.rl import dqn, networks, ppo, sac
  envs = _rl_envs()
  if agent == 'dqn':
    env = envs.CartPole(device=cuda_device)
    cfg = dqn.DQNConfig(training_method='rigl', sparsity=0.5,
                        buffer_capacity=5000, min_replay=200, batch_size=64,
                        learn_every=2, target_update_period=50,
                        epsilon_decay_steps=2000, maskupdate_frequency=200,
                        maskupdate_begin_step=100, learning_rate=3e-3)
    result = dqn.SparseDQN(networks.MLPQNetwork(
        env.num_actions, hidden=(64, 64), device=cuda_device), env,
        cfg).train(total_env_steps=6000, log_every=0)
    assert result['episodes'] > 5
    assert result['avg_return'] > 35.0
  elif agent == 'ppo':
    cfg = ppo.PPOConfig(training_method='rigl', sparsity=0.5,
                        rollout_length=256, num_epochs=4, num_minibatches=4,
                        learning_rate=1e-3, maskupdate_frequency=100,
                        maskupdate_begin_step=50)
    result = ppo.SparsePPO(envs.CartPole(device=cuda_device), cfg,
                           hidden=(64, 64)).train(total_env_steps=256 * 60)
    assert result['episodes'] > 5
    assert result['avg_return'] > 40.0
  else:
    cfg = sac.SACConfig(training_method='rigl', sparsity=0.5,
                        buffer_capacity=20000, min_replay=500,
                        batch_size=128, learn_every=1, learning_rate=3e-3,
                        maskupdate_frequency=1000, maskupdate_begin_step=500)
    result = sac.SparseSAC(envs.Pendulum(device=cuda_device), cfg,
                           hidden=(64, 64)).train(total_env_steps=12000,
                                                  log_every=0)
    assert result['episodes'] > 10
    assert result['avg_return'] > -900.0
