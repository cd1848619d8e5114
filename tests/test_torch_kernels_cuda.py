"""The port's hand-written kernels (forward, dx and packed dw) against
their plain PyTorch versions, on a CUDA card, and the paths that run them.

Every test here needs the card (marker `cuda`) and skips without one.
The file imports neither jax nor the JAX package, so the card's machine
runs it without the repo's conftest (which imports jax):

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest -q
"""

import pytest
import torch

from rigl_tpu_torch import convert
from rigl_tpu_torch.layers.packed_dense import PackedDense, random_occupancy
from rigl_tpu_torch.models import packed_transformer as tpt
from rigl_tpu_torch.ops import block_sparse_packed as tbsp
from rigl_tpu_torch.serve import decode as tdec

# (nk, nn, n_active): empty columns, a single active, all actives in one
# column, a full grid, and the slice's qkv grid (12 columns, 10 actives).
GRIDS = [(4, 6, 5), (3, 4, 1), (5, 1, 3), (2, 3, 6), (4, 12, 10)]


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device: the packed_mm kernels have no CPU mode')
  torch.backends.cuda.matmul.allow_tf32 = False
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
