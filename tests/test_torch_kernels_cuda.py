"""The port's hand-written kernels against their plain PyTorch versions,
on a CUDA card.

Every test here needs the card (marker `cuda`) and skips without one.
The file imports neither jax nor the JAX package, so the card's machine
runs it without the repo's conftest (which imports jax):

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest -q
"""

import pytest
import torch

from rigl_tpu_torch import convert
from rigl_tpu_torch.layers.packed_dense import random_occupancy
from rigl_tpu_torch.models import packed_transformer as tpt
from rigl_tpu_torch.ops import block_sparse_packed as tbsp
from rigl_tpu_torch.serve import decode as tdec

# (nk, nn, n_active): empty columns, a single active, all actives in one
# column, a full grid, and the slice's qkv grid (12 columns, 10 actives).
GRIDS = [(4, 6, 5), (3, 4, 1), (5, 1, 3), (2, 3, 6), (4, 12, 10)]


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device: the packed_mm kernel has no CPU mode')
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
  with pytest.raises(NotImplementedError, match='backward'):
    tbsp.packed_matmul(x, w.clone().requires_grad_(), packing, block)


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
