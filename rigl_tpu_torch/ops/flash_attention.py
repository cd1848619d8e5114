"""Causal flash attention: plain versions, Hopper kernels, autograd.

Counterpart of the fused attention core of rigl_tpu/models/
packed_transformer.py (`_flash_attention`, which calls JAX's shipped TPU
kernel `jax.experimental.pallas.ops.tpu.flash_attention` with
causal=True).  Layout is JAX's: q, k, v of (B, H, S, hd).

`flash_attention(q, k, v, sm_scale)` returns o = softmax(sm_scale * q kᵀ +
causal mask) v in q's dtype, differentiable in q, k and v.  CPU tensors
take the plain versions (`flash_attention_fwd_reference`,
`flash_attention_bwd_reference`, which composes `flash_bwd_dkv_reference`
and `flash_bwd_dq_reference`); CUDA tensors launch the three hand-written
kernels of csrc/flash_attn.cu or raise:

  flash_fwd_wgmma_kernel      replaces the forward pallas_call of
                              `_flash_attention_impl`; also saves the f32
                              row statistic lse = m + log(l) (JAX keeps l
                              and m);
  flash_bwd_dkv_wgmma_kernel  replaces `_flash_attention_bwd_dkv`;
  flash_bwd_dq_wgmma_kernel   replaces `_flash_attention_bwd_dq`.

In bf16 all three run wgmma on a TMA ring, the logits in registers.

D = rowsum(do * o) in f32 stays a plain torch op between the forward and
the backward kernels, as JAX computes it outside its kernels.  The kernels
take bf16 (tensor cores) and f32 (f32 variants of the three,
`flash_*_f32_kernel`: the forward register-tiled on the CUDA cores, dK/dV
and dQ on wgmma in error-compensated TF32, three tf32 passes whose
products keep about 21 bits), and head dims 32, 64 and 128.
`flash_attention` takes any head dim up to 128, as JAX's kernel takes any
below 128: on the card another one is zero-padded to the next of those
three (`pad_head_dim`), which is exact.
A head dim above 128 raises NotImplementedError on the card: it does not
fit the kernels' shared-memory and register plans.  S need not be a
multiple of the tile: the kernels mask ragged rows.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from rigl_tpu_torch.ops import _build

# Launches of each kernel in this process.  Each wrapper adds one per
# launch of its kernel; nothing else touches them but callers resetting them.
flash_fwd_launches = 0        # flash_fwd_wgmma_kernel (bf16)
flash_bwd_dkv_launches = 0    # flash_bwd_dkv_wgmma_kernel (bf16)
flash_bwd_dq_launches = 0     # flash_bwd_dq_wgmma_kernel (bf16)
flash_fwd_f32_launches = 0        # flash_fwd_f32_kernel
flash_bwd_dkv_f32_launches = 0    # flash_bwd_dkv_f32_kernel
flash_bwd_dq_f32_launches = 0     # flash_bwd_dq_f32_kernel

HEAD_DIMS = (32, 64, 128)


# ------------------------------------------------------- plain versions ----
def _causal(s: int, device) -> torch.Tensor:
  pos = torch.arange(s, device=device)
  return pos[None, :] <= pos[:, None]


def flash_attention_fwd_reference(q, k, v, scale: float
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
  """(o, lse): dense masked softmax in f32; o cast once to q.dtype, lse
  (B, H, S) f32 the log-sum-exp of each row's scaled, masked logits."""
  logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
  logits = logits.masked_fill(~_causal(q.shape[-2], q.device), -torch.inf)
  lse = torch.logsumexp(logits, dim=-1)
  p = torch.exp(logits - lse[..., None])
  return torch.matmul(p, v.float()).to(q.dtype), lse


def _p_and_ds(q, k, v, do, lse, d, scale: float):
  """P = exp(scale q kᵀ - lse) (0 above the diagonal) and dS = P (do vᵀ -
  D) scale, in f32."""
  mask = _causal(q.shape[-2], q.device)
  logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
  p = torch.where(mask, torch.exp(logits - lse[..., None]), 0.0)
  dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
  return p, p * (dp - d[..., None]) * scale


def flash_bwd_dkv_reference(q, k, v, do, lse, d, scale: float):
  """(dk, dv), flash_bwd_dkv_wgmma_kernel's plain version: dv = Pᵀ do and
  dk = dSᵀ q in f32, each cast once to its input's dtype; d = rowsum(do
  o)."""
  p, ds = _p_and_ds(q, k, v, do, lse, d, scale)
  dv = torch.matmul(p.transpose(-1, -2), do.float())
  dk = torch.matmul(ds.transpose(-1, -2), q.float())
  return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_reference(q, k, v, do, lse, d, scale: float):
  """dq, flash_bwd_dq_wgmma_kernel's plain version: dS k in f32, cast once."""
  _, ds = _p_and_ds(q, k, v, do, lse, d, scale)
  return torch.matmul(ds, k.float()).to(q.dtype)


def _rowsum_do_o(do, o):
  """D = rowsum(do * o) in f32: the backward's per-row statistic, a plain
  op on both devices (JAX computes it outside its kernels too)."""
  return (do.float() * o.float()).sum(-1).contiguous()


def flash_attention_bwd_reference(q, k, v, o, lse, do, scale: float):
  """(dq, dk, dv) by the kernels' recompute-from-lse formulas, in f32:
  P = exp(scale q kᵀ - lse) (0 above the diagonal), dv = Pᵀ do,
  dS = P (do vᵀ - D) scale with D = rowsum(do o), dq = dS k, dk = dSᵀ q;
  each cast once to its input's dtype."""
  d = _rowsum_do_o(do, o)
  dk, dv = flash_bwd_dkv_reference(q, k, v, do, lse, d, scale)
  return flash_bwd_dq_reference(q, k, v, do, lse, d, scale), dk, dv


# -------------------------------------------------------------- kernels ----
@functools.cache
def _kernel(name: str):
  """The C entry point `name` of csrc/flash_attn.cu (an `_f32` suffix for
  the f32 kernels): pointers, the ints (b*h, S, hd), the scale, then the
  stream; returns the CUDA error code."""
  n_ptrs = {'flash_fwd': 5, 'flash_bwd_dkv': 8,
            'flash_bwd_dq': 7}[name.removesuffix('_f32')]
  fn = getattr(_build.load('flash_attn'), name)
  fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 3
                 + [ctypes.c_float, ctypes.c_void_p])
  fn.restype = ctypes.c_int
  return fn


DTYPES = (torch.bfloat16, torch.float32)


def _check_cuda(op: str, *tensors: torch.Tensor):
  """What the kernels take: (B, H, S, hd) tensors of one shape and one
  dtype in DTYPES on one CUDA device, hd in HEAD_DIMS, contiguous and
  16-byte aligned."""
  x = tensors[0]
  for t in tensors:
    if not (t.is_cuda and t.device == x.device):
      raise ValueError(f'{op}: operands must be on one CUDA device')
    if t.dtype not in DTYPES or t.dtype != x.dtype:
      raise NotImplementedError(f'{op} on the card takes bfloat16 or '
                                f'float32 operands of one dtype, not '
                                f'{t.dtype} with {x.dtype}')
    if t.dim() != 4 or t.shape != x.shape:
      raise ValueError(f'{op}: operands must be (B, H, S, hd) of one shape, '
                       f'got {tuple(t.shape)} and {tuple(x.shape)}')
    if not t.is_contiguous() or t.data_ptr() % 16:
      raise ValueError(f'{op}: operands must be contiguous and start on a '
                       '16-byte boundary')
  if x.shape[-1] not in HEAD_DIMS:
    raise NotImplementedError(
        f'{op} on the card takes head dims {HEAD_DIMS} (flash_attention '
        f'zero-pads the others below 128), not {x.shape[-1]}: above 128 a '
        "tile does not fit the kernels' shared-memory and register plans")
  b, h, s, _ = x.shape
  if b * h == 0 or s == 0:
    raise ValueError(f'{op}: empty operands {tuple(x.shape)}')
  if b * h > 65535:
    raise ValueError(f'{op}: B * H = {b * h} exceeds the grid limit 65535')


def _launch(name: str, *args):
  err = _kernel(name)(*args)
  if err:
    raise RuntimeError(f'{name} launch failed: CUDA error {err}')


def _dims(x: torch.Tensor):
  b, h, s, hd = x.shape
  return b * h, s, hd


def _suffix(x: torch.Tensor) -> str:
  """'' for the bf16 kernels, '_f32' for their f32 variants: the suffix of
  a kernel's C entry point and of its launch counter."""
  return '' if x.dtype == torch.bfloat16 else '_f32'


def _count(name: str, x: torch.Tensor):
  """Adds one to the launch counter of `name`'s kernel for x's dtype."""
  globals()[f'{name}{_suffix(x)}_launches'] += 1


def flash_fwd_cuda(q, k, v, scale: float):
  """(o, lse): launches flash_fwd_wgmma_kernel (bf16) or
  flash_fwd_f32_kernel on the current stream."""
  _check_cuda('flash_fwd', q, k, v)
  o = torch.empty_like(q)
  lse = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
  _launch(f'flash_fwd{_suffix(q)}', q.data_ptr(), k.data_ptr(), v.data_ptr(),
          o.data_ptr(), lse.data_ptr(), *_dims(q), scale,
          torch.cuda.current_stream(q.device).cuda_stream)
  _count('flash_fwd', q)
  return o, lse


def _check_stats(op: str, q, *stats):
  for t in stats:
    if (t.dtype != torch.float32 or t.shape != q.shape[:-1]
        or not t.is_contiguous() or t.device != q.device):
      raise ValueError(f'{op}: row statistics must be contiguous f32 '
                       f'{tuple(q.shape[:-1])} on {q.device}')


def flash_bwd_dkv_cuda(q, k, v, do, lse, d, scale: float):
  """(dk, dv): launches flash_bwd_dkv_wgmma_kernel (bf16) or
  flash_bwd_dkv_f32_kernel; d = rowsum(do * o) in f32."""
  _check_cuda('flash_bwd_dkv', q, k, v, do)
  _check_stats('flash_bwd_dkv', q, lse, d)
  dk, dv = torch.empty_like(k), torch.empty_like(v)
  _launch(f'flash_bwd_dkv{_suffix(q)}', q.data_ptr(), k.data_ptr(),
          v.data_ptr(), do.data_ptr(), lse.data_ptr(), d.data_ptr(),
          dk.data_ptr(), dv.data_ptr(), *_dims(q), scale,
          torch.cuda.current_stream(q.device).cuda_stream)
  _count('flash_bwd_dkv', q)
  return dk, dv


def flash_bwd_dq_cuda(q, k, v, do, lse, d, scale: float):
  """dq: launches flash_bwd_dq_wgmma_kernel (bf16) or its f32 variant; d =
  rowsum(do * o) in f32."""
  _check_cuda('flash_bwd_dq', q, k, v, do)
  _check_stats('flash_bwd_dq', q, lse, d)
  dq = torch.empty_like(q)
  _launch(f'flash_bwd_dq{_suffix(q)}', q.data_ptr(), k.data_ptr(),
          v.data_ptr(), do.data_ptr(), lse.data_ptr(), d.data_ptr(),
          dq.data_ptr(), *_dims(q), scale,
          torch.cuda.current_stream(q.device).cuda_stream)
  _count('flash_bwd_dq', q)
  return dq


def flash_attention_bwd_cuda(q, k, v, o, lse, do, scale: float):
  """(dq, dk, dv) on the card: D as a plain f32 op, then both kernels."""
  d = _rowsum_do_o(do, o)
  dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, d, scale)
  return flash_bwd_dq_cuda(q, k, v, do, lse, d, scale), dk, dv


def _on_device(op: str, t: torch.Tensor, plain, kernel):
  """CPU tensors take the plain version, CUDA tensors the kernel."""
  if t.device.type == 'cpu':
    return plain
  if t.device.type == 'cuda':
    return kernel
  raise ValueError(f'{op} runs on cpu or cuda, not {t.device}')


class _FlashAttention(torch.autograd.Function):

  @staticmethod
  def forward(ctx, q, k, v, scale):
    fn = _on_device('flash_attention', q, flash_attention_fwd_reference,
                    flash_fwd_cuda)
    o, lse = fn(q, k, v, scale)
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.scale = scale
    return o

  @staticmethod
  def backward(ctx, do):
    q, k, v, o, lse = ctx.saved_tensors
    fn = _on_device('flash_attention backward', do,
                    flash_attention_bwd_reference, flash_attention_bwd_cuda)
    dq, dk, dv = fn(q, k, v, o, lse, do.contiguous(), ctx.scale)
    return dq, dk, dv, None


def _attend(q, k, v, scale: float):
  """o for contiguous q, k, v: through the autograd Function where a
  gradient is wanted, else the forward alone."""
  if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                  or v.requires_grad):
    return _FlashAttention.apply(q, k, v, scale)
  fn = _on_device('flash_attention', q, flash_attention_fwd_reference,
                  flash_fwd_cuda)
  return fn(q, k, v, scale)[0]


def pad_head_dim(attend, q, k, v, scale: float):
  """attend(q, k, v, scale) at the next head dim of HEAD_DIMS: q, k and v
  zero-padded on their last axis, o sliced back.  Exact: the zero columns
  add nothing to q kᵀ, so lse and P are unchanged, o's padded columns are
  0, so D = rowsum(do o) is unchanged, and autograd through the pad and
  the slice gives dq, dk and dv sliced back from do padded with zeros."""
  hd = q.shape[-1]
  to = next(d for d in HEAD_DIMS if d >= hd)
  if to == hd:
    return attend(q, k, v, scale)
  pad = lambda t: torch.nn.functional.pad(t, (0, to - hd))   # noqa: E731
  return attend(pad(q), pad(k), pad(v), scale)[..., :hd]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    sm_scale: float) -> torch.Tensor:
  """Causal attention o (B, H, S, hd) in q's dtype; differentiable in q, k
  and v.  A call that needs no gradient skips the autograd Function.  On
  the card a head dim below 128 that the kernels do not take runs
  zero-padded (`pad_head_dim`)."""
  q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
  scale = float(sm_scale)
  if q.is_cuda and q.shape[-1] <= HEAD_DIMS[-1]:
    return pad_head_dim(_attend, q, k, v, scale)
  return _attend(q, k, v, scale)
