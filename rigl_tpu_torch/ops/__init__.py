"""Ops of the port, and the index of its kernels.

Every Pallas kernel of the JAX package (each function that reaches
`pl.pallas_call`) and its Hopper counterpart in this package.  Paths on
the left are under rigl_tpu/ops/pallas/ unless stated.

  #  TPU kernel (file:line, launcher)                      Hopper counterpart
  1  block_sparse_packed.py:178 _mm_kernel, _mm_call       csrc/packed_mm.cu
                                                           (CUDA C++, sm_90a)
                                                           the mm kernels
                                                           (mm_branch: packed_
                                                           mm_decode_kernel at
                                                           m <= 32 in either
                                                           dtype, split over a
                                                           cluster by ops/mm_
                                                           split.py; packed_
                                                           mm_wgmma_kernel in
                                                           bf16, at the tile
                                                           mm_tile names;
                                                           packed_mm_ffma_
                                                           kernel in f32):
                                                           forward mode, bound
                                                           in ops/block_sparse_
                                                           packed.py as
                                                           packed_matmul_cuda;
                                                           transposed (dx)
                                                           mode, as
                                                           packed_matmul_dx_cuda
  2  block_sparse_packed.py:345 _dw_kernel, _dw_call       csrc/packed_mm.cu
                                                           the dw kernels:
                                                           packed_dw_wgmma_
                                                           kernel (bf16),
                                                           packed_dw_3xtf32_
                                                           kernel (f32, at
                                                           the tile dw_tile
                                                           names), and
                                                           packed_dw_reduce_
                                                           kernel where the
                                                           m-sum is split
                                                           (ops/dw_split.py),
                                                           as packed_dw_cuda
  3  block_sparse_packed.py:362 _dw_panel_kernel, _dw_call the same kernel (the
                                                           panel is an L2
                                                           matter on Hopper)
  4  block_sparse_conv.py:117 _conv_kernel, _shift_matmul  the branch of
     (the forward; dx from _tap_bwd with flipped taps and  ops/block_sparse_
     transposed blocks)                                    conv.py tap_branch,
                                                           bound there as
                                                           tap_conv_cuda(mode=
                                                           'fwd' / 'dx'): mm
                                                           (1x1, dense w) on
                                                           csrc/packed_mm.cu's
                                                           mm kernels (row 1's
                                                           branches); in
                                                           csrc/tap_conv.cu
                                                           (CUDA C++, sm_90a)
                                                           wgmma (bf16 KxK,
                                                           blocks of 16s):
                                                           tap_conv_wgmma_
                                                           kernel; tf32 (f32
                                                           KxK, and bf16 KxK
                                                           at blocks of 8s):
                                                           tap_conv_tf32_
                                                           kernel (3xTF32 in
                                                           f32, one tf32
                                                           product in bf16)
  5  block_sparse_conv.py:355 _conv_kernel_v5,             the same kernel:
     _shift_matmul_v5 (RIGL_TAP_ENGINE=v5)                 v5 is another TPU
                                                           grid for the same
                                                           sums, so the port
                                                           has no switch
  6  block_sparse_conv.py:473 _dw_kernel, _dw_gather       csrc/tap_conv.cu
                                                           tap_dw_kernel over
                                                           tap groups, and
                                                           tap_dw_reduce_
                                                           kernel where the
                                                           pixel sum is split,
                                                           as tap_dw_cuda; JAX's
                                                           'dense' dw branch
                                                           (RIGL_TAP_DW) gives
                                                           the same numbers
                                                           and has no switch
  7  block_sparse_v4.py:60 _v4_kernel, _v4_matmul          csrc/packed_mm.cu
     (forward; dx from _v4_bwd with the transposed         the mm kernels in
     packing)                                              their dense storage
                                                           mode (W read in
                                                           place from (K, N)
                                                           at per-entry
                                                           offsets), bound in
                                                           ops/block_sparse_
                                                           v4.py as
                                                           v4_matmul_cuda
                                                           (forward and dx)
  8  block_sparse_v6.py:65 _v6_kernel, _v6_call            the same kernel and
     (forward; dx from _v6_bwd over the transposed         mode: the sums of
     packing; dw is an XLA product, no kernel; no bias     row 7 from pack_
     or activation epilogue, whatever pallas/__init__.py   columns' entries
     says)                                                 (their valid ones
                                                           as a CSR), bound in
                                                           ops/block_sparse_
                                                           v6.py as
                                                           v6_matmul_cuda
                                                           (forward and dx);
                                                           no epilogue either
  9  block_sparse_v3.py:28 _v3_kernel, _v3_impl            the same kernel and
                                                           mode: the sums of
                                                           row 7 from per-
                                                           column index lists,
                                                           bound in ops/block_
                                                           sparse_v3.py as
                                                           v3_matmul_cuda
 10  block_sparse_v3.py:160 _dw_v2_kernel,                 csrc/packed_mm.cu
     _dw_blocksparse_v2                                    the dw kernels of
                                                           row 2 in their
                                                           dense mode,
                                                           bound in ops/block_
                                                           sparse_v3.py as
                                                           dense_dw_cuda
 11  block_sparse_v3.py:261 _dense_kernel,                 the same kernel and
     pallas_dense_matmul (the dense control)               mode over an all-
                                                           active occupancy,
                                                           bound in ops/block_
                                                           sparse_v3.py as
                                                           dense_control_cuda
 12  block_sparse_v2.py:44 _gather_kernel,                 the same kernel and
     block_sparse_matmul_gather (forward only)             mode from pack_
                                                           block_indices'
                                                           lists, bound in
                                                           ops/block_sparse_
                                                           v2.py as
                                                           gather_matmul_cuda
 13  block_sparse.py:40 _fwd_kernel, _matmul_blocksparse   the same kernel and
     (forward; dx the same kernel on w.T)                  mode from the
                                                           occupancy (dx reads
                                                           W transposed in
                                                           place), bound in
                                                           ops/block_sparse.py
                                                           as v1_matmul_cuda
 14  block_sparse.py:85 _dw_kernel, _dw_blocksparse        the dw kernels of
                                                           row 2 in their
                                                           dense mode over
                                                           every block with
                                                           its occupancy flag
                                                           (row 10's kernel),
                                                           bound in ops/block_
                                                           sparse.py as
                                                           v1_dw_cuda
 15  models/packed_transformer.py:52 _flash_attention:     csrc/flash_attn.cu
     JAX's shipped pallas.ops.tpu.flash_attention, three   (CUDA C++, sm_90a),
     pallas_calls: the forward (_flash_attention_impl),    bound in ops/flash_
     _flash_attention_bwd_dkv and                          attention.py:
     _flash_attention_bwd_dq                               flash_fwd_wgmma_
                                                           kernel as flash_
                                                           fwd_cuda, flash_bwd_
                                                           dkv_wgmma_kernel as
                                                           flash_bwd_dkv_
                                                           cuda, flash_bwd_dq_
                                                           wgmma_kernel as
                                                           flash_bwd_dq_cuda;
                                                           bf16 and
                                                           f32 (f32 variants
                                                           of the three:
                                                           flash_*_f32_kernel)

Every kernel is ported.  Each has a plain PyTorch version in the same
module, which CPU tensors take, and a launch counter per entry that a run
reads to show that its path went through the kernel.  The names that
rigl_tpu/ops/pallas/__init__.py exports import from the modules at the
same relative paths here: block_sparse.block_sparse_matmul,
block_sparse_v2.block_sparse_matmul_gather and pack_block_indices,
block_sparse_v3.block_sparse_matmul_v3 and pallas_dense_matmul.
"""
