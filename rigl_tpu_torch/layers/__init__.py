"""Layers on packed block-sparse storage, and the block-skipping dense
layer over a dense-masked kernel (block_sparse_dense.py)."""

from rigl_tpu_torch.layers.packed_dense import (  # noqa: F401
    PackedDense, packed_kernel_matmul, random_occupancy)
