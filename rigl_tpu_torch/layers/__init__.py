"""Layers on packed block-sparse storage."""

from rigl_tpu_torch.layers.packed_dense import (  # noqa: F401
    PackedDense, packed_kernel_matmul, random_occupancy)
