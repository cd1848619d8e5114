"""Sparsity maths the packed path calls: floor counts, per-layer
distributions and SparsityMap resolution (rigl_tpu/sparsity/)."""

from rigl_tpu_torch.sparsity.distributions import (  # noqa: F401
    DEFAULT_ERK_SCALE,
    get_n_ones,
    get_n_zeros,
    get_sparsities,
    sparsities_erdos_renyi,
    sparsities_uniform,
)
from rigl_tpu_torch.sparsity.layer_sparsity import (  # noqa: F401
    SparsityMap,
    make_sparsity_map,
    resolve_sparsity,
    spec_for_model,
)
