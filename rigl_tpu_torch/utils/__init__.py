"""Utilities of the port: FLOPs counting, metrics, symmetry stats,
compression analysis (counterpart of rigl_tpu/utils)."""

from rigl_tpu_torch.utils.compression import (
    compressed_fc_from_mask_dict,
    get_compressed_fc,
    live_input_indices,
)
from rigl_tpu_torch.utils.flops import count_model, get_stats
from rigl_tpu_torch.utils.metrics import (
    MetricsWriter,
    StepTimer,
    distance_to_init,
    norm_summaries,
    per_class_metrics,
    profile_trace,
    read_metrics,
    snr_summaries,
    sparsity_summaries,
)
from rigl_tpu_torch.utils.symmetry import (count_permutations_mask_layer,
                                           get_mask_stats)
