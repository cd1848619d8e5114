"""Research / analysis harness: Hessian spectra, interpolation, MetaInit,
mask visualization (counterpart of rigl_tpu/analysis)."""

from rigl_tpu_torch.analysis.hessian import (
    lanczos_spectrum,
    sparse_hessian,
    sparse_hessian_spectrum,
)
from rigl_tpu_torch.analysis.interpolate import (interpolate_losses,
                                                 interpolate_params)
from rigl_tpu_torch.analysis.metainit import gradient_quotient, meta_init
