"""Model families of the port."""

from rigl_tpu_torch.models.packed_transformer import (  # noqa: F401
    DenseTransformer, PackedTransformer, transformer_layer_shapes)
