"""Serving: autoregressive KV-cache decoding for the transformer family."""

from rigl_tpu_torch.serve.decode import (decode_twin, generate,  # noqa: F401
                                         init_cache, make_generate_fn)
