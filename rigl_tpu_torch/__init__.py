"""rigl_tpu_torch: the PyTorch / CUDA port of rigl_tpu for NVIDIA Hopper.

The JAX package `rigl_tpu` stays the reference; this package mirrors its
layout (sparsity/, ops/, layers/, models/, serve/) so each module's
counterpart is found at the same relative path.  It imports torch and
numpy only, never jax, flax or rigl_tpu.

Ported so far: the packed-transformer serving path (sparsity counts and
per-layer maps, the packing index maths, the packed block-sparse matmul
with its hand-written Hopper kernel, PackedDense, PackedTransformer and
its dense twin, KV-cache decoding) and a converter from the JAX
package's variables (convert.py).
"""
