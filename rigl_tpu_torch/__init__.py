"""rigl_tpu_torch: the PyTorch / CUDA port of rigl_tpu for NVIDIA Hopper.

The JAX package `rigl_tpu` stays the reference; this package mirrors its
layout (sparsity/, ops/, layers/, models/, serve/, transforms/, train/,
data/, drivers/) so each module's counterpart is found at the same
relative path.  It imports torch and numpy only, never jax, flax or
rigl_tpu.  Its entry points put their state on the card unless the caller
names another device.

Ported so far:
  * the packed-transformer serving path: sparsity counts and per-layer
    maps, the packing index maths, PackedDense, PackedTransformer and its
    dense twin, KV-cache decoding;
  * the packed training path: update schedules and the drop/grow kernel,
    block pooling, packed_matmul's backward (dx and packed dw), drop/grow
    on packed storage with optimizer-slot carry, PackedMLPTrainer, the
    MNIST-shaped data loaders and the packed-MLP driver;
  * transformer LM training: float32 master weights for bf16 compute,
    the fused causal attention core, chunked cache attention (kv_chunk),
    the single-device tree functions of drop/grow (RigL, SET, SNFS),
    PackedLMTrainer and the packed-LM driver;
  * the hand-written Hopper kernels of all three (csrc/packed_mm.cu:
    forward, dx and packed dw; csrc/flash_attn.cu: the flash-attention
    forward, dK/dV and dQ), and a converter from the JAX package's
    variables and trainer state (convert.py);
  * packed conv-net training on the tap kernels (csrc/tap_conv.cu);
  * dense-masked training, the JAX package's headline path: mask dicts
    (sparsity/masks.py), the nine algorithms and SparseTraining
    (transforms/), the train and eval steps (train/steps.py), ResNet
    (models/resnet.py, models/common.py), BlockSparseDense, and block
    execution of eligible layers on the dense storage modes of
    csrc/packed_mm.cu (ops/block_sparse_v3.py, block_sparse_v4.py,
    conv.py);
  * the dense-masked model zoo, the structured mask generators, STR and
    the input pipeline (models/registry.py, sparsity/generators.py,
    data/);
  * the config-driven Trainer with its learning-rate schedules,
    checkpoints, eval loop, export and metrics (train/trainer.py,
    lr_schedules.py, checkpoint.py, eval_loop.py, export.py,
    utils/metrics.py) and the mnist / cifar / imagenet / train drivers.
"""
