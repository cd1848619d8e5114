"""Training transforms: drop/grow on packed storage with optimizer-slot
carry (packed_training.py), and the dense-masked sparse-training state
machine with its nine algorithms (sparse_training.py, algorithms.py)."""
