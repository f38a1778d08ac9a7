"""core of the PyTorch/CUDA port (mirrors the JAX package's core)."""
