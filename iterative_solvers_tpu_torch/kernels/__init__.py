"""kernels of the PyTorch/CUDA port (mirrors the JAX package's kernels)."""
