"""solvers of the PyTorch/CUDA port (mirrors the JAX package's solvers)."""
