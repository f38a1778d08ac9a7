"""ops of the PyTorch/CUDA port (mirrors the JAX package's ops)."""
