"""kernels of the PyTorch/CUDA port (mirrors iterative_solvers_tpu/kernels)."""
