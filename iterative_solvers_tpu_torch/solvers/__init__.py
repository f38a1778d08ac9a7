"""solvers of the PyTorch/CUDA port (mirrors iterative_solvers_tpu/solvers)."""
