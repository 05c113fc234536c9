"""Hand-written CUDA kernels (K1 Gram tile, K2 Cholesky panel), their plain
PyTorch versions and the nvcc build that binds them."""
