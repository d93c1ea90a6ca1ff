"""kernels/scatter_add of the PyTorch/CUDA port."""
