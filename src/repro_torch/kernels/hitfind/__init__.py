"""kernels/hitfind of the PyTorch/CUDA port."""
