"""kernels/rasterize of the PyTorch/CUDA port."""
