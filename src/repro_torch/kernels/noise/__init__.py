"""kernels/noise of the PyTorch/CUDA port."""
