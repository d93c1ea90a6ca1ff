"""kernels/fused_sim of the PyTorch/CUDA port."""
