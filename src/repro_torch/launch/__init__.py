"""launch of the PyTorch/CUDA port."""
