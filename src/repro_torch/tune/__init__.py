"""tune of the PyTorch/CUDA port."""
