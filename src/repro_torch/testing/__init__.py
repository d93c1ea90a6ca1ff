"""testing of the PyTorch/CUDA port."""
