"""LM training of the PyTorch/CUDA port."""
