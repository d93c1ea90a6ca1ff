"""LM serving of the PyTorch/CUDA port."""
