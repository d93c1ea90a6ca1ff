"""Optimizers of the PyTorch/CUDA port."""
