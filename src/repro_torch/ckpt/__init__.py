"""Checkpointing of the PyTorch/CUDA port."""
