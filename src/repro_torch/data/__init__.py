"""Input pipelines of the PyTorch/CUDA port."""
