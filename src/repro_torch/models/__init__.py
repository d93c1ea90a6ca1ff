"""LM models of the PyTorch/CUDA port: the dense and vlm families."""
