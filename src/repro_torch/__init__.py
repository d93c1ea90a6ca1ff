"""PyTorch/CUDA port of the LArTPC signal simulation.

A second package beside the JAX reference ``repro``: same module layout,
same configs and random streams, hand-written CUDA kernels for Hopper in
place of the reference's Pallas TPU kernels. Imports torch, never JAX.
"""
