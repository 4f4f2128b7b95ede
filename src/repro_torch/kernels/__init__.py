"""The approximate-channel kernels: CUDA sources, builder, wrappers and
their plain PyTorch versions (``ref``)."""
