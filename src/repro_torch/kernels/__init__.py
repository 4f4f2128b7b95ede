"""The port's CUDA kernels: the approximate channel's K0, K1 and K2 and
the layered PHY's channel stage; their sources, builder and wrappers, and
K0-K2's plain PyTorch versions (``ref``)."""
