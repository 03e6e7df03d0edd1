"""Hand-written Hopper kernels of the port (``csrc/``), their wrappers,
plain PyTorch versions and the tile policy."""
