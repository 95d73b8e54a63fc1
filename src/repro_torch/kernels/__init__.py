"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version; ``ops`` is the public entry point, ``build`` compiles ``csrc/``."""
