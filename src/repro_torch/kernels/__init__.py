"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

``bench_eval`` and ``de_step`` dispatch on the tensor's device: the plain
version for a CPU tensor, the kernel (built from ``csrc/`` at first use) for
a CUDA tensor. Importing this package builds nothing.
"""
