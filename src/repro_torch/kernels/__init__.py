"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Each wrapper (``bench_eval``, ``de_step``, ``eval_select``, ``pso_step``,
``ga_step``, ``flash_attention``, ``ssd_scan``, and the two gradients
``flash_attention_bwd`` and ``ssd_scan_bwd``) dispatches on the tensor's
device: the plain version for a CPU tensor, the kernel (built from ``csrc/``
at first use) for a CUDA tensor. Importing this package builds nothing.
"""
