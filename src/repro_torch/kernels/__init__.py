"""Hand-written CUDA kernels for Hopper (``sm_90a``), each with the plain
PyTorch version beside it.

Each ``<name>/ops.py`` wrapper launches its kernel for tensors on the card
and runs the plain version in ``<name>/ref.py`` for tensors on the CPU;
``build.py`` compiles ``csrc/*.cu`` on first use.
"""
