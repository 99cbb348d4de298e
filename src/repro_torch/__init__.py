"""repro_torch: the PyTorch/CUDA port of the AMU reproduction, for NVIDIA Hopper.

Sits beside the JAX package `repro` (the frozen reference) with the same
sub-package layout, so a module's counterpart is found by its path. Imports
`torch` and `numpy` only — never `jax`, never `repro`.
"""
__version__ = "0.1.0"
