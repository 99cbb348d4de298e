"""Hand-written Hopper kernels (CUDA C++ under `csrc/`, built at first use by
`_build.py`) with their plain PyTorch versions in `ref.py`; `ops.py` holds the
public wrappers the model layer calls.

Dispatch rule of every wrapper: a CPU tensor runs the plain version, a CUDA
tensor launches the kernel or raises. Nothing is built at import time.
"""
