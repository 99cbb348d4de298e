"""Shared helpers of the `test_torch_*.py` parity tests.

Each test makes its inputs with numpy from a seed and hands them to the JAX
reference (`repro`, on the CPU, Pallas kernels in interpret mode) and to the
PyTorch port (`repro_torch`, on the CPU, where a kernel wrapper runs its
plain version). Data crosses between the two as numpy arrays only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro_torch import convert

# tier-1 runs several xdist workers on a few cores: keep each one narrow
torch.set_num_threads(2)

FP32_TOL = dict(atol=2e-5, rtol=1e-4)     # tests/test_kernels.py, fp32 cases
BF16_TOL = dict(atol=3e-2, rtol=3e-2)     # tests/test_kernels.py, bf16 case


def to_torch(a, dtype=None) -> torch.Tensor:
    """numpy (or JAX, incl. bfloat16) array -> CPU tensor."""
    t = convert.tensor_from_numpy(np.asarray(a), device="cpu")
    return t if dtype is None else t.to(dtype)


def to_np(x) -> np.ndarray:
    """Tensor or JAX array -> float32/int numpy array for comparisons."""
    if isinstance(x, torch.Tensor):
        return convert.tensor_to_numpy(x)
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def jax_tree_to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def random_like(tree, rng, name=""):
    """A numpy tree shaped like `tree` with seeded values in every floating
    leaf, biases and norm scales included (the reference initialises those to
    zeros and ones, which would leave their code paths untested)."""
    if isinstance(tree, dict):
        return {k: random_like(v, rng, k) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(random_like(v, rng, name) for v in tree)
    a = np.asarray(tree)
    if not np.issubdtype(a.dtype, np.floating) and a.dtype.name != "bfloat16":
        return a
    if name == "scale":
        out = 1.0 + 0.1 * rng.standard_normal(a.shape)
    elif name.startswith("b") or name == "bias":
        out = 0.1 * rng.standard_normal(a.shape)
    elif name == "embed":
        out = 0.02 * rng.standard_normal(a.shape)
    else:
        out = rng.standard_normal(a.shape) / np.sqrt(a.shape[-2])
    return out.astype(np.float32)


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)
