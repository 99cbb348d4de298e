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
    """Tensor or JAX array -> float32/int numpy array for comparisons
    (bfloat16 and float8 widened to float32)."""
    if isinstance(x, torch.Tensor):
        return convert.tensor_to_numpy(x)
    a = np.asarray(x)
    wide = a.dtype.name in ("bfloat16", "float8_e4m3fn", "float8_e5m2")
    return a.astype(np.float32) if wide else a


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
    elif name == "decay_base":
        # RWKV-6's own range: the decay w = exp(-exp(.)) stays near 1, where
        # the chunk-parallel form's products of w are safe
        out = rng.uniform(-8.0, -4.0, a.shape)
    elif name == "lambda":
        # RG-LRU's own range: a = sigmoid(Lambda) in [0.9, 0.999]
        u = rng.uniform(0.9, 0.999, a.shape)
        out = np.log(u / (1 - u))
    else:
        out = rng.standard_normal(a.shape) / np.sqrt(a.shape[-2])
    return out.astype(np.float32)


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


# Params after Adam steps whose gradients each side computed: the first step
# moves a weight by lr * sign(g), and where |g| is near its own rounding the
# two sides may step opposite ways, so no weight may part by more than
# 2 * sum(lr); every other weight moves by nearly the same steps, so at most
# STEP_FLIP_SHARE of the weights may part by more than STEP_PART * sum(lr).
# Half the lr, no bias correction (0.45 of the first step) or another eps
# moves every weight with a gradient by more than that.
STEP_PART = 0.25
STEP_FLIP_SHARE = 0.01


def assert_steps_close(got, want, lr_sum, name=""):
    """`got`, `want`: matching lists of param leaves after the same Adam
    steps from the same start. Returns (max abs diff, share beyond
    STEP_PART * lr_sum)."""
    diff = np.concatenate([np.abs(to_np(a) - to_np(b)).ravel()
                           for a, b in zip(got, want)])
    worst = float(diff.max())
    share = float((diff > STEP_PART * lr_sum).mean())
    assert worst <= 2 * lr_sum, (
        f"{name}: a weight parted by {worst:.3e} > 2 * sum(lr) = "
        f"{2 * lr_sum:.3e}")
    assert share <= STEP_FLIP_SHARE, (
        f"{name}: {share:.2%} of the weights parted by more than "
        f"{STEP_PART} * sum(lr) (limit {STEP_FLIP_SHARE:.0%})")
    return worst, share
