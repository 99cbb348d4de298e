"""`repro_torch.models.lm.train_loss` against the reference's on converted
weights: loss, MoE aux loss and gradients for the smoke config of every
architecture in fp32 compute. The helpers here are shared with
`test_torch_train_bf16.py` and `test_torch_train_step.py`."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro_torch import configs, convert
from repro_torch.models import lm

from test_torch_util import (FP32_TOL, jax_tree_to_numpy, random_like,
                             to_jax, to_np, to_torch)

B, S = 2, 32


@functools.lru_cache(maxsize=None)
def _weights(arch):
    jcfg = jconfigs.get_smoke_config(arch)
    shapes = jax_tree_to_numpy(jlm.init_model(jcfg, jax.random.PRNGKey(0)))
    return random_like(shapes, np.random.default_rng(0))


def _batch(cfg, b, s, seed=1):
    """Seeded numpy training inputs: tokens (with `vision_embeds` for a
    vision frontend) or audio `features`, and labels."""
    rng = np.random.default_rng(seed)
    batch = {}
    if cfg.frontend is not None and cfg.frontend.kind == "audio":
        batch["features"] = rng.standard_normal(
            (b, s, cfg.frontend.feature_dim)).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (b, s),
                                       dtype=np.int32)
    batch["labels"] = rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)
    if cfg.frontend is not None and cfg.frontend.kind == "vision":
        batch["vision_embeds"] = rng.standard_normal(
            (b, cfg.frontend.prefix_len, cfg.frontend.feature_dim)
        ).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def _reference(arch, dtype, s=S):
    """(loss, aux, grads in flatten order) of the reference, numpy; one
    jit of its loss-and-grad per (arch, dtype)."""
    jcfg = jconfigs.get_smoke_config(arch)
    fn = jax.jit(jax.value_and_grad(functools.partial(
        jlm.train_loss, jcfg, dtype=getattr(jnp, dtype)), has_aux=True))
    (loss, metrics), grads = fn(to_jax(_weights(arch)),
                                to_jax(_batch(jcfg, B, s)))
    return (float(loss), float(metrics["aux_loss"]),
            [to_np(g) for g in jax.tree.leaves(grads)])


def _port(arch, dtype, remat="selective", s=S, batch=None):
    """(loss, aux, grads in flatten order) of the port, on the CPU."""
    cfg = configs.get_smoke_config(arch)
    params = convert.params_from_numpy(_weights(arch), device="cpu")
    leaves, _ = convert.flatten(params)
    for t in leaves:
        t.requires_grad_(True)
    batch = _batch(cfg, B, s) if batch is None else batch
    loss, metrics = lm.train_loss(
        cfg, params, {k: to_torch(v) for k, v in batch.items()},
        remat=remat, dtype=getattr(torch, dtype))
    grads = torch.autograd.grad(loss, leaves)
    return (float(loss.detach()), float(metrics["aux_loss"].detach()),
            [to_np(g) for g in grads])


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_train_loss_and_grads_match_reference_fp32(arch):
    loss, aux, grads = _port(arch, "float32")
    jloss, jaux, jgrads = _reference(arch, "float32")
    np.testing.assert_allclose(loss, jloss, **FP32_TOL)
    np.testing.assert_allclose(aux, jaux, **FP32_TOL)
    assert len(grads) == len(jgrads)
    for i, (g, jg) in enumerate(zip(grads, jgrads)):
        assert g.shape == jg.shape
        np.testing.assert_allclose(g, jg, err_msg=f"leaf {i}", **FP32_TOL)
