"""The training path around `train_loss`: the remat modes, the chunked
cross-entropy's ignored tail, the forward-only flash path and its refusal
under autograd, and whole `make_train_step` steps against the reference's,
with and without gradient accumulation."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.runtime import steps as jsteps
from repro_torch import configs, convert
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.runtime import steps

from test_torch_train import B, S, _batch, _port, _reference, _weights
from test_torch_util import (BF16_TOL, FP32_TOL, assert_steps_close, to_jax,
                             to_np, to_torch)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "granite-moe-1b-a400m",
                                  "recurrentgemma-9b", "rwkv6-7b"])
def test_remat_modes_give_the_same_loss_and_grads(arch):
    """Recomputing in the backward changes no value: the same operations
    run on the same inputs."""
    base = _port(arch, "float32", remat="none")
    for remat in ("full", "selective"):
        loss, aux, grads = _port(arch, "float32", remat=remat)
        assert loss == base[0] and aux == base[1], remat
        for g, want in zip(grads, base[2]):
            np.testing.assert_array_equal(g, want, err_msg=remat)


def test_unknown_remat_mode_raises():
    with pytest.raises(ValueError, match="remat"):
        _port("qwen2.5-3b", "float32", remat="partial")


def test_chunked_xent_ignores_the_tail_past_whole_chunks():
    """Reproduced on purpose: at S = 600 the loss covers the first 512
    positions (one chunk of 512) and ignores the last 88 labels, in both
    packages."""
    arch, s = "qwen2.5-3b", 600
    loss, _, grads = _port(arch, "float32", s=s)
    jloss, _, jgrads = _reference(arch, "float32", s=s)
    np.testing.assert_allclose(loss, jloss, **FP32_TOL)
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g, jg, **FP32_TOL)
    cfg, jcfg = configs.get_smoke_config(arch), jconfigs.get_smoke_config(arch)
    other = _batch(cfg, B, s)
    other["labels"][:, 512:] = (other["labels"][:, 512:] + 1) % cfg.vocab_size
    assert _port(arch, "float32", s=s, batch=other)[0] == loss
    jother, _ = jlm.train_loss(jcfg, to_jax(_weights(arch)), to_jax(other),
                               dtype=jnp.float32)
    np.testing.assert_allclose(float(jother), jloss, rtol=1e-6)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "granite-moe-1b-a400m"])
def test_train_loss_with_kernels_forward_matches_reference(arch):
    """The forward-only loss through the flash path (S = 128, where the
    model takes it) equals the reference's through its Pallas kernel."""
    cfg = configs.get_smoke_config(arch)
    params = convert.params_from_numpy(_weights(arch), device="cpu")
    batch = _batch(cfg, B, 128)
    with torch.no_grad():
        loss, _ = lm.train_loss(cfg, params,
                                {k: to_torch(v) for k, v in batch.items()},
                                use_kernels=True, dtype=torch.float32)
    jcfg = jconfigs.get_smoke_config(arch)
    jloss, _ = jax.jit(functools.partial(
        jlm.train_loss, jcfg, use_kernels=True, dtype=jnp.float32))(
            to_jax(_weights(arch)), to_jax(batch))
    np.testing.assert_allclose(float(loss), float(jloss), **FP32_TOL)


def test_flash_has_no_backward_in_either_package():
    """The reference cannot differentiate its flash kernel (its Pallas
    call fails under jax.grad); the port's wrapper refuses autograd on every
    device, the CPU's plain version included, so the CPU cannot hide what
    the card refuses."""
    arch = "qwen2.5-3b"
    cfg, jcfg = configs.get_smoke_config(arch), jconfigs.get_smoke_config(arch)
    batch = _batch(cfg, B, 128)
    params = convert.params_from_numpy(_weights(arch), device="cpu")
    leaves, _ = convert.flatten(params)
    for t in leaves:
        t.requires_grad_(True)
    inputs = {k: to_torch(v) for k, v in batch.items()}
    with pytest.raises(NotImplementedError, match="no backward"):
        loss, _ = lm.train_loss(cfg, params, inputs, use_kernels=True,
                                dtype=torch.float32)
        torch.autograd.grad(loss, leaves)
    with pytest.raises(AssertionError):
        jax.grad(lambda p: jlm.train_loss(
            jcfg, p, to_jax(batch), use_kernels=True,
            dtype=jnp.float32)[0])(to_jax(_weights(arch)))
    # the wrapper itself: refused with grad, run without
    q = torch.randn(1, 2, 128, 16, requires_grad=True)
    k = torch.randn(1, 2, 128, 16)
    with pytest.raises(NotImplementedError, match="no backward"):
        fa.flash_attention(q, k, k)
    with torch.no_grad():
        assert fa.flash_attention(q, k, k).shape == q.shape
    assert fa.flash_attention(q.detach(), k, k).shape == q.shape


def _fp32_compute(monkeypatch):
    """The reference's train step with fp32 compute (its `train_loss`
    defaults to bf16, and its step takes no type): the comparison with the
    port's `dtype=float32` step is then of the algorithm."""
    monkeypatch.setattr(jlm, "train_loss", functools.partial(
        jlm.train_loss, dtype=jnp.float32))


@pytest.mark.parametrize("arch,microbatches", [
    ("qwen2.5-3b", 1), ("qwen2.5-3b", 2), ("granite-moe-1b-a400m", 2)])
def test_train_step_matches_reference(monkeypatch, arch, microbatches):
    """Three `make_train_step` steps from the same weights and batches.
    The first Adam step moves a weight by lr * sign(g) where |g| is near
    its own rounding error, and two right implementations may step
    opposite ways there: params are held by `assert_steps_close` (none
    beyond 2 * sum(lr), few beyond a quarter of it); loss, grad norm, lr
    and the moments at fp32 tolerances."""
    _fp32_compute(monkeypatch)
    cfg, jcfg = configs.get_smoke_config(arch), jconfigs.get_smoke_config(arch)
    par = configs.ParallelConfig(remat="full", microbatches=microbatches)
    jpar = jconfigs.ParallelConfig(remat="full", microbatches=microbatches)
    step_fn = steps.make_train_step(cfg, par, adamw.AdamWConfig(
        total_steps=3), dtype=torch.float32)
    jstep_fn = jax.jit(jsteps.make_train_step(jcfg, jpar, jadamw.AdamWConfig(
        total_steps=3)))
    params = convert.params_from_numpy(_weights(arch), device="cpu")
    opt = adamw.init_state(params)
    jparams = to_jax(_weights(arch))
    jopt = jadamw.init_state(jparams)
    lr_sum = 0.0
    for i in range(3):
        batch = _batch(cfg, 2 * microbatches, S, seed=10 + i)
        params, opt, m = step_fn(params, opt, {k: to_torch(v)
                                               for k, v in batch.items()})
        jparams, jopt, jm = jstep_fn(jparams, jopt, to_jax(batch))
        assert set(m) == set(jm)
        for key in m:
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       err_msg=f"step {i} {key}", **FP32_TOL)
        lr_sum += float(jm["lr"])
    assert int(opt["step"]) == int(jopt["step"]) == 3
    for name in ("m", "v"):
        for a, b in zip(convert.flatten(opt[name])[0],
                        jax.tree.leaves(jopt[name])):
            b = to_np(b)
            np.testing.assert_allclose(to_np(a), b, rtol=1e-3,
                                       atol=1e-4 * np.abs(b).max(),
                                       err_msg=name)
    assert_steps_close(convert.flatten(params)[0], jax.tree.leaves(jparams),
                       lr_sum, arch)


def test_train_step_bf16_compute_matches_reference():
    """The default (bf16 compute) train step, two steps: loss and grad
    norm at BF16_TOL, params by `assert_steps_close`."""
    arch = "qwen2.5-3b"
    cfg, jcfg = configs.get_smoke_config(arch), jconfigs.get_smoke_config(arch)
    step_fn = steps.make_train_step(cfg, configs.ParallelConfig(),
                                    adamw.AdamWConfig())
    jstep_fn = jax.jit(jsteps.make_train_step(
        jcfg, jconfigs.ParallelConfig(), jadamw.AdamWConfig()))
    params = convert.params_from_numpy(_weights(arch), device="cpu")
    opt = adamw.init_state(params)
    jparams = to_jax(_weights(arch))
    jopt = jadamw.init_state(jparams)
    lr_sum = 0.0
    for i in range(2):
        batch = _batch(cfg, B, S, seed=20 + i)
        params, opt, m = step_fn(params, opt, {k: to_torch(v)
                                               for k, v in batch.items()})
        jparams, jopt, jm = jstep_fn(jparams, jopt, to_jax(batch))
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       **BF16_TOL)
        lr_sum += float(jm["lr"])
    assert_steps_close(convert.flatten(params)[0], jax.tree.leaves(jparams),
                       lr_sum, arch)


def test_train_step_wants_fp32_masters():
    """Masters need not be float32: bf16 masters (the reference's weights
    above 100 B parameters) take their gradients in bf16, summed over
    microbatches in float32, as the reference's step takes them. Two steps
    with 1 and with 2 microbatches: loss, grad norm and lr at BF16_TOL, the
    float32 moments (which hold the gradients) within 3e-2 of their
    largest, the params still bf16."""
    arch = "qwen2.5-3b"
    cfg, jcfg = configs.get_smoke_config(arch), jconfigs.get_smoke_config(arch)
    for microbatches in (1, 2):
        step_fn = steps.make_train_step(cfg, configs.ParallelConfig(
            microbatches=microbatches), adamw.AdamWConfig())
        jstep_fn = jax.jit(jsteps.make_train_step(jcfg, jconfigs.ParallelConfig(
            microbatches=microbatches), jadamw.AdamWConfig()))
        params = convert.tree_map(lambda t: t.bfloat16(),
                                  convert.params_from_numpy(_weights(arch),
                                                            device="cpu"))
        opt = adamw.init_state(params)
        jparams = jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                               to_jax(_weights(arch)))
        jopt = jadamw.init_state(jparams)
        for i in range(2):
            batch = _batch(cfg, 2 * microbatches, S, seed=30 + i)
            params, opt, m = step_fn(params, opt, {
                k: to_torch(v) for k, v in batch.items()})
            jparams, jopt, jm = jstep_fn(jparams, jopt, to_jax(batch))
            for key in ("loss", "grad_norm", "lr"):
                np.testing.assert_allclose(
                    float(m[key]), float(jm[key]),
                    err_msg=f"{microbatches} microbatches, step {i} {key}",
                    **BF16_TOL)
        for name in ("m", "v"):
            for a, b in zip(convert.flatten(opt[name])[0],
                            jax.tree.leaves(jopt[name])):
                assert a.dtype == torch.float32
                b = to_np(b)
                np.testing.assert_allclose(to_np(a), b, rtol=3e-2,
                                           atol=3e-2 * np.abs(b).max(),
                                           err_msg=name)
        assert all(t.dtype == torch.bfloat16
                   for t in convert.flatten(params)[0])
