"""`repro_torch.models.rglru` against `repro.models.rglru` on the same seeded
numpy inputs and weights: the gates (with the recurrence's Lambda in fp32,
as a tail leaf keeps it, and in bf16, as `cast_params_for_compute` makes the
stacked one), the causal conv, the associative scan (also against a loop of
the port's own decode step) and the block with and without a state. fp32 at
atol 1e-5 / rtol 1e-4; a case with a bf16 operand at 3e-2, as the
reference's own bf16 tests are held."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.models import rglru as jrglru
from repro_torch import configs, convert
from repro_torch.models import lm, rglru

from test_torch_util import (BF16_TOL, jax_tree_to_numpy, random_like,
                             to_jax, to_np, to_torch)

ARCH = "recurrentgemma-9b"
TOL = dict(atol=1e-5, rtol=1e-4)


def _setup(seed=0):
    cfg, jcfg = configs.get_smoke_config(ARCH), jconfigs.get_smoke_config(ARCH)
    shapes = jax_tree_to_numpy(jrglru.init_rglru(jcfg, jax.random.PRNGKey(0)))
    weights = random_like(shapes, np.random.default_rng(seed))
    return cfg, jcfg, weights


def _both(weights, dtype=None, lam_dtype=None):
    """The weights on both sides: matrices in `dtype`, Lambda in
    `lam_dtype` (each fp32 if None)."""
    def cast(name, a):
        want = lam_dtype if name == "lambda" else dtype
        return a if want is None else np.asarray(jnp.asarray(a, want))
    w = {k: cast(k, v) for k, v in weights.items()}
    return convert.params_from_numpy(w, device="cpu"), to_jax(w)


def _x(rng, shape, dtype=None):
    x = rng.standard_normal(shape).astype(np.float32)
    return x if dtype is None else np.asarray(jnp.asarray(x, dtype))


def test_init_rglru_matches_reference_layout():
    cfg, jcfg, _ = _setup()
    got = rglru.init_rglru(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    want = jrglru.init_rglru(jcfg, jax.random.PRNGKey(0))
    assert sorted(got) == sorted(want)
    for name in want:
        assert tuple(got[name].shape) == want[name].shape
        assert str(got[name].dtype).split(".")[-1] == want[name].dtype.name
    a = torch.sigmoid(got["lambda"])
    assert float(a.min()) >= 0.9 - 1e-6 and float(a.max()) <= 0.999 + 1e-6
    state = rglru.init_rglru_state(cfg, 3, device="cpu")
    jstate = jrglru.init_rglru_state(jcfg, 3)
    for name in jstate:
        assert tuple(state[name].shape) == jstate[name].shape
        assert state[name].dtype == torch.float32 and not state[name].any()


@pytest.mark.parametrize("dtype,lam_dtype", [
    (None, None), (None, jnp.bfloat16), (jnp.bfloat16, jnp.bfloat16),
    (jnp.bfloat16, None)])
def test_gates_match_reference(dtype, lam_dtype):
    """softplus(-Lambda) runs in Lambda's own type on both sides: fp32 for a
    tail leaf, bf16 for a stacked one in bf16 compute."""
    cfg, jcfg, weights = _setup()
    p, jp = _both(weights, dtype, lam_dtype)
    x = _x(np.random.default_rng(1), (2, 7, cfg.rnn_width), dtype)
    a, gated = rglru._gates(p, to_torch(x))
    ja, jgated = jrglru._gates(jp, jnp.asarray(x))
    assert a.dtype == gated.dtype == torch.float32
    tol = TOL if dtype is None and lam_dtype is None else BF16_TOL
    np.testing.assert_allclose(to_np(a), to_np(ja), **tol)
    np.testing.assert_allclose(to_np(gated), to_np(jgated), **tol)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", [None, jnp.bfloat16])
def test_causal_conv_matches_reference(with_state, dtype):
    """The four taps summed from the first, in the input's type; the new
    state is the last three inputs."""
    cfg, jcfg, weights = _setup()
    p, jp = _both(weights, dtype)
    rng = np.random.default_rng(2)
    x = _x(rng, (2, 6, cfg.rnn_width), dtype)
    st = _x(rng, (2, 3, cfg.rnn_width), dtype) if with_state else None
    out, new = rglru._causal_conv(p, to_torch(x),
                                  None if st is None else to_torch(st))
    jout, jnew = jrglru._causal_conv(jp, jnp.asarray(x),
                                     None if st is None else jnp.asarray(st))
    assert out.dtype == to_torch(x).dtype
    tol = TOL if dtype is None else BF16_TOL
    np.testing.assert_allclose(to_np(out), to_np(jout), **tol)
    np.testing.assert_array_equal(to_np(new), to_np(jnew))


@pytest.mark.parametrize("S", [1, 37, 128, 131])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_matches_reference_and_step_loop(S, with_h0):
    cfg, jcfg, weights = _setup()
    p, jp = _both(weights)
    rng = np.random.default_rng(3)
    x = _x(rng, (2, S, cfg.rnn_width))
    h0 = _x(rng, (2, cfg.rnn_width)) if with_h0 else None
    h, last = rglru.rglru_scan(p, to_torch(x),
                               None if h0 is None else to_torch(h0))
    jh, jlast = jrglru.rglru_scan(jp, jnp.asarray(x),
                                  None if h0 is None else jnp.asarray(h0))
    assert h.shape == (2, S, cfg.rnn_width) and h.dtype == torch.float32
    np.testing.assert_allclose(to_np(h), to_np(jh), **TOL)
    np.testing.assert_allclose(to_np(last), to_np(jlast), **TOL)
    # the same recurrence one token at a time
    hp = torch.zeros(2, cfg.rnn_width) if h0 is None else to_torch(h0)
    loop = []
    for t in range(S):
        hp, _ = rglru.rglru_step(p, to_torch(x)[:, t], hp)
        loop.append(hp)
    np.testing.assert_allclose(to_np(h), to_np(torch.stack(loop, 1)), **TOL)


@pytest.mark.parametrize("mode", ["stateless", "prefill", "decode"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rglru_matches_reference(mode, dtype):
    """The block without a state (no state out), a stateful prefill from a
    nonzero state, and an S == 1 decode step; the new state leaf by leaf."""
    cfg, jcfg, weights = _setup()
    jdt = getattr(jnp, dtype)
    p, jp = _both(weights, None if dtype == "float32" else jdt)
    rng = np.random.default_rng(4)
    S = 1 if mode == "decode" else 19
    x = _x(rng, (2, S, cfg.d_model), None if dtype == "float32" else jdt)
    state = None
    if mode != "stateless":
        state = {"h": _x(rng, (2, cfg.rnn_width)),
                 "conv": _x(rng, (2, 3, cfg.rnn_width))}
    out, new = rglru.apply_rglru(
        cfg, p, to_torch(x),
        None if state is None else {k: to_torch(v) for k, v in state.items()})
    jout, jnew = jrglru.apply_rglru(jcfg, jp, jnp.asarray(x),
                                    None if state is None else to_jax(state))
    tol = TOL if dtype == "float32" else BF16_TOL
    assert out.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(to_np(out), to_np(jout), **tol)
    if state is None:
        assert new is None and jnew is None
        return
    assert sorted(new) == sorted(jnew)
    for name in jnew:
        assert new[name].dtype == torch.float32
        np.testing.assert_allclose(to_np(new[name]), to_np(jnew[name]),
                                   **tol)


def test_cast_params_for_compute_makes_the_stacked_lambda_bf16():
    """recurrentgemma at five layers (one period and a two-layer RG-LRU
    tail): the stacked Lambda [P, w] becomes bf16 in compute, the tail's
    [w] stays fp32, on both sides alike."""
    import dataclasses
    cfg = dataclasses.replace(configs.get_smoke_config(ARCH), num_layers=5)
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH), num_layers=5)
    params = lm.cast_params_for_compute(lm.init_model(cfg, device="cpu"))
    jparams = jlm.cast_params_for_compute(jlm.init_model(
        jcfg, jax.random.PRNGKey(0)))
    assert params["scan"][0]["mix"]["lambda"].dtype == torch.bfloat16
    assert params["tail"][0]["mix"]["lambda"].dtype == torch.float32
    assert jparams["scan"][0]["mix"]["lambda"].dtype == jnp.bfloat16
    assert jparams["tail"][0]["mix"]["lambda"].dtype == jnp.float32
